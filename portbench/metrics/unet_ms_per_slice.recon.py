"""Device ms of every ``pd.dual`` and ``pd.primal`` span (each unroll
step's UNet with its concatenated input and residual add) under a
request's ``recon``, over those requests' slices, in a run that records
the program's spans (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    recons = {s.id for s in spans.window_spans(run, "recon")}
    nets = [s for n in ("pd.dual", "pd.primal") for s in spans.window_spans(run, n)
            if s.parent in recons]
    if not nets:
        return None
    slices = len({s.parent for s in nets}) * run.traffic["batch"]
    return sum(s.device_end - s.device_start for s in nets) * 1e-6 / slices
