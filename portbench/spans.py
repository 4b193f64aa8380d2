"""The program's spans (``pdunet_tpu_torch/utils/trace.py``) as the
per-layer metrics read them, and one traced run of a cell that records them.

    python3 portbench/spans.py --workload pdunet_parallel.train --seed 7 --seconds 51

Runs ``harness.run_cell`` with ``--trace 1`` inside ``trace.recording``
and keeps the run's ``Run`` with what the readers take: ``spans`` (the
resolved spans) and ``window_ns`` (the window's start on the host's ns
clock, taken when set-up ends). Prints, as its last line, one JSON object:

- ``metrics``: each reader's value by its metric's name, where it finds
  something to read. The readers are the files ``metrics/<name>.py`` of
  :data:`METRICS`, loaded as the harness loads every metric; no
  ``BENCHMARK.json`` entry names them yet, since ``run.py`` does not
  record: in its runs they read nothing.
- ``idle_spans``: the profiled slice's idle seconds by the innermost
  program span over each gap, largest first.
- ``launches``: the kernel counters' changes over each root span of the
  window (``synthesis`` and ``recon``: a request is one of each;
  ``train.step``), the median by root name.
- ``setup_counts``: their changes summed over set-up's root spans, with
  ``kernels_built`` (nvcc builds) and ``kernels_loaded`` (libraries).
- ``setup_spans``: host and device seconds of set-up's spans by name.
- ``untraced_rate``, ``latency_ms_median`` (where the cell serves
  requests) and the run's result line (``result``).

The window's spans that the readers use are those that ran as in a
``--trace 0`` run: started inside the window, before its profiled slice.
Once the profiler has run, the host's launches stay slower for the rest
of the process, which slows a host-paced step (PERF.md §7). Set-up's
spans end before the window.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.trace import SLICE, Trace  # noqa: E402

__all__ = ["METRICS", "window_spans", "median_ms", "setup_s", "idle_spans", "launches",
           "setup_counts", "record_cell"]

#: the metrics read from the program's spans, each a ``metrics/<name>.py``
METRICS = ("request_phase_ms.synthesis", "request_phase_ms.recon", "unet_ms_per_slice.recon",
           "train_host_ms.step", "train_host_ms.backward", "train_queue_ms.step",
           "setup_phase_s.plans", "setup_phase_s.opnorm", "setup_phase_s.kernels")


def _spans(run):
    return getattr(run, "spans", None) or []


def window_spans(run, name: str) -> list:
    """The spans ``name`` that started in the window before any profiler
    ran there."""
    spans = _spans(run)
    if not spans:
        return []
    end = run.window_ns + run.elapsed * 1e9
    inside = [s for s in spans if run.window_ns <= s.host_start < end]
    first = min((s.host_start for s in inside if s.profiled), default=end)
    return [s for s in inside if s.name == name and s.host_start < first]


def median_ms(spans, start: str, end: str):
    """Median of ``end − start`` in ms over ``spans`` (``start`` and ``end``
    name fields of a span), None for none."""
    if not spans:
        return None
    return statistics.median((getattr(s, end) - getattr(s, start)) * 1e-6 for s in spans)


def setup_s(run, name: str, less: str = ""):
    """Host seconds of set-up's spans ``name``, less those of the spans
    ``less`` nested anywhere inside them (self time); None for no
    recording."""
    spans = _spans(run)
    if not spans:
        return None
    before = [s for s in spans if s.host_end <= run.window_ns]
    by_id = {s.id: s for s in before}
    ours = {s.id for s in before if s.name == name}

    def inside(s):
        p = s.parent
        while p is not None and p not in ours:
            p = by_id[p].parent if p in by_id else None
        return p is not None

    total = sum(s.host_end - s.host_start for s in before if s.id in ours)
    total -= sum(s.host_end - s.host_start for s in before if s.name == less and inside(s))
    return total * 1e-9


def idle_spans(trace: Trace) -> list:
    """[[span, seconds]] of the profiled slice's idle gaps, each put down to
    the innermost program span running at its midpoint, largest first."""
    from pdunet_tpu_torch.utils.trace import NAMES

    ours = trace._replace(host=[h for h in trace.host if h[0] in set(NAMES) | {SLICE}])
    return ours.breakdown(top=len(NAMES) + 1)["idle_gaps"]


def launches(run) -> dict:
    """{root name: {counter: median change}} over the window's root spans."""
    end = run.window_ns + run.elapsed * 1e9
    by_name = {}
    for s in _spans(run):
        if s.parent is None and run.window_ns <= s.host_start < end:
            by_name.setdefault(s.name, []).append(s.counts)
    return {name: {k: statistics.median(c.get(k, 0) for c in counts)
                   for k in sorted({k for c in counts for k in c})}
            for name, counts in by_name.items()}


def setup_counts(run) -> dict:
    """The counters' changes summed over set-up's root spans."""
    out = {}
    for s in _spans(run):
        if s.parent is None and s.host_end <= run.window_ns:
            for k, v in s.counts.items():
                out[k] = out.get(k, 0) + v
    return out


@contextlib.contextmanager
def _runs_kept(kept: list):
    """``harness.Run`` for the duration, with each run kept and its
    window's start taken on the host's ns clock."""

    class Kept(harness.Run):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self)

        def setup_end(self):
            self.window_ns = time.perf_counter_ns()
            super().setup_end()

    real, harness.Run = harness.Run, Kept
    try:
        yield
    finally:
        harness.Run = real


def record_cell(cell: str, seed: int, seconds: float, device="cuda", **overrides) -> dict:
    """One traced run of ``cell`` with the program's spans recorded; the
    ``overrides`` (``config_overrides``, ``traffic_overrides``,
    ``t_start``) shrink it for the tests."""
    from pdunet_tpu_torch.utils import trace

    kept = []
    with _runs_kept(kept), trace.recording(device) as rec:
        result = harness.run_cell(cell, seed, seconds, True, device=device, **overrides)
    run = kept[0]
    run.spans = rec.spans()
    metrics = {}
    for name in METRICS:
        value = harness.read_metric(name, run)
        if value is not None:
            metrics[name] = value
    setup = {}
    for s in run.spans:
        if s.host_end <= run.window_ns:
            host, dev = setup.get(s.name, (0.0, 0.0))
            setup[s.name] = (host + (s.host_end - s.host_start) * 1e-9,
                             dev + (s.device_end - s.device_start) * 1e-9)
    return {"metrics": metrics,
            "idle_spans": idle_spans(run.trace) if run.trace is not None else [],
            "launches": launches(run), "setup_counts": setup_counts(run),
            "setup_spans": setup, "untraced_rate": run.untraced_rate,
            "latency_ms_median": (statistics.median(run.latencies) * 1e3
                                  if run.latencies else None),
            "spans": len(run.spans), "result": result}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    out = record_cell(args.workload, args.seed, args.seconds, t_start=T_START)
    print(json.dumps(out), flush=True)
    return 0 if out["result"]["correct"] else 1


if __name__ == "__main__":
    sys.exit(main())
