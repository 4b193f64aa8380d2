"""Median device ms of the span ``recon`` (the request's unroll,
``recon_fn``) per request, in a run that records the program's spans
(``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_ms(spans.window_spans(run, "recon"), "device_start", "device_end")
