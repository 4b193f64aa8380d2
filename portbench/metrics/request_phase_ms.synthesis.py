"""Median device ms of the span ``synthesis`` (the request's float32
measurement synthesis and direct recon, ``batch_from_images``) per request,
in a run that records the program's spans (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_ms(spans.window_spans(run, "synthesis"), "device_start", "device_end")
