"""Median of (device start − host start) of the span ``train.step``: how
long the step's first work waits behind the previous step's in the stream
(near 0: the device waits for the host), in a run that records the
program's spans (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_ms(spans.window_spans(run, "train.step"), "host_start", "device_start")
