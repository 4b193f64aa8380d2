"""Median host ms of the span ``train.step``: the host's dispatch of one
step, in a run that records the program's spans (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_ms(spans.window_spans(run, "train.step"), "host_start", "host_end")
