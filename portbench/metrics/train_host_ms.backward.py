"""Median host ms of the span ``train.backward`` (``loss.backward()``), in a
run that records the program's spans (``portbench/spans.py``)."""

from portbench import spans


def read(run):
    return spans.median_ms(spans.window_spans(run, "train.backward"), "host_start", "host_end")
