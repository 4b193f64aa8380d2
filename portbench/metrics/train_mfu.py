"""Counted FLOPs per trained slice (synthesis, forward and backward) times
slices per second, over the bf16 peak, in %."""

from portbench.roofline import mfu


def read(run):
    return mfu(run, "train")
