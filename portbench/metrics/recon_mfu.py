"""Counted FLOPs per reconstructed slice (convolutions, and every projector
apply of synthesis, direct recon and unroll) times slices per second, over
the bf16 peak, in %."""

from portbench.roofline import mfu


def read(run):
    return mfu(run, "recon")
