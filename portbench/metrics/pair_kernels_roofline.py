"""Roofline share of the mirror-pair projector kernels (pair_tc_*,
pair_split_*) in the traced slice, in %."""

from portbench.roofline import family_roofline


def read(run):
    return family_roofline(run, "pair", "pair")
