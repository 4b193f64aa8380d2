"""Roofline share of the per-angle projector kernels (group_tc_*,
group_split_*) in the traced slice, in %."""

from portbench.roofline import family_roofline


def read(run):
    return family_roofline(run, "angle", "group")
