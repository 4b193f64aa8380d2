"""The reference network of a ``pdunet`` model: the Primal-Dual UNet unroll."""

from portbench.reference.model import pdunet


def unroll(m: dict, P: dict, g, f0, A, At, complex_ops: bool, rnd):
    """The unroll of the model section ``m`` with the weights ``P`` on the
    scaled measurement ``g`` from ``f0``; ``A``, ``At`` already scaled."""
    return pdunet(g, f0, P, A, At, m["n_iters"], m["depth"], m["stem"], complex_ops, rnd)
