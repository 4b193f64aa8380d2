"""The reference network of a ``pdunet`` model: the Primal-Dual UNet unroll."""

from portbench.reference.model import pdunet, unet_shapes


def shapes(cfg: dict) -> dict:
    """The parameter shapes of the configuration ``cfg``'s network, keyed as
    the program's ``state_dict``: a dual and a primal UNet per iteration,
    on (Re, Im) channel pairs for radial MRI."""
    m = cfg["model"]
    step = 2 if cfg["geometry"]["kind"] == "radial" else 1
    out = {}
    for i in range(m["n_iters"]):
        for part, cin in (("dual", 3 * step), ("primal", 2 * step)):
            out.update(unet_shapes(f"iterations.{i}.{part}.", cin, step, m["base_features"],
                                   m["depth"], m["stem"]))
    return out


def unroll(m: dict, P: dict, g, f0, A, At, complex_ops: bool, rnd):
    """The unroll of the model section ``m`` with the weights ``P`` on the
    scaled measurement ``g`` from ``f0``; ``A``, ``At`` already scaled."""
    return pdunet(g, f0, P, A, At, m["n_iters"], m["depth"], m["stem"], complex_ops, rnd)
