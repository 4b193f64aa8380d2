"""The reference network of an ``lpd`` model: the Learned Primal-Dual unroll
(Adler & Öktem, arXiv:1707.06474).

Per iteration, with the operators coupled through memory channel 0:

    h ← h + Γ_i([h, A f₀ᶜʰ, g]);   f ← f + Λ_i([f, A† h₀ᶜʰ])

from f = f₀ tiled over ``primal_channels`` and h = 0 over
``dual_channels``. Γ_i and Λ_i are each a 3×3 convolution to
``lpd_features``, PReLU, a 3×3 convolution to ``lpd_features``, PReLU, and
a linear 3×3 convolution to the memory's channels. PReLU has one scalar
slope a: where(x ≥ 0, x, a·x). Real operators only: no configuration runs
LPD on complex data.

Keys, as the program's ``state_dict``: ``iterations.{i}.{dual,primal}.
convs.{0,1,2}.{weight,bias}`` and the 0-D ``iterations.{i}.{dual,primal}.
acts.{0,1}.negative_slope``.

Departures from the paper: each iteration has its own weights; no step
length is learned (the operators come scaled by their norm σ instead);
f₀ is the direct reconstruction (FBP), not zero.
"""

from __future__ import annotations

import torch

from portbench.reference.model import _conv

__all__ = ["shapes", "unroll", "prelu"]


def shapes(cfg: dict) -> dict:
    """The parameter shapes of the configuration ``cfg``'s network: a dual
    and a primal ConvNet per iteration."""
    m = cfg["model"]
    feats = m["lpd_features"]
    out = {}
    for i in range(m["n_iters"]):
        for part, cin, cout in (("dual", m["dual_channels"] + 2, m["dual_channels"]),
                                ("primal", m["primal_channels"] + 1, m["primal_channels"])):
            widths = (cin, feats, feats, cout)
            pre = f"iterations.{i}.{part}."
            for n, (a, b) in enumerate(zip(widths, widths[1:])):
                out[f"{pre}convs.{n}.weight"] = (b, a, 3, 3)
                out[f"{pre}convs.{n}.bias"] = (b,)
            for n in range(2):
                out[f"{pre}acts.{n}.negative_slope"] = ()
    return out


def prelu(x, a):
    return torch.where(x >= 0, x, a * x)


def _convnet(x, P: dict, prefix: str, rnd):
    for n in range(2):
        x = prelu(_conv(x, P, f"{prefix}convs.{n}", rnd), P[f"{prefix}acts.{n}.negative_slope"])
    return _conv(x, P, f"{prefix}convs.2", rnd)


def unroll(m: dict, P: dict, g, f0, A, At, complex_ops: bool, rnd):
    """The unroll of the model section ``m`` with the weights ``P`` on the
    scaled measurement ``g`` (B, A, S) from ``f0`` (B, N, N); ``A``, ``At``
    already scaled. Returns (B, N, N)."""
    if complex_ops:
        raise NotImplementedError("the LPD reference runs real operators only")
    g_ch = g[:, None].float()
    f = f0[:, None].float().repeat(1, m["primal_channels"], 1, 1)
    h = g_ch.new_zeros((g_ch.shape[0], m["dual_channels"]) + g_ch.shape[2:])
    for i in range(m["n_iters"]):
        pre = f"iterations.{i}."
        h = h + _convnet(torch.cat([h, A(f[:, 0])[:, None], g_ch], dim=1), P, pre + "dual.", rnd)
        f = f + _convnet(torch.cat([f, At(h[:, 0])[:, None]], dim=1), P, pre + "primal.", rnd)
    return f[:, 0]
