"""Unrolled Primal-Dual UNet (port of ``pdunet_tpu/models/primal_dual.py``,
real operators with per-iteration weights).

Per iteration, with the operators coupled through memory channel 0:

    h ← h + DualNet([h, A f₀ᶜʰ, g])
    f ← f + PrimalNet([f, A† h₀ᶜʰ])

The JAX package scans one ``_PDIteration`` over the unroll; here the unroll
is a Python loop over ``iterations``, each holding its own dual and primal
UNet (flax's ``UNet_0`` and ``UNet_1`` inside ``Scan_PDIteration_0``).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from pdunet_tpu_torch.models.unet import UNet

__all__ = ["PDIteration", "UnrolledPrimalDual", "make_pdunet"]


class PDIteration(nn.Module):
    def __init__(self, dual: nn.Module, primal: nn.Module):
        super().__init__()
        self.dual = dual
        self.primal = primal


class UnrolledPrimalDual(nn.Module):
    """Call with the measurement ``g`` (B, A, S) and the initial image
    ``f0`` (B, N, N); returns the reconstruction (B, N, N) float32.
    Primal and dual memories have one channel each."""

    def __init__(self, A: Callable, At: Callable, iterations):
        super().__init__()
        self.A, self.At = A, At
        self.iterations = nn.ModuleList(iterations)

    def forward(self, g: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        f = f0[:, None].float()
        g_ch = g[:, None].float()
        h = torch.zeros_like(g_ch)
        for it in self.iterations:
            Af = self.A(f[:, 0])[:, None]
            h = h + it.dual(torch.cat([h, Af, g_ch], dim=1))
            Ath = self.At(h[:, 0])[:, None]
            f = f + it.primal(torch.cat([f, Ath], dim=1))
        return f[:, 0]


def make_pdunet(A: Callable, At: Callable, n_iters: int = 4,
                base_features: int = 32, depth: int = 3, stem: int = 1,
                dtype=torch.float32, generator: torch.Generator = None,
                device="cuda") -> UnrolledPrimalDual:
    """Primal-Dual UNet with its own weights in every iteration."""
    kw = dict(out_channels=1, base_features=base_features, depth=depth,
              stem=stem, dtype=dtype, generator=generator, device=device)
    return UnrolledPrimalDual(A, At, [
        PDIteration(UNet(in_channels=3, **kw), UNet(in_channels=2, **kw))
        for _ in range(n_iters)
    ])
