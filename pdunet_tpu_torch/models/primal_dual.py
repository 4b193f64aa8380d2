"""Unrolled Primal-Dual UNet (port of ``pdunet_tpu/models/primal_dual.py``,
per-iteration weights, real or complex operators).

Per iteration, with the operators coupled through memory channel 0:

    h ← h + DualNet([h, A f₀ᶜʰ, g])
    f ← f + PrimalNet([f, A† h₀ᶜʰ])

With ``complex_ops`` (radial MRI) every quantity is a (Re, Im) channel pair
on dim 1: the operators see the complex number made from channels 0:2, the
dual UNet takes 6 channels (h, A f, g) and the primal UNet 4 (f, A† h), both
put out 2, and the model returns a complex tensor.

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


def _to_channels(z: torch.Tensor) -> torch.Tensor:
    """(B, H, W) complex → (B, 2, H, W) float32 (Re, Im)."""
    return torch.stack([z.real, z.imag], dim=1).float()


def _to_complex(x: torch.Tensor) -> torch.Tensor:
    """Channels 0:2 of (B, C, H, W) → (B, H, W) complex."""
    return torch.complex(x[:, 0], x[:, 1])


class UnrolledPrimalDual(nn.Module):
    """Call with the measurement ``g`` (B, A, S) and the initial image
    ``f0`` (B, N, N); returns the reconstruction (B, N, N), float32 or,
    with ``complex_ops``, complex. Primal and dual memories have one
    (real or complex) channel each."""

    def __init__(self, A: Callable, At: Callable, iterations,
                 complex_ops: bool = False):
        super().__init__()
        self.A, self.At = A, At
        self.complex_ops = complex_ops
        self.iterations = nn.ModuleList(iterations)

    def forward(self, g: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        if self.complex_ops:
            pack, unpack = _to_channels, _to_complex
        else:
            pack, unpack = (lambda z: z[:, None].float()), (lambda x: x[:, 0])
        f = pack(f0)
        g_ch = pack(g)
        h = torch.zeros_like(g_ch)
        for it in self.iterations:
            Af = pack(self.A(unpack(f)))
            h = h + it.dual(torch.cat([h, Af, g_ch], dim=1))
            Ath = pack(self.At(unpack(h)))
            f = f + it.primal(torch.cat([f, Ath], dim=1))
        return unpack(f)


def make_pdunet(A: Callable, At: Callable, n_iters: int = 4,
                base_features: int = 32, depth: int = 3, stem: int = 1,
                complex_ops: bool = False, dtype=torch.float32,
                generator: torch.Generator = None,
                device="cuda") -> UnrolledPrimalDual:
    """Primal-Dual UNet with its own weights in every iteration."""
    step = 2 if complex_ops else 1
    kw = dict(out_channels=step, base_features=base_features, depth=depth,
              stem=stem, dtype=dtype, generator=generator, device=device)
    return UnrolledPrimalDual(A, At, [
        PDIteration(UNet(in_channels=3 * step, **kw), UNet(in_channels=2 * step, **kw))
        for _ in range(n_iters)
    ], complex_ops=complex_ops)
