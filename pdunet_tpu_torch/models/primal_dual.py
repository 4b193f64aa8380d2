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

``remat`` recomputes each iteration's body in the backward instead of
keeping its activations (``torch.utils.checkpoint``; flax's ``nn.remat``):
memory for time, with the same results. It wraps the call, not the
modules, so parameter names (``state_dict`` keys) do not depend on it.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
                 complex_ops: bool = False, remat: bool = False):
        super().__init__()
        self.A, self.At = A, At
        self.complex_ops = complex_ops
        self.remat = remat
        self.iterations = nn.ModuleList(iterations)

    def _pack(self, z: torch.Tensor) -> torch.Tensor:
        return _to_channels(z) if self.complex_ops else z[:, None].float()

    def _unpack(self, x: torch.Tensor) -> torch.Tensor:
        return _to_complex(x) if self.complex_ops else x[:, 0]

    def _iteration(self, it: PDIteration, f, h, g_ch):
        """One unroll step: the dual update, then the primal update."""
        Af = self._pack(self.A(self._unpack(f)))
        h = h + it.dual(torch.cat([h, Af, g_ch], dim=1))
        Ath = self._pack(self.At(self._unpack(h)))
        f = f + it.primal(torch.cat([f, Ath], dim=1))
        return f, h

    def forward(self, g: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        f = self._pack(f0)
        g_ch = self._pack(g)
        h = torch.zeros_like(g_ch)
        remat = self.remat and torch.is_grad_enabled()
        for it in self.iterations:
            if remat:
                # the body draws no random numbers: no RNG state to replay
                f, h = checkpoint(self._iteration, it, f, h, g_ch,
                                  use_reentrant=False, preserve_rng_state=False)
            else:
                f, h = self._iteration(it, f, h, g_ch)
        return self._unpack(f)


def make_pdunet(A: Callable, At: Callable, n_iters: int = 4,
                base_features: int = 32, depth: int = 3, stem: int = 1,
                complex_ops: bool = False, dtype=torch.float32,
                generator: torch.Generator = None,
                device="cuda", remat: bool = False) -> UnrolledPrimalDual:
    """Primal-Dual UNet with its own weights in every iteration; ``remat``
    recomputes each iteration in the backward (same results and names)."""
    step = 2 if complex_ops else 1
    kw = dict(out_channels=step, base_features=base_features, depth=depth,
              stem=stem, dtype=dtype, generator=generator, device=device)
    return UnrolledPrimalDual(A, At, [
        PDIteration(UNet(in_channels=3 * step, **kw), UNet(in_channels=2 * step, **kw))
        for _ in range(n_iters)
    ], complex_ops=complex_ops, remat=remat)
