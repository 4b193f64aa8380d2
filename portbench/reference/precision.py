"""Operand rounding of the reference and of its control.

The configuration states two precisions: float32 for the measurement
synthesis and the direct reconstruction, bfloat16 for the unrolled network
and its operators. The reference computes both in float32 (``EXACT``). The
control computes each in the nearest precision below the stated one
(``CONTROL``): TF32 operands (10 explicit mantissa bits) where float32 is
stated, and fp8 operands with a per-tensor scale where bfloat16 is stated,
e4m3 forward and e5m2 for the gradients flowing back, as fp8 training
runs. Operands are rounded where a matrix product or a convolution reads
them; sums stay float32, as on the tensor cores.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

__all__ = ["Precision", "EXACT", "CONTROL", "round_tf32", "round_fp8", "round_fp8_grad",
           "exact_float32"]

def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 mantissa bits, nearest even)."""
    if x.is_complex():
        return torch.complex(round_tf32(x.real), round_tf32(x.imag))
    i = x.float().contiguous().view(torch.int32)
    shift = 13
    lsb = (i >> shift) & 1
    i = (i + ((1 << (shift - 1)) - 1) + lsb) & ~((1 << shift) - 1)
    return i.view(torch.float32)


def round_fp8(x: torch.Tensor, fmt=torch.float8_e4m3fn) -> torch.Tensor:
    """Round to float8 ``fmt`` with one scale for the tensor (its largest
    magnitude maps to the format's largest value), back in float32."""
    top = torch.finfo(fmt).max
    if x.is_complex():
        scale = torch.maximum(x.real.abs().amax(), x.imag.abs().amax())
        scale = torch.clamp(scale, min=1e-30) / top
        return torch.complex((x.real / scale).to(fmt).float() * scale,
                             (x.imag / scale).to(fmt).float() * scale)
    scale = torch.clamp(x.abs().amax().float(), min=1e-30) / top
    return (x.float() / scale).to(fmt).float() * scale


def round_fp8_grad(x: torch.Tensor) -> torch.Tensor:
    return round_fp8(x, torch.float8_e5m2)


@dataclasses.dataclass(frozen=True)
class Precision:
    """``hi`` rounds the operands of what the configuration states in
    float32, ``lo`` those of what it states in bfloat16."""

    name: str
    hi: Callable[[torch.Tensor], torch.Tensor]
    lo: Callable[[torch.Tensor], torch.Tensor]


class _Round(torch.autograd.Function):
    """``fwd`` on the values, ``bwd`` on the gradient flowing back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _rounding(fwd, bwd):
    def rnd(x):
        return _Round.apply(x, fwd, bwd) if x.requires_grad else fwd(x)
    return rnd


EXACT = Precision("float32", _identity, _identity)
CONTROL = Precision("tf32+fp8", _rounding(round_tf32, round_tf32),
                    _rounding(round_fp8, round_fp8_grad))


class exact_float32:
    """Context: matrix products and convolutions in full float32 (TF32 off)."""

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False
