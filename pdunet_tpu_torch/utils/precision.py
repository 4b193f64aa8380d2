"""Float32 precision pins for cuDNN.

cuDNN runs float32 convolutions in TF32 by default
(``torch.backends.cudnn.allow_tf32`` is True: about three decimal digits),
while the JAX reference computes them in full float32.
"""

from __future__ import annotations

import contextlib

import torch

__all__ = ["exact_f32_conv"]

# what a disabled pin returns: reusable, and the cheapest context on the host
# (bf16 UNet convs enter it once per layer call)
_UNCHANGED = contextlib.nullcontext()


def exact_f32_conv(enabled: bool = True):
    """A context that runs the convolutions inside in full float32 (TF32
    off) and restores the caller's setting after; with ``enabled=False`` it
    changes nothing."""
    return _tf32_off() if enabled else _UNCHANGED


@contextlib.contextmanager
def _tf32_off():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
