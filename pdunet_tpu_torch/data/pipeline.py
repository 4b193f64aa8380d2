"""Sinogram angular subsampling and re-expansion (port of the angle half of
``pdunet_tpu/data/pipeline.py``).

``subsample_angles`` keeps every k-th angle of a dense sinogram;
``interp_upsample_angles`` re-expands the sparse one linearly to the dense
angle grid, the network input of the sinogram-upsampling task. Both are
plain tensor functions on any device. The noise models of the JAX module
come with the slices that need them (low-dose Poisson with fan beam,
k-space noise with the radial sinogram task).
"""

from __future__ import annotations

import torch

__all__ = ["subsample_angles", "interp_upsample_angles"]


def subsample_angles(sino: torch.Tensor, factor: int) -> torch.Tensor:
    """Keep every ``factor``-th angle: (..., A, S) → (..., A//factor, S)."""
    return sino[..., ::factor, :]


def interp_upsample_angles(sparse: torch.Tensor, factor: int,
                           angular_coverage: float = 1.0) -> torch.Tensor:
    """Linear re-expansion of a sparse sinogram to the dense angle grid.

    Dense angle ``i`` sits at fractional sparse index ``i / factor`` and is
    interpolated between its two measured neighbours. For a full scan
    (``angular_coverage >= 1``) the last segment wraps to angle 0 with the
    detector axis flipped, p(θ+π, s) = p(θ, −s) (parallel-beam symmetry);
    for a limited-angle scan it clamps to the last measured angle instead.
    (..., A_sp, S) → (..., A_sp·factor, S)."""
    A_sp = sparse.shape[-2]
    dev = sparse.device
    pos = torch.arange(A_sp * factor, device=dev, dtype=torch.float32) / factor
    lo = torch.floor(pos).to(torch.int64)
    w = (pos - lo)[:, None]
    hi = lo + 1
    past_end = hi >= A_sp
    hi_c = torch.where(past_end, 0 if angular_coverage >= 1.0 else A_sp - 1, hi)
    lo_v = sparse.index_select(-2, lo)
    hi_v = sparse.index_select(-2, hi_c)
    if angular_coverage >= 1.0:
        hi_v = torch.where(past_end[:, None], hi_v.flip(-1), hi_v)
    return (1.0 - w) * lo_v + w * hi_v
