"""The benchmark's inputs: random ellipse phantoms made on the device from a
generator (real CT densities, or MRI magnitudes with a smooth random phase).

The same draws as the program's training data: uniform ellipse parameters
(intensity, semi-axes, centre, rotation), rasterised on a 2× supersampled
grid and averaged; the phase is a sum of four low-order harmonics with
coefficients uniform in [−π, π). The reference redraws a training step's
images with these functions from the step's seed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["derive_seed", "phantoms", "complex_phantoms", "generator"]


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed from ``seed`` and a stream path."""
    words = np.random.SeedSequence([seed, *path]).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


def generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def _ellipses(gen, B, n, radius, nonneg, device):
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((B, n), generator=gen, device=device)

    rho = uniform(0.1 if nonneg else -1.0, 1.0)
    a = uniform(0.08, 0.5) * radius
    b = uniform(0.08, 0.5) * radius
    r0 = uniform(0.0, 0.6) * radius
    ang = uniform(0.0, 2 * math.pi)
    phi = uniform(0.0, math.pi)
    return torch.stack([rho, a, b, r0 * torch.cos(ang), r0 * torch.sin(ang), phi], dim=-1)


def _rasterize(params, N, dp, ss=2):
    coords = (torch.arange(N * ss, dtype=torch.float32, device=params.device) + 0.5) / ss - 0.5
    xy = (coords - (N - 1) / 2.0) * dp
    X, Y = xy[None, None, None, :], xy[None, None, :, None]
    rho, a, b, x0, y0, phi = (params[..., i, None, None] for i in range(6))
    cp, sp = torch.cos(phi), torch.sin(phi)
    xr = (X - x0) * cp + (Y - y0) * sp
    yr = -(X - x0) * sp + (Y - y0) * cp
    fine = (rho * ((xr / a) ** 2 + (yr / b) ** 2 <= 1.0)).sum(dim=1)
    return fine.reshape(params.shape[0], N, ss, N, ss).mean(dim=(2, 4)).float()


def phantoms(gen, B: int, N: int, n_ellipses: int = 8, pixel_spacing: float = 1.0,
             nonneg: bool = False, device="cuda") -> torch.Tensor:
    """(B, N, N) float32 ellipse phantoms inside a disk of 0.45·N."""
    radius = 0.45 * N * pixel_spacing
    return _rasterize(_ellipses(gen, B, n_ellipses, radius, nonneg, device), N, pixel_spacing)


def complex_phantoms(gen, B: int, N: int, n_ellipses: int = 8, pixel_spacing: float = 1.0,
                     device="cuda") -> torch.Tensor:
    """(B, N, N) complex64: nonnegative magnitudes times e^{iφ}, φ a smooth
    random field."""
    mag = phantoms(gen, B, N, n_ellipses, pixel_spacing, nonneg=True, device=device)
    c = (-math.pi + 2.0 * math.pi * torch.rand((B, 4), generator=gen, device=device))[:, :, None, None]
    ax = torch.linspace(-1.0, 1.0, N, device=device)
    Y, X = torch.meshgrid(ax, ax, indexing="ij")
    phase = c[:, 0] * X + c[:, 1] * Y + c[:, 2] * X * Y + c[:, 3] * (X ** 2 - Y ** 2)
    return mag.to(torch.complex64) * torch.exp(1j * phase)
