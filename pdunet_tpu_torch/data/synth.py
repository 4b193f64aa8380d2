"""Random ellipse phantoms on the device (port of ``pdunet_tpu/data/synth.py``).

Sampling and rasterisation are separate so that a test can feed the same
ellipse parameters to both packages: ``jax.random`` and ``torch.Generator``
give different numbers from the same seed.
"""

from __future__ import annotations

import math

import torch

__all__ = ["sample_ellipse_params", "rasterize", "random_phantom_batch"]


def sample_ellipse_params(generator: torch.Generator, batch_size: int,
                          n_ellipses: int, radius: float, nonneg: bool = False,
                          device="cuda") -> torch.Tensor:
    """(batch, n_ellipses, 6) parameters [rho, a, b, x0, y0, phi], with
    intensities rho in [-1, 1], or in [0.1, 1] when ``nonneg`` (the MRI
    magnitude regime: a signed density would make |image| an ill-posed
    target, and an all-negative draw a zero image)."""
    shape = (batch_size, n_ellipses)

    def uniform(lo, hi):
        u = torch.rand(shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    rho = uniform(0.1 if nonneg else -1.0, 1.0)
    a = uniform(0.08, 0.5) * radius
    b = uniform(0.08, 0.5) * radius
    r0 = uniform(0.0, 0.6) * radius
    ang = uniform(0.0, 2 * math.pi)
    phi = uniform(0.0, math.pi)
    return torch.stack([rho, a, b, r0 * torch.cos(ang), r0 * torch.sin(ang), phi], dim=-1)


def rasterize(params: torch.Tensor, image_size: int, pixel_spacing: float = 1.0,
              supersample: int = 2) -> torch.Tensor:
    """Rasterise (batch, n_ellipses, 6) parameters to (batch, N, N) float32
    images, averaging a supersample × supersample grid per pixel."""
    N, ss = image_size, supersample
    coords = (torch.arange(N * ss, dtype=torch.float32, device=params.device) + 0.5) / ss - 0.5
    xy = (coords - (N - 1) / 2.0) * pixel_spacing
    X = xy[None, None, None, :]
    Y = xy[None, None, :, None]
    rho, a, b, x0, y0, phi = (params[..., i, None, None] for i in range(6))
    cp, sp = torch.cos(phi), torch.sin(phi)
    xr = (X - x0) * cp + (Y - y0) * sp
    yr = -(X - x0) * sp + (Y - y0) * cp
    fine = (rho * ((xr / a) ** 2 + (yr / b) ** 2 <= 1.0)).sum(dim=1)
    B = params.shape[0]
    return fine.reshape(B, N, ss, N, ss).mean(dim=(2, 4)).float()


def random_phantom_batch(generator: torch.Generator, batch_size: int, image_size: int,
                         n_ellipses: int = 8, pixel_spacing: float = 1.0,
                         supersample: int = 2, nonneg: bool = False,
                         device="cuda") -> torch.Tensor:
    """Batch of random ellipse phantoms (B, N, N) made on ``device``."""
    radius = 0.45 * image_size * pixel_spacing
    params = sample_ellipse_params(generator, batch_size, n_ellipses, radius,
                                   nonneg=nonneg, device=device)
    return rasterize(params, image_size, pixel_spacing, supersample)
