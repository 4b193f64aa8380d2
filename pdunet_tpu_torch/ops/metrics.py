"""Image quality metrics (port of ``pdunet_tpu/ops/metrics.py``).

PSNR uses the target's peak-to-peak range by default; SSIM follows Wang et
al. 2004 with the 11×11 σ=1.5 Gaussian window and clamps the moments to
their true bounds. Both reduce over the trailing two axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pdunet_tpu_torch.utils.precision import exact_f32_conv

__all__ = ["mse", "rmse", "psnr", "ssim"]


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - target) ** 2, dim=(-2, -1))


def rmse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(mse(pred, target))


def _peak_to_peak(t: torch.Tensor) -> torch.Tensor:
    return torch.amax(t, dim=(-2, -1)) - torch.amin(t, dim=(-2, -1))


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range=None) -> torch.Tensor:
    """PSNR in dB over the trailing two axes; leading axes broadcast."""
    if data_range is None:
        data_range = _peak_to_peak(target)
    return 20.0 * torch.log10(torch.as_tensor(data_range)) - 10.0 * torch.log10(
        mse(pred, target))


def _gaussian_window(size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    g = g / g.sum()
    return torch.outer(g, g)


def _filter2d(x: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Valid-mode 2D correlation of (B, H, W) with (k, k), exact float32
    (TF32 would corrupt SSIM's moment maps)."""
    with exact_f32_conv():
        return F.conv2d(x[:, None], win[None, None])[:, 0]


def ssim(pred: torch.Tensor, target: torch.Tensor, data_range=None,
         window_size: int = 11, sigma: float = 1.5, k1: float = 0.01,
         k2: float = 0.03) -> torch.Tensor:
    """Mean SSIM over the trailing two axes; leading axes are batch."""
    batch_shape = pred.shape[:-2]
    p = pred.reshape((-1,) + tuple(pred.shape[-2:])).float()
    t = target.reshape((-1,) + tuple(target.shape[-2:])).float()
    if data_range is None:
        dr = _peak_to_peak(t)
    else:
        dr = torch.full((p.shape[0],), float(data_range), device=p.device)
    c1 = ((k1 * dr) ** 2)[:, None, None]
    c2 = ((k2 * dr) ** 2)[:, None, None]

    win = _gaussian_window(window_size, sigma, p.device)
    mu_p = _filter2d(p, win)
    mu_t = _filter2d(t, win)
    mu_pp = _filter2d(p * p, win)
    mu_tt = _filter2d(t * t, win)
    mu_pt = _filter2d(p * t, win)

    # E[x²]−μ² can cancel below zero in f32; true moments satisfy var ≥ 0
    # and |cov| ≤ √(var_p·var_t), so clamping is exact for healthy inputs.
    var_p = torch.clamp(mu_pp - mu_p**2, min=0.0)
    var_t = torch.clamp(mu_tt - mu_t**2, min=0.0)
    cov_cap = torch.sqrt(var_p * var_t)
    cov = torch.maximum(torch.minimum(mu_pt - mu_p * mu_t, cov_cap), -cov_cap)

    s = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2))
    return s.mean(dim=(-2, -1)).reshape(batch_shape)
