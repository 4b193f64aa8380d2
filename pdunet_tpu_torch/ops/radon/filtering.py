"""Sinogram ramp filtering for FBP (port of ``pdunet_tpu/ops/radon/filtering.py``).

The ramp is the band-limited discrete impulse response (Kak & Slaney eq. 61),
which avoids the DC bias of a raw |f| multiplier:

    h[0] = 1/(4 δ_s²),  h[n odd] = -1/(π n δ_s)²,  h[n even] = 0.

Windows: ramp (= ram-lak), shepp-logan, cosine, hamming, hann.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["ramp_kernel", "filter_sinogram", "FILTERS"]

FILTERS = ("ramp", "ram-lak", "shepp-logan", "cosine", "hamming", "hann")


def _next_pow2(n: int) -> int:
    return 1 << max(6, (n - 1).bit_length())


@functools.lru_cache(maxsize=32)
def _filter_response(det_count: int, det_spacing: float, filter_name: str):
    """Frequency response (rfft of the padded impulse response × window) as
    a float32 numpy array, and the padded length. Cached."""
    if filter_name not in FILTERS:
        raise ValueError(f"unknown filter {filter_name!r}; choose from {FILTERS}")
    pad = _next_pow2(2 * det_count)
    n = np.concatenate([np.arange(0, pad // 2 + 1), np.arange(pad // 2 - 1, 0, -1)])
    h = np.zeros(pad, np.float64)
    h[0] = 1.0 / (4.0 * det_spacing**2)
    odd = n % 2 == 1
    h[odd] = -1.0 / (np.pi * n[odd] * det_spacing) ** 2
    H = np.fft.rfft(h).real  # even impulse response → real spectrum

    f = np.arange(pad // 2 + 1) / pad
    fh = f / 0.5
    name = "ramp" if filter_name == "ram-lak" else filter_name
    if name == "ramp":
        w = np.ones_like(fh)
    elif name == "shepp-logan":
        x = np.pi * fh / 2.0
        w = np.ones_like(fh)
        w[1:] = np.sin(x[1:]) / x[1:]
    elif name == "cosine":
        w = np.cos(np.pi * fh / 2.0)
    elif name == "hamming":
        w = 0.54 + 0.46 * np.cos(np.pi * fh)
    elif name == "hann":
        w = 0.5 * (1.0 + np.cos(np.pi * fh))
    H = (H * w).astype(np.float32)
    H.setflags(write=False)  # shared by every caller through the cache
    return H, pad


def ramp_kernel(det_count: int, det_spacing: float = 1.0, filter_name: str = "ramp"):
    """The cached frequency response as a CPU tensor, and the padded length."""
    H, pad = _filter_response(det_count, float(det_spacing), filter_name)
    return torch.tensor(H), pad


def filter_sinogram(sino: torch.Tensor, det_spacing: float = 1.0,
                    filter_name: str = "ramp") -> torch.Tensor:
    """Apply the (windowed) ramp filter along the detector axis.

    sino (..., A, S) → same shape. Linear, and its own transpose (the
    impulse response is even), so FBP built from it stays differentiable.
    """
    S = sino.shape[-1]
    H, pad = _filter_response(S, float(det_spacing), filter_name)
    Ht = torch.tensor(H, device=sino.device)
    spec = torch.fft.rfft(sino.float(), n=pad, dim=-1)
    filtered = torch.fft.irfft(spec * Ht, n=pad, dim=-1)[..., :S]
    return (filtered * det_spacing).to(sino.dtype)
