"""Radial density compensation, host-side numpy (a copy of the numpy-only
part of ``pdunet_tpu/ops/nufft/nufft.py``, kept so the port imports nothing
from the JAX package; the two must give the same weights).

``radial_dcf`` is the analytic Voronoi-ramp area element; Pipe-Menon
(``radial_dcf_pipe_menon``) refines it to the fixed point of
w ← w / |A(A†(w))| through a Kaiser-Bessel gridding NUFFT written in numpy
(float64), then pins its scale with a unit-gain calibration so that
``At(k·dcf)/(2π)²`` reconstructs in image units. Everything runs once per
geometry at plan build and is memoised (geometries are frozen dataclasses).
"""

from __future__ import annotations

import functools
import math

import numpy as np

from pdunet_tpu_torch.geometry import RadialGeometry

__all__ = ["spoke_voronoi_dphi", "radial_dcf", "radial_dcf_pipe_menon", "resolve_dcf"]


def _kb_kernel(t: np.ndarray, J: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel kernel on offsets t (grid units), support |t| ≤ J/2."""
    mask = np.abs(t) <= J / 2.0
    arg = np.sqrt(np.maximum(1.0 - (2.0 * t / J) ** 2, 0.0))
    return np.where(mask, np.i0(beta * arg), 0.0)


def _kb_apodization(N: int, G: int, J: int, beta: float) -> np.ndarray:
    """Image-domain correction: continuous FT of the KB kernel, sampled at
    the N image positions (numerical quadrature)."""
    t = np.linspace(-J / 2.0, J / 2.0, 4096)
    c = _kb_kernel(t, J, beta)
    x = np.arange(N) - N // 2  # image pixel offsets from the centre
    phase = np.exp(2j * math.pi * np.outer(x, t) / G)
    return (phase @ c).real * (t[1] - t[0])


def spoke_voronoi_dphi(spoke_angles) -> np.ndarray:
    """Per-spoke Voronoi cell width in orientation space [0, π): half the
    gap to the angular neighbour on either side (orientations folded mod π,
    exact because a diameter spoke at φ+π samples the line of φ)."""
    phis = np.asarray(spoke_angles, dtype=np.float64) % math.pi
    order = np.argsort(phis)
    s = phis[order]
    ext = np.concatenate([[s[-1] - math.pi], s, [s[0] + math.pi]])
    dphi_sorted = (ext[2:] - ext[:-2]) / 2.0
    dphi = np.empty_like(dphi_sorted)
    dphi[order] = dphi_sorted
    return dphi


def radial_dcf(geom: RadialGeometry) -> np.ndarray:
    """Radial area-element density compensation Δr·Δφ_k·|r|, with the r ≈ 0
    cell given the disk area π(Δr/2)²·(Δφ_k/π) shared across spokes."""
    n_ro = geom.samples_per_spoke
    k_max = math.pi / geom.pixel_spacing
    r = (np.arange(n_ro) - n_ro / 2.0) * (2.0 * k_max / n_ro)
    dr = 2.0 * k_max / n_ro
    dphi = spoke_voronoi_dphi(geom.spoke_angles)  # (n_sp,)
    w = np.abs(r)[None, :] * dr * dphi[:, None]
    w = np.maximum(w, math.pi * (dr / 2.0) ** 2 * (dphi[:, None] / math.pi))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _plan_tables(geom: RadialGeometry, oversamp: float = 2.0, J: int = 4) -> dict:
    """Gridding tables (float64): J×J Kaiser-Bessel tap indices and weights
    of every sample on the oversampled grid, plus the deapodisation.
    Memoised per (geom, oversamp, J); callers treat the dict as read-only."""
    N = geom.image_size
    G = int(round(oversamp * N))
    beta = math.pi * math.sqrt((J / oversamp) ** 2 * (oversamp - 0.5) ** 2 - 0.8)

    # trajectory: k_m = r_i · (cos φ_k, sin φ_k), r uniform over [-k_max, k_max)
    n_sp, n_ro = geom.n_spokes, geom.samples_per_spoke
    k_max = math.pi / geom.pixel_spacing
    r = (np.arange(n_ro) - n_ro / 2.0) * (2.0 * k_max / n_ro)
    phis = np.asarray(geom.spoke_angles)
    kx = r[None, :] * np.cos(phis)[:, None]   # (n_sp, n_ro)
    ky = r[None, :] * np.sin(phis)[:, None]

    # grid coordinates: frequency spacing 2π/G (pixel_spacing folded into k)
    gx = (kx.ravel() * geom.pixel_spacing) * G / (2.0 * math.pi) + G / 2.0
    gy = (ky.ravel() * geom.pixel_spacing) * G / (2.0 * math.pi) + G / 2.0
    n_pts = gx.size

    offs = np.arange(J) - (J / 2.0 - 1.0)      # J taps: floor-based window
    ix0 = np.floor(gx).astype(np.int64)
    iy0 = np.floor(gy).astype(np.int64)
    taps_x = ix0[:, None] + offs[None, :]      # (n_pts, J)
    taps_y = iy0[:, None] + offs[None, :]
    wx = _kb_kernel(gx[:, None] - taps_x, J, beta)
    wy = _kb_kernel(gy[:, None] - taps_y, J, beta)
    # periodic wrap (the FFT grid is periodic; |k| ≤ π wraps at the edge only)
    taps_x = np.mod(taps_x, G)
    taps_y = np.mod(taps_y, G)
    w2 = wy[:, :, None] * wx[:, None, :]
    idx2 = taps_y[:, :, None] * G + taps_x[:, None, :]
    idx = idx2.reshape(n_pts, J * J).astype(np.int64)
    w = w2.reshape(n_pts, J * J)

    apod_x = _kb_apodization(N, G, J, beta)
    apod2d = np.outer(apod_x, apod_x)
    return dict(N=N, G=G, J=J, n_sp=n_sp, n_ro=n_ro, idx=idx, w=w, apod2d=apod2d)


def _np_nufft_forward(T: dict, f: np.ndarray) -> np.ndarray:
    """Type-2 gridding NUFFT of one image (float64 complex)."""
    N, G = T["N"], T["G"]
    lo = G // 2 - N // 2
    fp = np.zeros((G, G), complex)
    fp[lo:lo + N, lo:lo + N] = f / T["apod2d"]
    Fk = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(fp)))
    vals = Fk.ravel()[T["idx"]]
    return (vals * T["w"]).sum(-1).reshape(T["n_sp"], T["n_ro"])


def _np_nufft_adjoint(T: dict, k: np.ndarray) -> np.ndarray:
    """Exact transpose of :func:`_np_nufft_forward` (type-1 gridding)."""
    N, G = T["N"], T["G"]
    contrib = (k.reshape(-1, 1) * T["w"]).ravel()
    ii = T["idx"].ravel()
    grid = (np.bincount(ii, weights=contrib.real, minlength=G * G)
            + 1j * np.bincount(ii, weights=contrib.imag, minlength=G * G))
    f = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(grid.reshape(G, G)))) * (G * G)
    lo = G // 2 - N // 2
    return f[lo:lo + N, lo:lo + N] / T["apod2d"]


@functools.lru_cache(maxsize=None)
def radial_dcf_pipe_menon(geom: RadialGeometry, n_iters: int = 2,
                          oversamp: float = 2.0, J: int = 4) -> np.ndarray:
    """Pipe-Menon iterative density compensation (Pipe & Menon, MRM 1999),
    seeded from :func:`radial_dcf`. Two iterations, as the JAX package
    ships (more diverge); the scale is pinned by a unit-gain calibration on
    a smooth Gaussian so that ``At(k·dcf)/(2π)²`` is in image units."""
    T = _plan_tables(geom, oversamp, J)
    w = radial_dcf(geom).astype(np.float64)
    for _ in range(n_iters):
        denom = np.abs(_np_nufft_forward(T, _np_nufft_adjoint(T, w)))
        w = w / np.maximum(denom, 1e-12)
    N = geom.image_size
    x = (np.arange(N) - N // 2) / N
    cal = np.exp(-(x[None, :] ** 2 + x[:, None] ** 2) / (2.0 * 0.15 ** 2))
    recon = _np_nufft_adjoint(T, w * _np_nufft_forward(T, cal)).real
    s = float((recon * cal).sum() / (cal * cal).sum())
    return (w * (2.0 * math.pi) ** 2 / s).astype(np.float32)


def resolve_dcf(geom: RadialGeometry, dcf: str, oversamp: float = 2.0,
                J: int = 4) -> np.ndarray:
    """The (n_spokes, n_samples) float32 weights named by ``dcf``."""
    if dcf == "pipe_menon":
        return radial_dcf_pipe_menon(geom, oversamp=oversamp, J=J)
    if dcf == "voronoi_ramp":
        return radial_dcf(geom)
    raise ValueError(f"unknown dcf {dcf!r}: expected 'pipe_menon' or 'voronoi_ramp'")
