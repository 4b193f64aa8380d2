"""Plain golden-angle radial MRI operators: the type-2 nonuniform DFT at the
spoke samples, written as a direct sum, its adjoint, and the Pipe-Menon
density-compensated adjoint.

Spoke a lies at φ_a = a·(3 − √5)·π mod 2π; sample m at radius
r_m = (m − n/2)·2π/(n·δp); pixel (j, i) at (x_i, y_j) = ((i − N//2)·δp,
(j − N//2)·δp), row j along +y. So

  A(z)[a, m] = Σ_{j,i} z[j, i] · e^{−i r_m (x_i cos φ_a + y_j sin φ_a)},

computed as two separable sums (over i, then j) in blocks of spokes. The
density compensation is a frozen copy of Pipe & Menon (MRM 1999) over a
Kaiser-Bessel gridding in float64 numpy, seeded from the Voronoi ramp and
pinned to unit gain, as the configuration's direct reconstruction states.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference.precision import EXACT

__all__ = ["RadialRef", "spoke_angles", "pipe_menon_dcf"]

GOLDEN_ANGLE = math.pi * (3.0 - math.sqrt(5.0))


def spoke_angles(n_spokes: int) -> np.ndarray:
    return np.array([(k * GOLDEN_ANGLE) % (2.0 * math.pi) for k in range(n_spokes)])


class RadialRef:
    """A, A† and the DCF adjoint (``fbp``) of ``n_spokes`` golden-angle
    spokes of ``n_samples`` samples over an N² image, on ``device``.
    Complex images, complex k-space."""

    complex = True

    def __init__(self, N: int, n_spokes: int, n_samples: int, device,
                 pixel_spacing: float = 1.0, spoke_block: int = 16):
        self.N, self.n_spokes, self.n_samples = N, n_spokes, n_samples
        phis = spoke_angles(n_spokes)
        r = (np.arange(n_samples) - n_samples / 2.0) * (2.0 * math.pi / (n_samples * pixel_spacing))
        c = (np.arange(N) - N // 2) * pixel_spacing
        ex = np.exp(-1j * r[None, None, :] * c[None, :, None] * np.cos(phis)[:, None, None])
        ey = np.exp(-1j * r[None, None, :] * c[None, :, None] * np.sin(phis)[:, None, None])
        self.Ex = torch.as_tensor(ex.astype(np.complex64), device=device)   # (A, N_i, M)
        self.Ey = torch.as_tensor(ey.astype(np.complex64), device=device)   # (A, N_j, M)
        self.dcf = torch.as_tensor(
            pipe_menon_dcf(N, phis, n_samples, pixel_spacing), device=device)
        self.block = spoke_block

    def A_(self, z: torch.Tensor, rnd=EXACT.hi) -> torch.Tensor:
        """(B, N, N) complex → (B, n_spokes, n_samples) complex."""
        B, N, M = z.shape[0], self.N, self.n_samples
        zr = rnd(z.to(torch.complex64)).reshape(B * N, N)
        out = []
        for a0 in range(0, self.n_spokes, self.block):
            Ex, Ey = rnd(self.Ex[a0:a0 + self.block]), rnd(self.Ey[a0:a0 + self.block])
            a = Ex.shape[0]
            G = (zr @ Ex.permute(1, 0, 2).reshape(N, a * M)).reshape(B, N, a, M)
            out.append((rnd(G) * Ey.permute(1, 0, 2)[None]).sum(1))
        return torch.cat(out, dim=1)

    def At_(self, k: torch.Tensor, rnd=EXACT.hi) -> torch.Tensor:
        """(B, n_spokes, n_samples) complex → (B, N, N) complex: A's
        conjugate transpose."""
        B, N, M = k.shape[0], self.N, self.n_samples
        k = rnd(k.to(torch.complex64))
        z = k.new_zeros((B, N, N))
        for a0 in range(0, self.n_spokes, self.block):
            Ex, Ey = rnd(self.Ex[a0:a0 + self.block]), rnd(self.Ey[a0:a0 + self.block])
            a = Ex.shape[0]
            H = rnd(k[:, None, a0:a0 + a] * Ey.conj().permute(1, 0, 2)[None])  # (B, N_j, a, M)
            z = z + H.reshape(B * N, a * M).matmul(
                Ex.conj().permute(0, 2, 1).reshape(a * M, N)).reshape(B, N, N)
        return z

    def fbp(self, k: torch.Tensor, rnd=EXACT.hi) -> torch.Tensor:
        return self.At_(k * self.dcf, rnd) / (2.0 * math.pi) ** 2


# ---- Pipe-Menon density compensation (float64 numpy) ----------------------

def _kb(t, J, beta):
    mask = np.abs(t) <= J / 2.0
    return np.where(mask, np.i0(beta * np.sqrt(np.maximum(1.0 - (2.0 * t / J) ** 2, 0.0))), 0.0)


def _gridding(N, phis, n_samples, dp, oversamp=2.0, J=4):
    G = int(round(oversamp * N))
    beta = math.pi * math.sqrt((J / oversamp) ** 2 * (oversamp - 0.5) ** 2 - 0.8)
    k_max = math.pi / dp
    r = (np.arange(n_samples) - n_samples / 2.0) * (2.0 * k_max / n_samples)
    gx = (r[None, :] * np.cos(phis)[:, None] * dp).ravel() * G / (2.0 * math.pi) + G / 2.0
    gy = (r[None, :] * np.sin(phis)[:, None] * dp).ravel() * G / (2.0 * math.pi) + G / 2.0
    offs = np.arange(J) - (J / 2.0 - 1.0)
    tx = np.floor(gx).astype(np.int64)[:, None] + offs[None, :]
    ty = np.floor(gy).astype(np.int64)[:, None] + offs[None, :]
    wx, wy = _kb(gx[:, None] - tx, J, beta), _kb(gy[:, None] - ty, J, beta)
    tx, ty = np.mod(tx, G), np.mod(ty, G)
    idx = (ty[:, :, None] * G + tx[:, None, :]).reshape(gx.size, J * J).astype(np.int64)
    w = (wy[:, :, None] * wx[:, None, :]).reshape(gx.size, J * J)
    t = np.linspace(-J / 2.0, J / 2.0, 4096)
    x = np.arange(N) - N // 2
    apod = (np.exp(2j * math.pi * np.outer(x, t) / G) @ _kb(t, J, beta)).real * (t[1] - t[0])
    return dict(N=N, G=G, shape=(len(phis), n_samples), idx=idx, w=w, apod=np.outer(apod, apod))


def _grid_fwd(T, f):
    N, G = T["N"], T["G"]
    lo = G // 2 - N // 2
    fp = np.zeros((G, G), complex)
    fp[lo:lo + N, lo:lo + N] = f / T["apod"]
    Fk = np.fft.fftshift(np.fft.fft2(np.fft.ifftshift(fp)))
    return (Fk.ravel()[T["idx"]] * T["w"]).sum(-1).reshape(T["shape"])


def _grid_adj(T, k):
    N, G = T["N"], T["G"]
    contrib = (k.reshape(-1, 1) * T["w"]).ravel()
    ii = T["idx"].ravel()
    grid = (np.bincount(ii, weights=contrib.real, minlength=G * G)
            + 1j * np.bincount(ii, weights=contrib.imag, minlength=G * G))
    f = np.fft.fftshift(np.fft.ifft2(np.fft.ifftshift(grid.reshape(G, G)))) * (G * G)
    lo = G // 2 - N // 2
    return f[lo:lo + N, lo:lo + N] / T["apod"]


def pipe_menon_dcf(N: int, phis: np.ndarray, n_samples: int, dp: float = 1.0,
                   n_iters: int = 2) -> np.ndarray:
    """(n_spokes, n_samples) float32 weights: the Voronoi ramp Δr·Δφ·|r|
    refined twice by w ← w / |G(G†(w))|, scaled so that At(k·w)/(2π)² has
    unit gain on a smooth Gaussian."""
    k_max = math.pi / dp
    dr = 2.0 * k_max / n_samples
    r = (np.arange(n_samples) - n_samples / 2.0) * dr
    o = np.asarray(phis, np.float64) % math.pi
    order = np.argsort(o)
    s = o[order]
    ext = np.concatenate([[s[-1] - math.pi], s, [s[0] + math.pi]])
    dphi = np.empty_like(s)
    dphi[order] = (ext[2:] - ext[:-2]) / 2.0
    w = np.abs(r)[None, :] * dr * dphi[:, None]
    w = np.maximum(w, math.pi * (dr / 2.0) ** 2 * (dphi[:, None] / math.pi))
    w = w.astype(np.float32).astype(np.float64)
    T = _gridding(N, phis, n_samples, dp)
    for _ in range(n_iters):
        w = w / np.maximum(np.abs(_grid_fwd(T, _grid_adj(T, w))), 1e-12)
    x = (np.arange(N) - N // 2) / N
    cal = np.exp(-(x[None, :] ** 2 + x[:, None] ** 2) / (2.0 * 0.15 ** 2))
    rec = _grid_adj(T, w * _grid_fwd(T, cal)).real
    scale = float((rec * cal).sum() / (cal * cal).sum())
    return (w * (2.0 * math.pi) ** 2 / scale).astype(np.float32)
