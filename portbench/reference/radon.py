"""Plain parallel-beam operators: the factored projector evaluated densely.

The operator is defined by its factorization (hat detector footprint,
DFT-domain splat and shear, Hermitian-folded inverse DFT on a detector grid
widened by M bins against wrap-around):

  stage 1:  ĝ[a, j, k] = Σ_i f[j, i] · T̂_a[i, k],  T̂_a[i, k] = spec[k]·e^{−2πik·pos_a[i]/L}
  stage 2:  Ŝ[a, k]    = Σ_j ĝ[a, j, k] · e^{+2πik·shift_a[j]/L}
  stage 3:  p[a, s]    = Σ_k Re Ŝ[a, k]·Wc[k, s] − Im Ŝ[a, k]·Ws[k, s]

for angles whose |cos θ| ≥ |sin θ| (x-primary); the others contract the
rows first. Every angle is computed on its own (no mirror pairs), each
trig table in float64 before it is rounded to float32, and the adjoint is
written out as the exact transpose, so autograd through either gives the
other. The plan arithmetic is a frozen copy of the geometry's, worked out
from the configuration alone.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench.reference.precision import EXACT

__all__ = ["ParallelRef", "sparse_angles", "plan_parallel", "filter_sinogram"]

RING_GUARD = 24
MIN_RING_GUARD = 16


def sparse_angles(n_angles: int, sparsity: int, coverage: float = 1.0) -> np.ndarray:
    """The measured angles: every ``sparsity``-th of ``n_angles`` uniform
    angles over coverage·π."""
    span = coverage * math.pi
    dense = np.array([span * k / n_angles for k in range(n_angles)], np.float64)
    return dense[::sparsity]


def plan_parallel(N: int, angles: np.ndarray, det_count: int = 0, det_spacing: float = 1.0,
                  pixel_spacing: float = 1.0) -> dict:
    """Float64 plan of the factored projector: the wrap extension M, the
    grid L, K frequencies, the footprint spectrum, the inverse-DFT matrices
    and each angle's pos / shift rows."""
    S = det_count or N
    dp, ds = pixel_spacing, det_spacing
    cos, sin = np.cos(angles), np.sin(angles)
    half_support = 1.0
    half = (N - 1) / 2.0 * dp
    m_ang = float(np.max(np.abs(cos) + np.abs(sin)))
    dh = half * m_ang / ds + half_support
    ov = max(0.0, dh - (S - 1) / 2.0)
    M_old = int(math.ceil(half * math.sqrt(0.5) / ds + half_support)) + 1
    M = min(int(math.ceil(ov / 2.0)) + RING_GUARD, M_old)
    K_cur = (S + 2 * M) // 2 + 1
    K_tile = ((K_cur - 1) // 128) * 128
    if K_tile >= 128:
        L_t = 2 * K_tile - 1 if S % 2 else 2 * (K_tile - 1)
        M_t = (L_t - S) // 2
        if M_t < M and 2 * M_t - ov >= 2 * MIN_RING_GUARD:
            M = M_t
    L = S + 2 * M
    K = L // 2 + 1
    k = np.arange(K)
    c_s = (S - 1) / 2.0
    centers = (np.arange(N) - (N - 1) / 2.0) * dp
    x_primary = np.abs(cos) >= np.abs(sin)
    prim = np.where(x_primary, cos, sin)
    seco = np.where(x_primary, sin, cos)
    pos = prim[:, None] * centers[None, :] / ds + M + c_s
    shift = M - seco[:, None] * centers[None, :] / ds

    tq = np.linspace(-half_support * ds, half_support * ds, 4096)
    kq = np.maximum(0.0, 1.0 - np.abs(tq) / ds)
    omega = 2.0 * math.pi * k / (L * ds)
    spec = (np.cos(np.outer(omega, tq)) @ kq) * (tq[1] - tq[0]) * (dp * dp / (ds * ds))
    ck = np.full(K, 2.0)
    ck[0] = 1.0
    if L % 2 == 0:
        ck[-1] = 1.0
    ang_w = 2.0 * math.pi * np.outer(k, np.arange(S)) / L
    Wc = (ck[:, None] / L) * np.cos(ang_w)
    Ws = (ck[:, None] / L) * np.sin(ang_w)
    return dict(N=N, S=S, M=M, L=L, K=K, x_primary=x_primary, pos=pos, shift=shift,
                spec=spec, Wc=Wc, Ws=Ws, det_spacing=ds, pixel_spacing=dp)


class _Group(NamedTuple):
    idx: torch.Tensor        # angle indices of the group
    T: torch.Tensor          # (A_g, N, K) complex64 splat
    E: torch.Tensor          # (A_g, N, K) complex64 shear
    contract_x: bool


class ParallelRef:
    """A, A† and FBP of one parallel-beam geometry on ``device``, with
    operands rounded by ``prec.hi`` (float32-stated) or ``prec.lo``
    (bfloat16-stated) as the caller asks. Real images, real sinograms."""

    complex = False

    def __init__(self, N: int, angles: np.ndarray, device, det_count: int = 0,
                 det_spacing: float = 1.0, pixel_spacing: float = 1.0):
        plan = plan_parallel(N, angles, det_count, det_spacing, pixel_spacing)
        self.plan = plan
        self.N, self.S, self.A = N, plan["S"], len(angles)
        L, K = plan["L"], plan["K"]
        k = np.arange(K)
        self.groups = []
        for contract_x in (True, False):
            idx = np.nonzero(plan["x_primary"] == contract_x)[0]
            if idx.size == 0:
                continue
            T = plan["spec"][None, None, :] * np.exp(
                -2j * math.pi * plan["pos"][idx][:, :, None] * k[None, None, :] / L)
            E = np.exp(2j * math.pi * plan["shift"][idx][:, :, None] * k[None, None, :] / L)
            self.groups.append(_Group(torch.as_tensor(idx, device=device),
                                      torch.as_tensor(T.astype(np.complex64), device=device),
                                      torch.as_tensor(E.astype(np.complex64), device=device),
                                      contract_x))
        W = (plan["Wc"] + 1j * plan["Ws"]).astype(np.complex64)   # p = Re(Ŝ·W)
        self.W = torch.as_tensor(W, device=device)
        self.bp_scale = math.pi / self.A * det_spacing / pixel_spacing ** 2
        self.det_spacing = det_spacing

    def A_(self, f: torch.Tensor, rnd=EXACT.hi) -> torch.Tensor:
        """(B, N, N) real → (B, A, S) real."""
        B, N = f.shape[0], self.N
        out = f.new_zeros((B, self.A, self.S))
        W = rnd(self.W)
        for g in self.groups:
            x = f if g.contract_x else f.transpose(1, 2)          # contract the last axis
            T, E = rnd(g.T), rnd(g.E)
            Ag, K = T.shape[0], T.shape[2]
            x = rnd(x).reshape(B * N, N)
            Tm = T.permute(1, 0, 2).reshape(N, Ag * K)
            gh = torch.complex(x @ Tm.real, x @ Tm.imag).reshape(B, N, Ag, K)
            Sh = (rnd(gh) * E.permute(1, 0, 2)[None]).sum(1)       # (B, Ag, K)
            p = (rnd(Sh).reshape(B * Ag, K) @ W).real.reshape(B, Ag, self.S)
            out = out.index_copy(1, g.idx, p)
        return out

    def At_(self, q: torch.Tensor, rnd=EXACT.hi) -> torch.Tensor:
        """(B, A, S) real → (B, N, N) real, the exact transpose of :meth:`A_`."""
        B, N = q.shape[0], self.N
        W = rnd(self.W)
        f = q.new_zeros((B, N, N))
        for g in self.groups:
            T, E = rnd(g.T), rnd(g.E)
            Ag, K = T.shape[0], T.shape[2]
            qg = rnd(q.index_select(1, g.idx)).reshape(B * Ag, self.S)
            c = torch.complex(qg @ W.real.T, qg @ W.imag.T).reshape(B, Ag, K)
            h = rnd(c)[:, None] * E.permute(1, 0, 2)[None]          # (B, N, Ag, K)
            h = rnd(h).reshape(B * N, Ag * K)
            Tm = T.permute(1, 0, 2).reshape(N, Ag * K)
            part = (h.real @ Tm.real.T - h.imag @ Tm.imag.T).reshape(B, N, N)
            f = f + (part if g.contract_x else part.transpose(1, 2))
        return f

    def fbp(self, p: torch.Tensor, rnd=EXACT.hi) -> torch.Tensor:
        return self.bp_scale * self.At_(filter_sinogram(p, self.det_spacing), rnd)


def _next_pow2(n: int) -> int:
    return 1 << max(6, (n - 1).bit_length())


def filter_sinogram(sino: torch.Tensor, det_spacing: float = 1.0) -> torch.Tensor:
    """Ram-Lak filtering along the detector axis with the band-limited
    discrete impulse response (Kak & Slaney eq. 61), zero-padded to a power
    of two of at least 2S."""
    S = sino.shape[-1]
    pad = _next_pow2(2 * S)
    n = np.concatenate([np.arange(0, pad // 2 + 1), np.arange(pad // 2 - 1, 0, -1)])
    h = np.zeros(pad, np.float64)
    h[0] = 1.0 / (4.0 * det_spacing ** 2)
    odd = n % 2 == 1
    h[odd] = -1.0 / (np.pi * n[odd] * det_spacing) ** 2
    H = torch.as_tensor(np.fft.rfft(h).real.astype(np.float32), device=sino.device)
    spec = torch.fft.rfft(sino.float(), n=pad, dim=-1)
    return torch.fft.irfft(spec * H, n=pad, dim=-1)[..., :S] * det_spacing
