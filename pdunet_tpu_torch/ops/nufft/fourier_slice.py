"""Radial NUFFT by direct spectral sampling (port of
``pdunet_tpu/ops/nufft/fourier_slice.py``; the derivation lives there).

By the projection-slice theorem the factored parallel-beam projector's
stage-2 intermediate Ŝ[a, k] = Σ_pixels f·e^{−i ν_k (x cosθ_a + y sinθ_a)}
is the image's 2-D Fourier transform along spoke a. With the spectral grid
ν_k on the spoke radii (L = samples_per_spoke at δs = δp) the radial type-2
NUFFT is a projection whose stage 3 is a ±1 selection matrix: column m
picks Re F(r_m) or the base Im F(r_m) of spectral index |m − n/2|, with the
Hermitian conjugation of r < 0 folded in as a sign. The backing plan pairs
no angles (golden-angle spokes), so every A and A† here runs through the
per-angle kernels (``ops/radon/cuda_kernels.py``).

The one band-edge sample per spoke (r = −k_max, spectral index K, just past
the kernel's K frequencies) comes from a separable side einsum
(:func:`_nyquist_fwd`, ≈ 0.5% of an apply) and is written into column 0.
Spokes at angles ≥ π sample F((−r)·ω(φ−π)): a per-spoke ±1 on the Im half.

Complex images are (Re, Im)-stacked along the batch, so the kernels see
batch 2B. Plan math is float64 numpy, identical to the JAX package's.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pdunet_tpu_torch.geometry import (
    _COMPUTE_DTYPES,
    ParallelGeometry,
    ParallelPlan,
    RadialGeometry,
)
from pdunet_tpu_torch.ops.radon.parallel import parallel_backproject, parallel_project

__all__ = ["FsPlan", "build_fs_plan", "fs_nufft_forward", "fs_nufft_adjoint"]


class FsPlan:
    """Fourier-slice plan: the backing per-angle ``ParallelPlan`` plus the
    per-spoke sign ``sgn`` and the side term's separable phases
    (``Cx``, ``Sx``, ``Cy``, ``Sy``, each (A, N)); float32 on one device."""

    ARRAYS = ("sgn", "Cx", "Sx", "Cy", "Sy")

    def __init__(self, geom, meta, par_plan, sgn, Cx, Sx, Cy, Sy):
        self.geom = geom
        self.meta = meta
        self.par_plan = par_plan
        self.sgn = sgn
        self.Cx, self.Sx, self.Cy, self.Sy = Cx, Sx, Cy, Sy


def build_fs_plan(geom: RadialGeometry, dtype=torch.float32, device="cuda") -> FsPlan:
    """Build the fourier-slice plan for ``geom`` on ``device``; ``dtype``
    is the projector's operand type (float32 or bfloat16)."""
    if dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    N = geom.image_size
    dp = geom.pixel_spacing
    n_sp, n_ro = geom.n_spokes, geom.samples_per_spoke
    if n_ro % 2:
        raise ValueError(
            "the spectral fourier_slice path needs an even samples_per_spoke "
            f"(got {n_ro})")

    phis = np.asarray(geom.spoke_angles)
    theta = np.mod(phis, math.pi)
    sgn = 1.0 - 2.0 * (phis >= math.pi)  # −1: sample at −r of the mod-π line

    # radii r_m = (m − n_ro/2)·Δr with Δr = 2π/(n_ro·δp); the spectral grid
    # ν_k = 2πk/(L·δs), δs = δp, L = n_ro gives |r_m| = ν_{|m − n_ro/2|}
    L = n_ro
    K = n_ro // 2            # kernel frequencies 0..K−1; k = K is the side term
    cos_t, sin_t = np.cos(theta), np.sin(theta)

    is_x = np.abs(cos_t) >= np.abs(sin_t)
    idx_x = np.nonzero(is_x)[0]
    idx_y = np.nonzero(~is_x)[0]

    # NUFFT pixel-centre convention: coordinates centred on index N//2
    centers = (np.arange(N) - N // 2) * dp

    def group_arrays(idx, primary_cos):
        if idx.size == 0:
            z = np.zeros((0, N), np.float64)
            return z, z
        prim = cos_t[idx] if primary_cos else sin_t[idx]
        seco = sin_t[idx] if primary_cos else cos_t[idx]
        # with spec all ones the composite exponent is exactly the unscaled
        # DFT sample e^{−i ν_k (x cosθ + y sinθ)}: no detector window, no
        # centring, no wrap extension
        pos = prim[:, None] * centers[None, :] / dp
        shift = -seco[:, None] * centers[None, :] / dp
        return pos, shift

    pos_x, shift_x = group_arrays(idx_x, primary_cos=True)
    pos_y, shift_y = group_arrays(idx_y, primary_cos=False)

    # selection "stage 3": columns [0, n_ro) = Re F(r_m), [n_ro, 2n_ro) =
    # base-Im F(r_m) with the r < 0 conjugation folded in as a sign
    m = np.arange(n_ro)
    k_m = np.abs(m - n_ro // 2)
    conj = m < n_ro // 2
    Wc = np.zeros((K, 2 * n_ro))
    Ws = np.zeros((K, 2 * n_ro))
    inside = k_m < K                      # k = K (only m = 0) → side term
    cols = np.nonzero(inside)[0]
    Wc[k_m[cols], cols] = 1.0
    # the kernel emits −s_im·Ws; want +s_im (r ≥ 0) or −s_im (conj)
    Ws[k_m[cols], n_ro + cols] = np.where(conj[cols], 1.0, -1.0)

    spec = np.ones(K)

    order = np.concatenate([idx_x, idx_y])
    inv_perm = np.empty_like(order)
    inv_perm[order] = np.arange(order.size)
    zN = np.zeros((0, N))
    z0 = np.zeros(0)
    meta = dict(
        N=N, S=2 * n_ro, M=0, S_ext=L, K=K,
        A_x=int(idx_x.size), A_y=int(idx_y.size),
        inv_perm=tuple(int(i) for i in inv_perm),
        idx_x=tuple(int(i) for i in idx_x),
        idx_y=tuple(int(i) for i in idx_y),
        # the backing plan's "detector" axis is the [Re | Im] spectral
        # halves, not ray integrals: detector-space consumers must refuse it
        spectral_selection=True,
        P_x=0, P_y=0, use_pairs=False,
        pair_inv_perm=(), pair_take_x=(), pair_take_y=(),
        compute_dtype=_COMPUTE_DTYPES[dtype],
    )

    # band-edge side term: F(k_max·ω(θ_a)) as separable per-axis phases
    k_max = math.pi / dp
    ax = np.outer(cos_t, centers) * k_max   # (A, N)
    ay = np.outer(sin_t, centers) * k_max

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    par_plan = ParallelPlan(
        # placeholder geometry for the plan container: det_count = 2·n_ro
        # because the "detector" axis holds the [Re | Im] spectral halves
        ParallelGeometry(image_size=N, det_count=2 * n_ro, det_spacing=dp,
                         pixel_spacing=dp, angles=tuple(float(t) for t in theta)),
        meta,
        dev(pos_x), dev(shift_x), dev(pos_y), dev(shift_y),
        dev(spec), dev(Wc), dev(Ws),
        dev(zN), dev(zN), dev(zN), dev(z0), dev(z0),
        dev(zN), dev(zN), dev(zN), dev(z0), dev(z0),
    )
    fs_meta = dict(N=N, n_spokes=n_sp, n_samples=n_ro, K=K)
    return FsPlan(geom, fs_meta, par_plan, dev(sgn),
                  dev(np.cos(ax)), dev(np.sin(ax)), dev(np.cos(ay)), dev(np.sin(ay)))


def _nyquist_fwd(plan: FsPlan, u: torch.Tensor):
    """E[b, a] = Σ_{j,i} u[b,j,i]·e^{−i k_max(x_i cosθ_a + y_j sinθ_a)} for a
    real batch u: the one spectral sample per spoke past the kernel's K."""
    Cx, Sx, Cy, Sy = (t.to(u.dtype) for t in (plan.Cx, plan.Sx, plan.Cy, plan.Sy))
    t_re = torch.einsum("bji,ai->baj", u, Cx)
    t_im = -torch.einsum("bji,ai->baj", u, Sx)
    e_re = torch.einsum("baj,aj->ba", t_re, Cy) + torch.einsum("baj,aj->ba", t_im, Sy)
    e_im = torch.einsum("baj,aj->ba", t_im, Cy) - torch.einsum("baj,aj->ba", t_re, Sy)
    return e_re, e_im


def _nyquist_adj(plan: FsPlan, g_re: torch.Tensor, g_im: torch.Tensor):
    """Exact transpose of :func:`_nyquist_fwd`."""
    Cx, Sx, Cy, Sy = (t.to(g_re.dtype) for t in (plan.Cx, plan.Sx, plan.Cy, plan.Sy))
    r1 = torch.einsum("ba,aj->baj", g_re, Cy) - torch.einsum("ba,aj->baj", g_im, Sy)
    r2 = torch.einsum("ba,aj->baj", g_re, Sy) + torch.einsum("ba,aj->baj", g_im, Cy)
    return torch.einsum("baj,ai->bji", r1, Cx) - torch.einsum("baj,ai->bji", r2, Sx)


def _complex_dtype(x: torch.Tensor):
    """complex128 for float64/complex128 input (gradcheck), else complex64."""
    return (torch.complex128 if x.dtype in (torch.float64, torch.complex128)
            else torch.complex64)


def fs_nufft_forward(plan: FsPlan, image: torch.Tensor, project=None) -> torch.Tensor:
    """(..., N, N) complex → (..., n_spokes, n_samples) complex. ``project``:
    the backing projection (by default :func:`parallel_project` on
    ``plan.par_plan``); the per-spoke selection and assembly run whole."""
    batch_shape = image.shape[:-2]
    z = image.to(_complex_dtype(image)).reshape((-1,) + tuple(image.shape[-2:]))
    B = z.shape[0]
    M = plan.meta["n_samples"]
    u = torch.cat([z.real, z.imag], dim=0)              # (2B, N, N)
    project = project or functools.partial(parallel_project, plan.par_plan)
    q = project(u)                                       # (2B, A, 2M)
    e_re, e_im = _nyquist_fwd(plan, u)
    # column m = 0 is r = −k_max: Re = Re E, base-Im = −Im E (conjugated)
    P = torch.cat([e_re[..., None], q[..., 1:M]], dim=-1)
    Q = torch.cat([-e_im[..., None], q[..., M + 1:]], dim=-1)
    sg = plan.sgn.to(u.dtype)[None, :, None]
    out = torch.complex(P[:B] - sg * Q[B:], sg * Q[:B] + P[B:])
    return out.reshape(batch_shape + out.shape[1:])


def fs_nufft_adjoint(plan: FsPlan, kdata: torch.Tensor, backproject=None) -> torch.Tensor:
    """Exact conjugate transpose of :func:`fs_nufft_forward`
    (⟨Ax, y⟩ = ⟨x, A†y⟩ with conjugating inner products). ``backproject``:
    the transpose of ``fs_nufft_forward``'s ``project``."""
    batch_shape = kdata.shape[:-2]
    k = kdata.to(_complex_dtype(kdata)).reshape((-1,) + tuple(kdata.shape[-2:]))
    yr, yi = k.real, k.imag
    sg = plan.sgn.to(yr.dtype)[None, :, None]
    # transpose of the (P, Q) → complex assembly
    q = torch.cat([
        torch.cat([yr, sg * yi], dim=-1),                # component Re
        torch.cat([yi, -sg * yr], dim=-1),               # component Im
    ], dim=0)                                            # (2B, A, 2M)
    M = plan.meta["n_samples"]
    backproject = backproject or functools.partial(parallel_backproject, plan.par_plan)
    u = backproject(q)
    # transpose of the column-0 side writes (those W columns are zero, so
    # the backprojection saw none of their cotangent)
    u = u + _nyquist_adj(plan, q[..., 0], -q[..., M])
    B = yr.shape[0]
    out = torch.complex(u[:B], u[B:])
    return out.reshape(batch_shape + out.shape[1:])
