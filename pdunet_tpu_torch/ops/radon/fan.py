"""Fan-beam Radon forward / adjoint / FBP by exact rebinning (port of
``pdunet_tpu/ops/radon/fan.py``; the derivation lives there).

A fan ray and a parallel ray are the same line under
p_fan(β, γ) = p_par(θ = β + γ, s = R·sin γ), tan γ = u / (R + D), so the fan
operator is the parallel projector between two static, axis-separable
rebinning maps:

  * the backing parallel sinogram lives on an extended angle grid
    θ_i = β₀ + (i − margin)·Δβ with the fan scan's spacing, so the angle
    coordinate of (β_k, u) is k + c(u): a 2-banded interpolation per
    detector column (``_gather_rows``, a u-batched product against banded
    weights; its exact transpose is ``_scatter_rows_T``);
  * the detector coordinate depends only on u, s = R·sin γ(u): a product
    with a 2-banded (S_par, n_u) matrix ``Ms``.

Forward = parallel_project (the mirror-pair kernels on the backing plan,
whose angles run beyond [0, π) and pair θ with π − θ, −θ or 2π − θ) → · Ms
→ banded angle product; the adjoint transposes each factor. FBP rebins fan
→ parallel (``Mu``, then the banded product with the inverse shifts; a
full-circle scan wraps periodically, a limited-angle one zero-pads), weights
each row by its direction multiplicity (``wrow``), ramp-filters and
backprojects on the backing plan.

The rebinning products are plain ``torch`` products in float32 (float64 for
a float64 input). The plan's weights are rounded through the operand type
(bf16 for bf16 operators), as the JAX package stores them in it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pdunet_tpu_torch.geometry import (
    _COMPUTE_DTYPES,
    FanGeometry,
    ParallelGeometry,
    build_parallel_plan,
)
from pdunet_tpu_torch.ops.radon.filtering import filter_sinogram
from pdunet_tpu_torch.ops.radon.parallel import (
    RadonOps,
    _Backproject,
    _Project,
    parallel_backproject,
    parallel_project,
    plan_projector,
)

__all__ = ["FanPlan", "build_fan_plan", "fan_project", "fan_backproject",
           "fan_rebin_to_parallel", "make_fan_ops"]


class FanPlan:
    """The backing ``ParallelPlan`` (extended angle grid), the detector
    resample matrices ``Ms`` (S_par, n_u) and ``Mu`` (n_u, S_par), the
    forward and inverse angle shifts ``c0``/``cf`` (per detector column)
    and ``d0``/``df`` (per parallel bin), and the FBP row weights ``wrow``,
    on one device, plus static ``meta``.

    ``band(name, dtype)`` gives the banded angle-interpolation weights of
    one rebinning as a dense (U, n_out, n_in + 2·pad) tensor, built on the
    plan's device at first use and kept (``band_builds`` counts the
    builds): the JAX package regenerates them in every call, the same
    function. The forward's ``"fwd"`` serves A and A†, ``"rebin"`` the FBP.
    """

    ARRAYS = ("Ms", "Mu", "c0", "cf", "d0", "df", "wrow")

    def __init__(self, geom, meta, par_plan, Ms, Mu, c0, cf, d0, df, wrow):
        self.geom = geom
        self.meta = meta
        self.par_plan = par_plan
        self.Ms, self.Mu = Ms, Mu
        self.c0, self.cf = c0, cf
        self.d0, self.df = d0, df
        self.wrow = wrow
        self._bands = {}
        self.band_builds = 0

    def band(self, name: str, dtype) -> torch.Tensor:
        key = (name, dtype)
        if key not in self._bands:
            meta = self.meta
            if name == "fwd":
                args = (self.c0, self.cf, meta["n_beta"], meta["n_ext"], meta["pad_beta"])
            elif meta["full_circle"]:
                # the periodic wrap concatenates pad_ext rows on each side
                # and reads them with a 2-row pad
                args = (self.d0 + meta["pad_ext"], self.df, meta["n_ext"],
                        meta["n_beta"] + 2 * meta["pad_ext"], 2)
            else:
                args = (self.d0, self.df, meta["n_ext"], meta["n_beta"], meta["pad_ext"])
            with torch.no_grad():
                self._bands[key] = _band_weights(*args, dtype=dtype)
            self.band_builds += 1
        return self._bands[key]


def _hat_matrix(positions: np.ndarray, size: int, spacing: float,
                valid: np.ndarray = None) -> np.ndarray:
    """(size, len(positions)) 2-banded linear-interpolation matrix: column p
    has hat taps at grid index positions[p]/spacing + centre."""
    n = positions.size
    c = (size - 1) / 2.0
    pos = positions / spacing + c
    j0 = np.floor(pos).astype(np.int64)
    frac = pos - j0
    M = np.zeros((size, n))
    ok = (j0 >= 0) & (j0 < size)
    if valid is not None:
        ok &= valid
    cols = np.arange(n)
    M[np.clip(j0, 0, size - 1), cols] += np.where(ok, 1.0 - frac, 0.0)
    ok1 = (j0 + 1 >= 0) & (j0 + 1 < size)
    if valid is not None:
        ok1 &= valid
    M[np.clip(j0 + 1, 0, size - 1), cols] += np.where(ok1, frac, 0.0)
    return M


def build_fan_plan(geom: FanGeometry, dtype=torch.float32, device="cuda") -> FanPlan:
    """Build the fan plan of ``geom`` on ``device``; ``dtype`` is the
    operand type of the backing projector (float32 or bfloat16). Plan math
    is float64 numpy, identical to the JAX package's."""
    if dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
    R, Dd = geom.source_distance, geom.det_distance
    n_beta, n_u = geom.n_angles, geom.det_count
    du, dp = geom.det_spacing, geom.pixel_spacing
    betas = np.asarray(geom.angles, np.float64)
    dbeta = betas[1] - betas[0] if n_beta > 1 else 2 * math.pi
    beta_span = betas[-1] - betas[0] + dbeta
    full_circle = abs(beta_span - 2 * math.pi) < 1e-6

    u = (np.arange(n_u) - (n_u - 1) / 2.0) * du
    gamma = np.arctan2(u, R + Dd)
    gamma_max = float(np.abs(gamma).max())
    fov = R * math.sin(gamma_max)

    ds = dp
    S_par = 2 * int(math.ceil(fov / ds)) + 3

    # extended parallel angle grid, the fan scan's spacing
    margin = int(math.ceil(gamma_max / dbeta)) + 2
    n_ext = n_beta + 2 * margin
    thetas = betas[0] + (np.arange(n_ext) - margin) * dbeta
    par_geom = ParallelGeometry(
        image_size=geom.image_size,
        det_count=S_par,
        det_spacing=ds,
        pixel_spacing=dp,
        angles=tuple(float(t) for t in thetas),
    )

    # forward: the angle index of (β_k, u) is k + margin + γ(u)/Δβ
    c = margin + gamma / dbeta
    c0 = np.floor(c).astype(np.int32)
    cf = (c - c0).astype(np.float32)
    Ms = _hat_matrix(R * np.sin(gamma), S_par, ds)

    # inverse (FBP): the β index of (θ_i, s) is i − margin − γ(s)/Δβ
    s_par = (np.arange(S_par) - (S_par - 1) / 2.0) * ds
    g_of_s = np.arcsin(np.clip(s_par / R, -1.0, 1.0))
    valid_s = np.abs(s_par) < fov
    d = -margin - g_of_s / dbeta
    d0 = np.floor(d).astype(np.int32)
    df = (d - d0).astype(np.float32)
    Mu = _hat_matrix((R + Dd) * np.tan(g_of_s), n_u, du, valid=valid_s)

    # FBP row weights: Δβ per covered direction, shared by the conjugate rows
    # that measure the same θ mod π (a triangular-window multiplicity)
    th_mod = np.mod(thetas, math.pi)
    diff = np.abs(th_mod[:, None] - th_mod[None, :])
    diff = np.minimum(diff, math.pi - diff)
    mult = np.maximum(np.sum(np.maximum(1.0 - diff / dbeta, 0.0), axis=1), 1.0)
    wrow = (dbeta / mult * ds / (dp * dp)).astype(np.float32)

    meta = dict(
        n_beta=n_beta, n_u=n_u, n_ext=n_ext, S_par=S_par, margin=margin,
        full_circle=bool(full_circle),
        # covers max |c0| + 1 in both directions: c0 ≤ margin + γ_max/Δβ < 2·margin
        pad_beta=int(2 * margin + 2),
        pad_ext=int(2 * margin + int(math.ceil(gamma_max / dbeta)) + 2),
    )
    if full_circle and meta["pad_ext"] > n_beta:
        # the periodic wrap concatenates p[:, -pad:] / p[:, :pad]; with fewer
        # than pad rows the slices would shrink and misalign the base
        raise ValueError(
            f"full-circle fan scan too sparse to rebin: need pad_ext="
            f"{meta['pad_ext']} wrap rows but only n_beta={n_beta} views; "
            "increase n_angles or reduce the fan angle")

    def dev(a):
        # float32 values rounded through the operand type, as the JAX plan stores them
        t = torch.as_tensor(np.asarray(a, np.float32))
        return t.to(dtype).to(torch.float32).to(device)

    def dev_int(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return FanPlan(geom, meta, build_parallel_plan(par_geom, dtype=dtype, device=device),
                   dev(Ms), dev(Mu), dev_int(c0), dev(cf), dev_int(d0), dev(df), dev(wrow))


def _band_weights(base: torch.Tensor, frac: torch.Tensor, n_out: int, n_in: int, pad: int,
                  dtype=torch.float32) -> torch.Tensor:
    """(U, n_out, n_in + 2·pad) two-banded interpolation weights: row o of
    column u reads padded input rows o + base_u (weight 1 − frac_u) and
    o + base_u + 1 (weight frac_u)."""
    dev = frac.device
    i = torch.arange(n_in + 2 * pad, device=dev)[None, None, :]
    o = torch.arange(n_out, device=dev)[None, :, None]
    b = base.to(dev)[:, None, None] + pad
    f = frac.to(dtype)[:, None, None]
    return (i == o + b).to(dtype) * (1.0 - f) + (i == o + b + 1).to(dtype) * f


def _work_dtype(x: torch.Tensor):
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _gather_rows(x: torch.Tensor, W: torch.Tensor, pad: int) -> torch.Tensor:
    """Separable 2-tap angle interpolation x (B, n_in, U) → (B, n_out, U),
    out[b, k, u] = (1 − f_u)·x[b, k + base_u, u] + f_u·x[b, k + base_u + 1, u],
    as a u-batched product against the banded weights W (U, n_out,
    n_in + 2·pad) over x zero-padded by ``pad`` rows on each side."""
    xp = torch.nn.functional.pad(x, (0, 0, pad, pad))
    return torch.einsum("uoi,biu->bou", W, xp)


def _scatter_rows_T(y: torch.Tensor, W: torch.Tensor, n_in: int, pad: int) -> torch.Tensor:
    """Exact transpose of :func:`_gather_rows`: the same weights contracted
    over the output axis, then the pad rows sliced off."""
    return torch.einsum("uoi,bou->biu", W, y)[:, pad:pad + n_in]


def _flat(x: torch.Tensor):
    """x (..., R, C) → (B, R, C) in the working dtype, and the restorer."""
    lead, dt = x.shape[:-2], x.dtype
    flat = x.reshape((-1,) + tuple(x.shape[-2:])).to(_work_dtype(x))
    return flat, lambda y: y.reshape(lead + y.shape[1:]).to(dt)


def fan_project(plan: FanPlan, image: torch.Tensor, project=None) -> torch.Tensor:
    """Fan-beam forward projection. image (..., N, N) → (..., n_beta, n_u).
    ``project``: the backing parallel projection (by default
    :func:`parallel_project` on ``plan.par_plan``)."""
    meta = plan.meta
    f, restore = _flat(image)
    wdt = f.dtype
    project = project or functools.partial(parallel_project, plan.par_plan)
    p_par = project(f)                                              # (B, n_ext, S_par)
    q = torch.matmul(p_par, plan.Ms.to(wdt))                        # detector resample
    return restore(_gather_rows(q, plan.band("fwd", wdt), meta["pad_beta"]))


def fan_backproject(plan: FanPlan, sino: torch.Tensor, backproject=None) -> torch.Tensor:
    """Exact transpose of :func:`fan_project`. sino (..., n_beta, n_u) → (..., N, N).
    ``backproject``: the transpose of ``fan_project``'s ``project``."""
    meta = plan.meta
    p, restore = _flat(sino)
    wdt = p.dtype
    q_t = _scatter_rows_T(p, plan.band("fwd", wdt), meta["n_ext"], meta["pad_beta"])
    p_par = torch.matmul(q_t, plan.Ms.to(wdt).T)
    backproject = backproject or functools.partial(parallel_backproject, plan.par_plan)
    return restore(backproject(p_par))


def fan_rebin_to_parallel(plan: FanPlan, sino: torch.Tensor) -> torch.Tensor:
    """Estimate the extended parallel sinogram from fan data (FBP path):
    (..., n_beta, n_u) → (..., n_ext, S_par)."""
    meta = plan.meta
    p, restore = _flat(sino)
    wdt = p.dtype
    if meta["full_circle"]:
        # periodic β: wrap rows instead of zero-padding
        pad = meta["pad_ext"]
        p = torch.cat([p[:, -pad:], p, p[:, :pad]], dim=1)
        row_pad = 2
    else:
        row_pad = meta["pad_ext"]
    q = torch.matmul(p, plan.Mu.to(wdt))
    return restore(_gather_rows(q, plan.band("rebin", wdt), row_pad))


def make_fan_ops(geom: FanGeometry, dtype=torch.float32, device="cuda",
                 mesh=None) -> RadonOps:
    """Differentiable fan-beam operator bundle for ``geom`` (the parallel
    bundle's interface; ``plan`` is the :class:`FanPlan`). ``dtype`` is the
    backing projector's operand type (float32 or bfloat16); inputs and
    outputs keep the caller's dtype. ``mesh``: the backing projector is
    angle-sharded over the mesh's angle axis (``plan_projector``); the
    rebinning stays whole on every rank. vjp(A) = A† and vjp(A†) = A
    exactly (every factor transposes exactly)."""
    plan = build_fan_plan(geom, dtype=dtype, device=device)
    ds = plan.par_plan.geom.det_spacing
    backing = plan_projector(plan.par_plan, mesh)
    pair = (lambda f: fan_project(plan, f, backing[0]),
            lambda p: fan_backproject(plan, p, backing[1]))

    def A(f):
        return _Project.apply(f, *pair)

    def At(p):
        return _Backproject.apply(p, *pair)

    def fbp(p, filter_name: str = "ramp"):
        p_ext = fan_rebin_to_parallel(plan, p)
        filt = filter_sinogram(p_ext, ds, filter_name) * plan.wrow[:, None].to(p_ext.dtype)
        return _Backproject.apply(filt, *backing)

    return RadonOps(
        A=A,
        At=At,
        fbp=fbp,
        geom=geom,
        image_shape=(geom.image_size, geom.image_size),
        sino_shape=(geom.n_angles, geom.det_count),
        plan=plan,
    )
