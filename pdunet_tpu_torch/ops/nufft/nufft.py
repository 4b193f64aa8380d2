"""Kaiser-Bessel gridding NUFFT, type 2 (forward) and type 1 (adjoint)
(port of the device half of ``pdunet_tpu/ops/nufft/nufft.py``).

The golden-angle trajectory is static per geometry, so everything that does
not depend on the data is built once on the host in numpy (float64):
the J×J Kaiser-Bessel taps of every k-space sample on the σ-oversampled
G×G grid, the image-domain deapodisation, and the density compensation
(``dcf.py``'s ``_plan_tables`` and ``resolve_dcf``, shared with the
Pipe-Menon solver, whose numpy twins ``_np_nufft_forward`` /
``_np_nufft_adjoint`` compute the same two maps in float64).

On the device the forward is: deapodise → zero-pad to G×G → FFT2 → gather
of every sample's J² taps (``index_select`` on the flattened grid) → tap
sum. The adjoint is its exact transpose: taps → grid sum → IFFT2·G² → crop
→ deapodise. The grid sum is a segment sum over taps sorted by grid cell
at plan build (``torch.segment_reduce`` on a real view), so every cell adds
its taps in one fixed order: the adjoint is bitwise repeatable on a card,
where ``index_add_`` adds with atomics in whatever order they land.

Conventions: images (..., N, N) complex, k-space (..., n_spokes, n_samples)
complex, k in radians per pixel with |k| ≤ π, and
A(f)[m] ≈ Σ_x f[x]·e^{−i k_m·(x−c)} with the image centred on index N//2.
"""

from __future__ import annotations

import numpy as np
import torch

from pdunet_tpu_torch.geometry import RadialGeometry
from pdunet_tpu_torch.ops.nufft.dcf import _plan_tables, resolve_dcf
from pdunet_tpu_torch.ops.nufft.fourier_slice import _complex_dtype

__all__ = ["NufftPlan", "build_nufft_plan", "nufft_forward", "nufft_adjoint"]


class NufftPlan:
    """Gridding plan on one device: ``idx`` (n_pts·J²,) int64 taps into the
    flattened G×G grid, ``w`` (n_pts, J²) float32 tap weights, ``apod2d``
    (N, N) float32, ``dcf`` (n_spokes, n_samples) float32, and the adjoint's
    segment tables: the taps in grid-cell order as their sample
    (``seg_point``) and weight (``seg_w``), and each cell's tap count
    (``seg_len``, (G²,))."""

    def __init__(self, geom, meta, idx, w, apod2d, dcf, seg_point, seg_w, seg_len):
        self.geom = geom
        self.meta = meta
        self.idx, self.w, self.apod2d, self.dcf = idx, w, apod2d, dcf
        self.seg_point, self.seg_w, self.seg_len = seg_point, seg_w, seg_len


_PLANS: dict = {}


def build_nufft_plan(geom: RadialGeometry, dcf: str = "pipe_menon",
                     device="cuda") -> NufftPlan:
    """The gridding plan of ``geom`` on ``device`` (``_plan_tables``' σ = 2
    grid and J = 4 taps), built once per (geometry, dcf, device) and then
    reused."""
    device = torch.device(device)
    key = (geom, dcf, str(device))
    if key in _PLANS:
        return _PLANS[key]
    T = _plan_tables(geom)
    J = T["J"]
    idx = T["idx"].ravel()
    # the adjoint's grid sum: taps sorted by grid cell (stable, so a cell's
    # taps keep the sample order), then one segment per cell
    order = np.argsort(idx, kind="stable")
    seg_len = np.bincount(idx, minlength=T["G"] ** 2)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a, dtype), device=device)

    meta = dict(N=T["N"], G=T["G"], J=J, n_spokes=T["n_sp"], n_samples=T["n_ro"])
    plan = NufftPlan(geom, meta, dev(idx, np.int64), dev(T["w"], np.float32),
                     dev(T["apod2d"], np.float32),
                     dev(resolve_dcf(geom, dcf), np.float32),
                     dev(order // (J * J), np.int64), dev(T["w"].ravel()[order], np.float32),
                     dev(seg_len, np.int64))
    _PLANS[key] = plan
    return plan


def _pad_center(f: torch.Tensor, N: int, G: int) -> torch.Tensor:
    lo = G // 2 - N // 2
    return torch.nn.functional.pad(f, (lo, G - N - lo, lo, G - N - lo))


def _crop_center(F: torch.Tensor, N: int, G: int) -> torch.Tensor:
    lo = G // 2 - N // 2
    return F[..., lo:lo + N, lo:lo + N]


def nufft_forward(plan: NufftPlan, image: torch.Tensor) -> torch.Tensor:
    """Type-2 NUFFT: (..., N, N) → (..., n_spokes, n_samples) complex."""
    m = plan.meta
    N, G, J = m["N"], m["G"], m["J"]
    batch = image.shape[:-2]
    cdt = _complex_dtype(image)
    f = image.to(cdt).reshape(-1, N, N) / plan.apod2d
    Fk = torch.fft.fftshift(
        torch.fft.fft2(torch.fft.ifftshift(_pad_center(f, N, G), dim=(-2, -1))),
        dim=(-2, -1))
    vals = Fk.reshape(f.shape[0], G * G).index_select(1, plan.idx)
    out = (vals.reshape(f.shape[0], -1, J * J) * plan.w).sum(-1)
    return out.reshape(batch + (m["n_spokes"], m["n_samples"]))


def _grid_sum(plan: NufftPlan, g: torch.Tensor) -> torch.Tensor:
    """(B, n_pts) complex samples → (B, G²) complex grid, each cell the sum
    of its taps w·g in one fixed order: the taps in cell order as a real
    view (taps, 2B), one segment per cell."""
    B, G = g.shape[0], plan.meta["G"]
    taps = g.t().index_select(0, plan.seg_point) * plan.seg_w[:, None]
    cells = torch.segment_reduce(torch.view_as_real(taps).reshape(taps.shape[0], 2 * B),
                                 "sum", lengths=plan.seg_len, axis=0, unsafe=True)
    return torch.view_as_complex(cells.reshape(G * G, B, 2)).t()


def nufft_adjoint(plan: NufftPlan, kdata: torch.Tensor) -> torch.Tensor:
    """Exact conjugate transpose of :func:`nufft_forward` (type-1 gridding)."""
    m = plan.meta
    N, G = m["N"], m["G"]
    batch = kdata.shape[:-2]
    g = kdata.to(_complex_dtype(kdata)).reshape(-1, m["n_spokes"] * m["n_samples"])
    grid = _grid_sum(plan, g).reshape(-1, G, G)
    f = torch.fft.fftshift(torch.fft.ifft2(torch.fft.ifftshift(grid, dim=(-2, -1))),
                           dim=(-2, -1)) * (G * G)
    f = _crop_center(f, N, G) / plan.apod2d
    return f.reshape(batch + (N, N))
