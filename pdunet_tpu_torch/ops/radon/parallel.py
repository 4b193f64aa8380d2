"""Parallel-beam Radon forward / adjoint (port of ``pdunet_tpu/ops/radon/parallel.py``).

``parallel_project`` / ``parallel_backproject`` run the factored DFT-domain
pipeline of :mod:`pdunet_tpu_torch.geometry` through the projector kernels
(``cuda_kernels.py``): the mirror-pair kernels when the plan pairs its
angles (``meta["use_pairs"]``), the per-angle kernels otherwise; the CUDA
kernels for CUDA tensors, their plain PyTorch versions for CPU tensors.
Each pair is an exact transpose, so ``make_parallel_ops`` pairs them as
each other's gradient.

On a CUDA tensor both kernel families run on the tensor cores and read the
plan's trig tables: with bf16 operands ``build_pair_tables`` into
``plan.pair_tables`` and ``build_group_tables`` into ``plan.group_tables``;
with float32 operands, for the split-bf16 route, ``build_pair_split_tables``
into ``plan.pair_split_tables`` and ``build_group_split_tables`` into
``plan.group_split_tables``. Each is built on the card at the plan's first
such call, one per angle group, and kept on the plan for every later call.

Shapes: images ``(..., N, N)`` (row j ↦ +y, column i ↦ +x), sinograms
``(..., A, S)``.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import torch

from pdunet_tpu_torch.geometry import ParallelGeometry, ParallelPlan, build_parallel_plan
from pdunet_tpu_torch.ops.radon.cuda_kernels import (
    backproject_group,
    backproject_pair_group,
    build_group_split_tables,
    build_group_tables,
    build_pair_split_tables,
    build_pair_tables,
    project_group,
    project_pair_group,
)
from pdunet_tpu_torch.ops.radon.filtering import filter_sinogram

__all__ = ["parallel_project", "parallel_backproject", "plan_projector", "make_parallel_ops",
           "RadonOps"]

_CDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _work(x: torch.Tensor, plan: ParallelPlan):
    """Working dtype and plan-array caster: float64 stays float64 (CPU
    plain path, used by gradcheck), everything else computes in float32."""
    wdt = torch.float64 if x.dtype == torch.float64 else torch.float32
    return wdt, (lambda name: getattr(plan, name).to(wdt))


def _pair_args(arr, grp):
    return tuple(arr(f"pair_{nm}_{grp}") for nm in ("pos", "sha", "shb", "sgn"))


def _tables(plan: ParallelPlan, grp: str, x: torch.Tensor, cdt):
    """The angle group's trig tables for the tensor-core routes (CUDA), made
    once per plan: the pair kernels' on a plan that pairs, else the
    per-angle kernels'; the bf16 route's, or the split-bf16 route's for
    float32 operands. None on the CPU, where the plain versions make their
    own trig."""
    if x.device.type != "cuda":
        return None
    split = cdt != torch.bfloat16
    if plan.meta["use_pairs"]:
        store, build = ((plan.pair_split_tables, build_pair_split_tables) if split
                        else (plan.pair_tables, build_pair_tables))
        rows = tuple(getattr(plan, f"pair_{nm}_{grp}") for nm in ("pos", "sha", "shb"))
    else:
        store, build = ((plan.group_split_tables, build_group_split_tables) if split
                        else (plan.group_tables, build_group_tables))
        rows = (getattr(plan, f"pos_{grp}"), getattr(plan, f"shift_{grp}"))
    if grp not in store:
        with torch.no_grad():
            store[grp] = build(*rows, plan.spec, plan.meta["S_ext"])
    return store[grp]


def parallel_project(plan: ParallelPlan, image: torch.Tensor) -> torch.Tensor:
    """Factored parallel-beam forward projection. image (..., N, N) → (..., A, S)."""
    meta = plan.meta
    L = meta["S_ext"]
    cdt = _CDT[meta["compute_dtype"]]
    batch_shape = image.shape[:-2]
    wdt, arr = _work(image, plan)
    f = image.reshape((-1,) + tuple(image.shape[-2:])).to(wdt).contiguous()
    spec, Wc, Ws = arr("spec"), arr("Wc"), arr("Ws")
    pairs = meta["use_pairs"]
    parts = []
    for grp, contract_x in (("x", True), ("y", False)):
        if pairs and meta[f"P_{grp}"]:
            parts.append(project_pair_group(
                f, *_pair_args(arr, grp), spec, Wc, Ws, L, contract_x, cdt,
                tables=_tables(plan, grp, f, cdt)))
        elif not pairs and meta[f"A_{grp}"]:
            parts.append(project_group(
                f, arr(f"pos_{grp}"), arr(f"shift_{grp}"), spec, Wc, Ws, L,
                contract_x, cdt, tables=_tables(plan, grp, f, cdt)))
    p = torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]
    p = p.index_select(1, plan.index("pair_inv_perm" if pairs else "inv_perm"))
    return p.reshape(batch_shape + p.shape[1:]).to(image.dtype)


def parallel_backproject(plan: ParallelPlan, sino: torch.Tensor) -> torch.Tensor:
    """Exact transpose of :func:`parallel_project`. sino (..., A, S) → (..., N, N)."""
    meta = plan.meta
    N, L = meta["N"], meta["S_ext"]
    cdt = _CDT[meta["compute_dtype"]]
    batch_shape = sino.shape[:-2]
    wdt, arr = _work(sino, plan)
    p = sino.reshape((-1,) + tuple(sino.shape[-2:])).to(wdt)
    spec, Wc, Ws = arr("spec"), arr("Wc"), arr("Ws")
    pairs = meta["use_pairs"]
    f = None
    for grp, contract_x in (("x", True), ("y", False)):
        if pairs and meta[f"P_{grp}"]:
            pg = p.index_select(1, plan.index(f"pair_take_{grp}"))
            part = backproject_pair_group(
                pg, *_pair_args(arr, grp), arr(f"pair_msk_{grp}"), spec, Wc, Ws,
                L, contract_x, N, cdt, tables=_tables(plan, grp, pg, cdt))
        elif not pairs and meta[f"A_{grp}"]:
            pg = p.index_select(1, plan.index(f"idx_{grp}"))
            part = backproject_group(
                pg, arr(f"pos_{grp}"), arr(f"shift_{grp}"), spec, Wc, Ws, L,
                contract_x, N, cdt, tables=_tables(plan, grp, pg, cdt))
        else:
            continue
        f = part if f is None else f + part
    return f.reshape(batch_shape + f.shape[1:]).to(sino.dtype)


class _Project(torch.autograd.Function):
    """A = ``project`` with vjp(A) = ``backproject``, its exact transpose
    (the factored stages transpose weight for weight, whole or sharded)."""

    @staticmethod
    def forward(ctx, f, project, backproject):
        ctx.backproject = backproject
        return project(f)

    @staticmethod
    def backward(ctx, g):
        return ctx.backproject(g), None, None


class _Backproject(torch.autograd.Function):
    """A† = ``backproject`` with vjp(A†) = ``project``."""

    @staticmethod
    def forward(ctx, p, project, backproject):
        ctx.project = project
        return backproject(p)

    @staticmethod
    def backward(ctx, g):
        return ctx.project(g), None, None


def plan_projector(plan: ParallelPlan, mesh=None) -> tuple:
    """(A, A†) of ``plan`` as functions of one tensor: :func:`parallel_project`
    and :func:`parallel_backproject`, or with ``mesh`` (a
    ``parallel.sharding.Mesh``) their versions angle-sharded over its angle
    axis (``parallel/angle_shard.py``)."""
    if mesh is None:
        return (functools.partial(parallel_project, plan),
                functools.partial(parallel_backproject, plan))
    from pdunet_tpu_torch.parallel.angle_shard import (
        angle_sharded_backproject,
        angle_sharded_project,
    )

    return (functools.partial(angle_sharded_project, plan, mesh=mesh),
            functools.partial(angle_sharded_backproject, plan, mesh=mesh))


class RadonOps(NamedTuple):
    """Differentiable operator bundle handed to models."""

    A: Callable[[torch.Tensor], torch.Tensor]        # image → sinogram
    At: Callable[[torch.Tensor], torch.Tensor]       # sinogram → image (adjoint)
    fbp: Callable[..., torch.Tensor]                 # sinogram → image (filtered)
    geom: object
    image_shape: tuple
    sino_shape: tuple
    plan: ParallelPlan


def make_parallel_ops(geom: ParallelGeometry, dtype=torch.float32,
                      device="cuda", mesh=None) -> RadonOps:
    """Build the differentiable parallel-beam operator bundle for ``geom``.

    ``dtype`` is the projector's operand type (float32 or bfloat16); its
    inputs and outputs keep the caller's dtype. ``mesh``: the bundle is
    angle-sharded over the mesh's angle axis (:func:`plan_projector`);
    every rank of that axis calls it on the same batch.
    """
    plan = build_parallel_plan(geom, dtype=dtype, device=device)
    pair = plan_projector(plan, mesh)

    def A(f):
        return _Project.apply(f, *pair)

    def At(p):
        return _Backproject.apply(p, *pair)

    n_angles = len(geom.angles)
    # FBP scale: f ≈ (π/A)·Σ_a BP_a(ramp ⊛ p), and At carries the δp²/δs
    # mass factor of the forward model, hence the δs/δp² here.
    bp_scale = math.pi / n_angles * geom.det_spacing / (geom.pixel_spacing ** 2)

    def fbp(p, filter_name: str = "ramp"):
        return bp_scale * At(filter_sinogram(p, geom.det_spacing, filter_name))

    return RadonOps(
        A=A,
        At=At,
        fbp=fbp,
        geom=geom,
        image_shape=(geom.image_size, geom.image_size),
        sino_shape=(n_angles, geom.det_count),
        plan=plan,
    )
