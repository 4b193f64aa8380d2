"""Angle-axis sharding of the projector (port of
``pdunet_tpu/parallel/angle_shard.py``).

The sinogram's angle rows are independent in the forward: each rank of the
mesh's angle axis projects its own block of the plan's rows and the blocks
are gathered (an ``all_gather``); the adjoint is a partial image per rank
summed over the axis (an ``all_reduce``), the ``psum`` of the JAX package.

A plan that pairs its angles shards the PAIR axis, so θ and its mirror stay
on one rank and share stage 1; a plan that does not shards the angle axis.
Each angle group (x- and y-primary) is sharded on its own: rank r of G holds
units [r·n, (r+1)·n) with n = ceil(units / G), the last blocks zero-padded.
A pad unit has pos = shift = 0, sign +1 and mask 0; its forward rows are
dropped after the gather, and its adjoint reads a zero sinogram row. The
blocks reassemble through the full plan's inverse permutation.

:func:`shard_plan` makes each rank's block a ``ParallelPlan`` of its own,
once per plan and shard, with its own trig-table stores, so
``parallel_project`` / ``parallel_backproject`` run the kernels of
``ops/radon/cuda_kernels.py`` on it (their plain versions on the CPU) and
the kernels read only the shard's rows.

The operator bundles take a mesh (``make_parallel_ops`` / ``make_fan_ops``
/ ``make_radial_ops(mesh=...)``, through ``plan_projector``), and their
``fbp`` runs the sharded adjoint; the fourier-slice plan, whose detector
axis is spectral, is only reached through the radial bundle, whose ``fbp``
is the density-compensated adjoint, so the JAX package's
``angle_sharded_fbp`` and its spectral-plan check have no counterpart here.

The batch is not sharded here: every rank of the angle axis calls the
operator on the same local batch (the rows of its data shard), so the
operators need no batch padding, unlike ``padded_batch_caller`` under
``shard_map``.
"""

from __future__ import annotations

import math
import weakref

import torch
import torch.distributed as dist
import torch.nn.functional as F

from pdunet_tpu_torch.geometry import ParallelPlan
from pdunet_tpu_torch.ops.radon.parallel import parallel_backproject, parallel_project
from pdunet_tpu_torch.parallel.sharding import ANGLE

__all__ = ["shard_plan", "angle_sharded_project", "angle_sharded_backproject"]

#: each plan's shards by (shard count, index)
_SHARDS = weakref.WeakKeyDictionary()


def _layout(plan: ParallelPlan):
    """The per-unit plan fields with their pad values, the sinogram rows of
    one unit, and the meta keys of the unit counts, of each group's
    sinogram rows and of the inverse permutation: of pairs on a plan that
    pairs, else of angles."""
    if plan.meta["use_pairs"]:
        return ((("pair_pos", 0.0), ("pair_sha", 0.0), ("pair_shb", 0.0), ("pair_sgn", 1.0),
                 ("pair_msk", 0.0)), 2, "P_", "pair_take_", "pair_inv_perm")
    return (("pos", 0.0), ("shift", 0.0)), 1, "A_", "idx_", "inv_perm"


def shard_plan(plan: ParallelPlan, n_shards: int, index: int) -> ParallelPlan:
    """Shard ``index`` of ``n_shards`` of ``plan``, made once per plan and
    shard: a plan of its block of each angle group's units, padded to
    ceil(units / n_shards). Its inverse permutation and group rows are the
    identity, so ``parallel_project`` on it gives its rows in kernel order
    and ``parallel_backproject`` reads them in that order. ``meta["take"]``:
    the full plan's sinogram row of each of its rows (A, past the last,
    for a pad row); ``meta["gather"]``: the row of each of the full plan's
    sinogram rows in the ``n_shards`` shards' outputs, concatenated in
    shard order."""
    shards = _SHARDS.setdefault(plan, {})
    if (n_shards, index) in shards:
        return shards[(n_shards, index)]
    fields, per, count, take_key, perm_key = _layout(plan)
    n_local = {g: math.ceil(plan.meta[count + g] / n_shards) for g in "xy"}
    rows_local = per * sum(n_local.values())
    meta, arrays, take, where = dict(plan.meta), {}, [], []
    local_off = 0  # the group's first kernel row in a shard
    for grp in "xy":
        n, nl = plan.meta[count + grp], n_local[grp]
        lo, hi = min(index * nl, n), min((index + 1) * nl, n)
        for name, fill in fields:
            a = getattr(plan, f"{name}_{grp}")
            pad = a.new_full((nl - (hi - lo),) + tuple(a.shape[1:]), fill)
            arrays[f"{name}_{grp}"] = torch.cat([a[lo:hi], pad])
        take += plan.meta[take_key + grp][per * lo:per * hi]
        take += (len(plan.meta[perm_key]),) * (per * (nl - (hi - lo)))
        # the group's kernel row j of the plan lies in shard j // (per·nl)
        where += [s * rows_local + local_off + k
                  for s, k in (divmod(j, per * nl) for j in range(per * n))]
        meta[count + grp] = nl
        meta[take_key + grp] = tuple(range(local_off, local_off + per * nl))
        local_off += per * nl
    meta[perm_key] = tuple(range(rows_local))
    meta["take"] = tuple(take)
    meta["gather"] = tuple(where[k] for k in plan.meta[perm_key])
    shard = ParallelPlan(plan.geom, meta,
                         *(arrays.get(name, getattr(plan, name))
                           for name in ParallelPlan.ARRAY_FIELDS))
    shards[(n_shards, index)] = shard
    return shard


def _my_shard(plan: ParallelPlan, mesh) -> ParallelPlan:
    return shard_plan(plan, mesh.size(ANGLE), mesh.coord(ANGLE))


def angle_sharded_project(plan: ParallelPlan, image: torch.Tensor, mesh) -> torch.Tensor:
    """Forward projection with ``plan``'s rows sharded over the angle axis
    of ``mesh``: each rank projects its shard, then one ``all_gather`` over
    the axis. image (..., N, N) → (..., A, S), the same on every rank of
    the axis."""
    shard = _my_shard(plan, mesh)
    local = parallel_project(shard, image)
    local = local.reshape((-1,) + tuple(local.shape[-2:])).contiguous()
    blocks = [torch.empty_like(local) for _ in range(mesh.size(ANGLE))]
    dist.all_gather(blocks, local, group=mesh.group(ANGLE))
    p = torch.cat(blocks, dim=1).index_select(1, shard.index("gather"))
    return p.reshape(image.shape[:-2] + p.shape[1:])


def angle_sharded_backproject(plan: ParallelPlan, sino: torch.Tensor, mesh) -> torch.Tensor:
    """Adjoint with ``plan``'s rows sharded over the angle axis of
    ``mesh``: each rank backprojects its shard's rows of ``sino`` (the same
    sinogram on every rank of the axis), then one ``all_reduce`` sums the
    partial images (in float32 at least). sino (..., A, S) → (..., N, N)."""
    shard = _my_shard(plan, mesh)
    p = sino.reshape((-1,) + tuple(sino.shape[-2:]))
    p = p.to(torch.promote_types(p.dtype, torch.float32))
    # a pad row reads the zero row appended past the last
    f = parallel_backproject(shard, F.pad(p, (0, 0, 0, 1)).index_select(1, shard.index("take")))
    dist.all_reduce(f, group=mesh.group(ANGLE))
    return f.reshape(sino.shape[:-2] + f.shape[1:]).to(sino.dtype)
