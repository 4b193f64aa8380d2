"""Device meshes over ``torch.distributed``, batch shards and the
collectives of the batch-sharded train step (port of
``pdunet_tpu/parallel/sharding.py``; the step is
``training.loop.make_train_step(task, mesh=...)``).

JAX runs one process over all the devices of a mesh; PyTorch runs one
process per rank (``parallel/launch.py`` starts them). A :class:`Mesh` is
the rank grid of shape (DATA, ANGLE), row-major like the JAX package's
device array, with one process group per axis line: the ranks that share
every other coordinate. The parameters are replicated (broadcast from rank
0), every rank draws the GLOBAL batch from the same generator and keeps its
data shard's rows, so a sharded step computes what the single-device step
computes; after the backward one ``all_reduce`` of the flattened gradients
over the data axis, divided by its size, stands for XLA's gradient ``psum``
(``training/loop.py``).

Backend: NCCL for ranks on CUDA cards, gloo for the CPU, unless the caller
names one. NCCL needs a card per rank; ranks that share a card run gloo,
which the caller asks for (``--dist-backend gloo``): gloo serves
``broadcast``, ``all_reduce``, ``all_gather`` and ``barrier`` on CUDA
tensors, the only collectives the port uses.
"""

from __future__ import annotations

import datetime
import itertools
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DATA", "ANGLE", "Mesh", "init_distributed", "make_mesh", "replicate",
           "shard_batch", "gather_batch", "mean_over", "all_reduce_grads"]

#: the mesh's axes: the batch is sharded over DATA, the projector's rows over ANGLE
DATA, ANGLE = "data", "angle"

#: default seconds a collective may wait before its process group fails it
DEFAULT_TIMEOUT_S = 1800.0


def init_distributed(device: str = "cuda", backend: Optional[str] = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group of this rank, from torchrun's environment
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``) and the
    rendezvous in ``PDUNET_INIT_METHOD`` (else ``env://``, torchrun's
    ``MASTER_ADDR`` / ``MASTER_PORT``). Returns the rank's device:
    ``cuda:(LOCAL_RANK % device_count)`` for ``device="cuda"``, else the CPU.

    ``backend``: "nccl" for CUDA and "gloo" for the CPU by default. NCCL
    with more ranks on the host than cards raises: ranks that share a card
    need ``backend="gloo"``, which is never chosen in NCCL's place."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", rank))
    dev = torch.device(device)
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        if n_cards == 0:
            raise RuntimeError("init_distributed(device='cuda') found no CUDA device")
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl":
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        if local_world > n_cards:
            raise RuntimeError(
                f"NCCL needs a CUDA card per rank: {local_world} ranks on this host, "
                f"{n_cards} card(s); ranks that share a card need the gloo backend "
                f"(--dist-backend gloo)")
    dist.init_process_group(backend, init_method=os.environ.get("PDUNET_INIT_METHOD", "env://"),
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


class Mesh:
    """This rank's place in the (DATA, ANGLE) grid of ``shape``: its
    coordinate on each axis, and the process group of the ranks that differ
    from it only on that axis."""

    def __init__(self, shape: Sequence[int], rank: int, groups: dict):
        self.shape = tuple(shape)
        self._size = dict(zip((DATA, ANGLE), self.shape))
        self._coord = dict(zip((DATA, ANGLE), np.unravel_index(rank, self.shape)))
        self._groups = groups
        self.rank = rank

    def size(self, axis: str) -> int:
        return self._size[axis]

    def coord(self, axis: str) -> int:
        return int(self._coord[axis])

    def group(self, axis: str):
        return self._groups[axis]


def make_mesh(n_devices: Optional[int] = None, shape: Optional[Sequence[int]] = None) -> Mesh:
    """A (DATA, ANGLE) mesh over the ``n_devices`` ranks of the initialised
    process group (all of them by default): ``shape`` = (D, G), by default
    (n_devices, 1). Every rank calls it, in the same order as every other
    collective."""
    n = dist.get_world_size() if n_devices is None else n_devices
    shape = (n, 1) if shape is None else tuple(shape)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} needs {np.prod(shape)} devices, have {n}")
    world = dist.get_world_size()
    if n != world:
        raise ValueError(f"a mesh of {n} devices needs a process group of {n} ranks, "
                         f"not {world}")
    rank = dist.get_rank()
    grid = np.arange(n).reshape(shape)
    groups = {}
    for k, axis in enumerate((DATA, ANGLE)):
        lines = np.moveaxis(grid, k, -1).reshape(-1, shape[k])
        for line in lines:  # every rank creates every group, in one order
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return Mesh(shape, rank, groups)


def replicate(module: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0 to every
    rank of ``mesh``, in place, then check that all ranks hold the same
    values (each rank's sum of every tensor, gathered)."""
    tensors = list(itertools.chain(module.parameters(), module.buffers()))
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t.data, src=0)
        sums = torch.stack([t.detach().double().sum() for t in tensors])
        everyone = [torch.empty_like(sums) for _ in range(dist.get_world_size())]
        dist.all_gather(everyone, sums)
    for r, other in enumerate(everyone):
        if not torch.equal(other, sums):
            raise RuntimeError(f"replicate: rank {r}'s parameters differ from rank "
                               f"{mesh.rank}'s after the broadcast")
    return module


def shard_batch(batch, mesh: Mesh):
    """This rank's rows [r·B/D, (r+1)·B/D) of every leaf of a global
    ``batch`` (a tensor, or a dict / tuple / list of them), r its DATA
    coordinate."""
    D, r = mesh.size(DATA), mesh.coord(DATA)
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    B = batch.shape[0]
    if B % D:
        raise ValueError(f"batch of {B} not divisible by the {D} devices of the data axis")
    return batch[r * (B // D):(r + 1) * (B // D)]


def gather_batch(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global batch from every rank's rows, in DATA order (the inverse
    of :func:`shard_batch`), on every rank."""
    parts = [torch.empty_like(x) for _ in range(mesh.size(DATA))]
    dist.all_gather(parts, x.contiguous(), group=mesh.group(DATA))
    return torch.cat(parts, dim=0)


def mean_over(values: dict, mesh: Mesh) -> dict:
    """The mean over the DATA axis of each 0-d tensor in ``values``, one
    ``all_reduce`` for all of them."""
    if not values:
        return {}
    keys = list(values)
    stacked = torch.stack([values[k].detach().float() for k in keys])
    dist.all_reduce(stacked, group=mesh.group(DATA))
    stacked /= mesh.size(DATA)
    return dict(zip(keys, stacked.unbind()))


def all_reduce_grads(params, mesh: Mesh) -> None:
    """Average the ``.grad`` of ``params`` over the DATA axis, in place: one
    ``all_reduce`` of the flattened gradients per dtype, divided by the
    axis size (XLA's gradient ``psum`` over the data axis, of a loss that
    is a mean over the global batch)."""
    by_dtype = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.group(DATA))
        flat /= mesh.size(DATA)
        for g, v in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(v.view_as(g))
