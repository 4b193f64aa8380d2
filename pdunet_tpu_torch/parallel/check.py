"""Checks of the sharded paths, run as the ranks of a launch:

    python -m pdunet_tpu_torch.parallel.check JOB.pt

``JOB.pt`` (``torch.save``; loaded with ``weights_only``) holds ``device``
("cpu" or "cuda"), ``backend`` (None: NCCL on CUDA, gloo on the CPU),
``timeout_s``, ``threads`` (``torch.set_num_threads`` when given), ``out``
(a directory) and ``cases``, a list of dicts, each run in order by every
rank on its own (data, angle) mesh of the world:

* ``kind="ops"``: the operator bundle of ``geometry`` (``{"kind":
  "parallel" | "fan" | "radial", **fields}``) in ``dtype`` angle-sharded over
  ``mesh`` = (D, G), on the global inputs ``x`` (images) and ``y``
  (sinograms or k-space), each rank on its data shard's rows: ``A(x)``,
  ``At(y)``, ``fbp(y)``, and the vjps ∂⟨A x, y⟩/∂x and ∂⟨At y, x⟩/∂y,
  gathered to global order; the kernel launches (CUDA) and the row counts
  of the shard plans' trig tables; with ``time=True`` the CUDA-event
  milliseconds of one sharded A and At;
* ``kind="step"``: ``steps`` batch-sharded train steps of ``config`` (an
  ``ExperimentConfig`` as JSON) over ``mesh`` = (D, G) (G > 1: the task's
  operators angle-sharded), from the weights of ``init_seed`` with SGD at
  ``lr`` (no clip: linear in the gradient, so the sharded step must equal
  the single-device one), each step's batch drawn from a generator seeded
  with ``seed`` + step (with ``images``: the batch made noiselessly from
  those global ground-truth images, ``task.batch_from_images``, each
  step): the metrics of each step, σ, the parameters after
  the first step, the launches of the last step, and the host
  milliseconds of the steps after the first;
* ``kind="loss"``: ``task.loss_fn`` of ``config`` over ``mesh`` on the
  global ``batch`` with the weights ``state_dict`` (σ's power iteration
  from ``opnorm_x0`` when given), averaged over the data axis.

Rank r writes ``out/rank<r>.pt``: ``{case name: results}``.
"""

from __future__ import annotations

import os
import pathlib
import sys
import time

import torch
import torch.distributed as dist

from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
from pdunet_tpu_torch.parallel.angle_shard import shard_plan
from pdunet_tpu_torch.parallel.sharding import (
    ANGLE,
    DATA,
    gather_batch,
    init_distributed,
    make_mesh,
    mean_over,
    replicate,
    shard_batch,
)

__all__ = ["run_job"]

_WRAPPERS = ("project_pair_group", "backproject_pair_group", "project_group",
             "backproject_group")


def _launch_counts() -> dict:
    """Each projector wrapper's (launches, bf16 tensor-core, split-bf16)."""
    return {name: (getattr(ck, name).launches, getattr(ck, name).launches_tc,
                   getattr(ck, name).launches_split) for name in _WRAPPERS}


def _geometry(spec: dict):
    from pdunet_tpu_torch.geometry import FanGeometry, ParallelGeometry, RadialGeometry

    spec = dict(spec)
    kind = spec.pop("kind")
    if "angles" in spec:
        spec["angles"] = tuple(spec["angles"])
    return kind, {"parallel": ParallelGeometry, "fan": FanGeometry,
                  "radial": RadialGeometry}[kind](**spec)


def _backing_plan(ops):
    """The parallel plan the kernels run on: the fan's and the
    fourier-slice path's backing plan, or the parallel bundle's own."""
    return getattr(ops.plan, "par_plan", ops.plan)


def _table_rows(plan, mesh) -> dict:
    """The pair (or angle) rows of each trig table built on this rank's
    shard of ``plan`` (dimension 1 of the bf16 route's table and of the
    split route's T̂)."""
    G, r = mesh.size(ANGLE), mesh.coord(ANGLE)
    sp = shard_plan(plan, G, r)
    out = {}
    for store in ("pair_tables", "pair_split_tables", "group_tables", "group_split_tables"):
        for grp, tabs in getattr(sp, store).items():
            t = tabs if torch.is_tensor(tabs) else tabs[0]
            out[f"G{G}r{r}/{store}/{grp}"] = int(t.shape[1])
    return out


def _cuda_ms(fn, iters=5):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _ops_case(case, dev):
    from pdunet_tpu_torch.ops.nufft import make_radial_ops
    from pdunet_tpu_torch.ops.radon.fan import make_fan_ops
    from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

    kind, geom = _geometry(case["geometry"])
    D, G = case["mesh"]
    mesh = make_mesh(D * G, shape=(D, G))
    dtype = getattr(torch, case.get("dtype", "float32"))
    make = {"parallel": make_parallel_ops, "fan": make_fan_ops, "radial": make_radial_ops}[kind]
    ops = make(geom, dtype=dtype, device=dev, mesh=mesh)
    x = shard_batch(case["x"].to(dev), mesh)
    y = shard_batch(case["y"].to(dev), mesh)
    ck.reset_launch_counts()
    with torch.no_grad():
        out = {"A": ops.A(x), "At": ops.At(y), "fbp": ops.fbp(y)}
    counts = _launch_counts()
    xg, yg = x.clone().requires_grad_(), y.clone().requires_grad_()
    # ⟨A x, y⟩ real part: ∂/∂x = A†y (conj-linear in PyTorch's convention)
    torch.real(torch.sum(ops.A(xg) * y.conj())).backward()
    torch.real(torch.sum(ops.At(yg) * x.conj())).backward()
    out.update(vjp_A=xg.grad, vjp_At=yg.grad)
    res = {k: gather_batch(v.detach(), mesh).cpu() for k, v in out.items()}
    res.update(launches=counts, table_rows=_table_rows(_backing_plan(ops), mesh),
               mesh=(D, G), coords=(mesh.coord(DATA), mesh.coord(ANGLE)))
    if case.get("time") and dev.type == "cuda":
        with torch.no_grad():
            res["ms"] = {"A": _cuda_ms(lambda: ops.A(x)), "At": _cuda_ms(lambda: ops.At(y))}
    return res


def _config(case):
    from pdunet_tpu_torch.configs import ExperimentConfig

    return ExperimentConfig.from_json(case["config"])


def _step_case(case, dev):
    from pdunet_tpu_torch.training.loop import TrainState, make_train_step
    from pdunet_tpu_torch.training.tasks import build_task

    D, G = case["mesh"]
    mesh = make_mesh(D * G, shape=(D, G))
    task = build_task(_config(case), device=dev, mesh=mesh if G > 1 else None)
    task.init_params(torch.Generator().manual_seed(case["init_seed"]))
    replicate(task.model, mesh)
    lr = case["lr"]
    state = TrainState(task.model, torch.optim.SGD(task.model.parameters(), lr=lr),
                       lambda i: lr)
    images = case.get("images")
    step = make_train_step(task, from_images=images is not None, mesh=mesh)
    res = {"metrics": [], "sigma": task.sigma, "mesh": (D, G), "host_ms": []}
    for i in range(case.get("steps", 1)):
        x = (images.to(dev) if images is not None
             else torch.Generator(device=dev).manual_seed(case["seed"] + i))
        ck.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = step(state, x)
        metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
        if i:
            res["host_ms"].append((time.perf_counter() - t0) * 1e3)
        res["metrics"].append(metrics)
        if i == 0:
            res["params"] = {k: v.detach().cpu().clone()
                             for k, v in task.model.state_dict().items()}
    res["launches"] = _launch_counts()
    return res


def _loss_case(case, dev):
    from pdunet_tpu_torch.training.tasks import build_task

    D, G = case["mesh"]
    mesh = make_mesh(D * G, shape=(D, G))
    task = build_task(_config(case), device=dev, mesh=mesh if G > 1 else None,
                      opnorm_x0=case.get("opnorm_x0"))
    task.model.load_state_dict(case["state_dict"])
    batch = shard_batch({k: v.to(dev) for k, v in case["batch"].items()}, mesh)
    with torch.no_grad():
        loss, aux = task.loss_fn(task.model, batch)
    return {k: float(v) for k, v in mean_over({"loss": loss, **aux}, mesh).items()}


_CASES = {"ops": _ops_case, "step": _step_case, "loss": _loss_case}


def run_job(job: dict) -> dict:
    """Run ``job``'s cases in this rank (joined to its process group here)
    and return ``{case name: results}``."""
    if job.get("threads"):
        torch.set_num_threads(job["threads"])
    dev = init_distributed(job["device"], job.get("backend"), job.get("timeout_s", 600.0))
    try:
        return {case["name"]: _CASES[case["kind"]](case, dev) for case in job["cases"]}
    finally:
        dist.destroy_process_group()


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    job = torch.load(argv[0], weights_only=True)
    results = run_job(job)
    out = pathlib.Path(job["out"])
    out.mkdir(parents=True, exist_ok=True)
    torch.save(results, out / f"rank{os.environ['RANK']}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
