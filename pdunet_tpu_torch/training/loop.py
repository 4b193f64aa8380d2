"""The training loop of the PyTorch port (port of ``pdunet_tpu/training/loop.py``).

One step: the batch is drawn on the device (``task.make_batch``: phantoms,
the f32 measurement and the network's input) or, with ``train(data=...)``,
made from a file-backed batch of ground-truth images
(``task.batch_from_images``), and the loss runs the model (an
unroll with A/σ and A†/σ in the preset's dtype, or a UNet, whose sino task
adds an f32 FBP), the backward runs the same projector kernels again
(vjp(A) = A†, vjp(A†) = A), the gradients are clipped to a global norm, and
Adam steps with the step's learning rate. The host fetches the scalar
metrics only on log steps.

The optimizer is optax's, written out: ``adam`` (eps 1e-8 added to √v̂, as
``torch.optim.Adam`` does) behind ``clip_by_global_norm`` when
``grad_clip > 0``, with the warmup-cosine schedule evaluated at the update
count *before* it is incremented, so the first update uses lr(0) = 0 (it
moves no parameter but does update Adam's moments).

Random streams: JAX splits ``PRNGKey(seed)`` into init, data and
validation keys and folds the step index into the data key. Here
:func:`derive_seed` hashes ``(seed, stream)`` (and the step index) through
numpy's ``SeedSequence`` into the seed of a fresh ``torch.Generator``:
stream 1 draws the initial weights (on the CPU, so a seed gives the same
weights on every device), stream 2 step ``i``'s batch (seed ``(tc.seed, 2,
i)``), stream 3 validation batch ``j`` (``(tc.seed, 3, j)``). A noisy
preset (``photons_per_ray`` or ``kspace_snr_db`` > 0) draws its noise from
the same generator after the phantoms, in training and validation batches
alike, as the JAX task draws it from the batch's key. A resumed run
therefore replays the same batches, noise included, and ``fixed_data``
reuses step 0's.

File-backed data (``data=``, a slice store of ``data/datasets.py``): a
host thread (``HostPrefetcher``, two batches deep) reads shuffled batches
of the split (``iterate_batches(seed=train.seed)``); the step copies each
to the device, synthesises its measurement and draws the preset's noise
from the step's generator. Validation runs noiselessly on whole batches of
the ``val`` split (the first train batch when ``val`` holds less than one).

Meshes (``train(n_devices=D, angle_devices=G)``, in each of the D·G ranks
of a process group; ``python -m pdunet_tpu_torch.train --devices D
--angle-devices G`` starts them): a (data, angle) mesh of
``parallel/sharding.py``. Every rank draws (or reads) the global batch from
the same generator, synthesises it whole, and keeps its data shard's rows,
so the step equals the single-device one; the gradients are averaged over
the data axis before the optimizer, and the logged metrics too. With G > 1
the task's operators are angle-sharded (``parallel/angle_shard.py``).
Validation runs on every rank (the sharded operators need all of them), on
its rows of each batch. Only rank 0 writes the metrics file, checkpoints,
``best.json`` and TensorBoard; every rank restores a checkpoint.

TensorBoard (``tb_dir``): every logged scalar but ``step`` under its own
tag, and each validation scalar as ``val_<name>``, the tags of the JAX
package's clu writer.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import pathlib
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from pdunet_tpu_torch.configs import ExperimentConfig
from pdunet_tpu_torch.data.datasets import SliceDataset, iterate_batches
from pdunet_tpu_torch.data.native import HostPrefetcher
from pdunet_tpu_torch.ops.metrics import psnr, ssim
from pdunet_tpu_torch.parallel.sharding import (
    all_reduce_grads,
    make_mesh,
    mean_over,
    replicate,
    shard_batch,
)
from pdunet_tpu_torch.training.checkpoint import CheckpointManager
from pdunet_tpu_torch.training.tasks import Task, build_task
from pdunet_tpu_torch.utils import trace, watchdog
from pdunet_tpu_torch.utils.precision import exact_f32_conv

__all__ = ["train", "TrainResult", "TrainState", "make_train_step", "make_eval_step",
           "make_schedule", "build_optimizer", "build_state", "apply_gradients",
           "split_ms", "derive_seed",
           "INIT_STREAM", "DATA_STREAM", "VAL_STREAM"]

#: the three random streams derived from ``train.seed``
INIT_STREAM, DATA_STREAM, VAL_STREAM = 1, 2, 3


def derive_seed(seed: int, *path: int) -> int:
    """A 63-bit generator seed from ``seed`` and a stream path, e.g.
    ``derive_seed(tc.seed, DATA_STREAM, i)`` for step ``i``'s batch."""
    words = np.random.SeedSequence([seed, *path]).generate_state(2)
    return int(words[0]) << 31 | int(words[1]) >> 1


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def make_schedule(tc, n_steps: Optional[int] = None) -> Callable[[int], float]:
    """Learning rate of update ``i`` (0-based): optax's
    ``warmup_cosine_decay_schedule(0, peak, warmup, max(n, warmup + 1),
    0.01·peak)``, where ``n`` is the run's actual length ``n_steps`` (which
    ``--steps`` may set) rather than ``tc.steps``, so short runs still
    decay. Linear from 0 to the peak over the warmup, then a cosine to
    0.01·peak at step n, flat after. With no warmup the rate is constant."""
    peak = tc.learning_rate
    warmup = tc.warmup_steps
    if warmup <= 0:
        return lambda i: peak
    decay = max(tc.steps if n_steps is None else n_steps, warmup + 1) - warmup
    alpha = 0.01

    def lr(i: int) -> float:
        if i < warmup:
            return peak * i / warmup
        t = min(i - warmup, decay)
        return peak * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * t / decay)) + alpha)

    return lr


def build_optimizer(model: torch.nn.Module) -> torch.optim.Adam:
    """optax ``adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0); the train
    step sets its learning rate before every update."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8)


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the schedule and ``step``, the number of
    updates made (the schedule's argument for the next one)."""

    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Callable[[int], float]
    grad_clip: float = 0.0
    step: int = 0


def build_state(task: Task, n_steps: Optional[int] = None,
                init_seed: Optional[int] = None) -> TrainState:
    """Train state over ``task.model``, with its weights re-drawn from
    ``init_seed`` when one is given."""
    if init_seed is not None:
        task.init_params(torch.Generator().manual_seed(init_seed))
    tc = task.config.train
    return TrainState(task.model, build_optimizer(task.model), make_schedule(tc, n_steps),
                      tc.grad_clip)


def _clip_by_global_norm_(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm``, in place: when the global norm reaches
    ``max_norm`` every gradient is scaled by max_norm / norm (no +1e-6, as
    ``torch.nn.utils.clip_grad_norm_`` adds), else left as it is. Returns
    the norm before clipping. ``max_norm <= 0`` only measures. No host
    synchronisation."""
    norm = torch.nn.utils.get_total_norm(grads)
    if max_norm > 0:
        scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
        torch._foreach_mul_(grads, scale)
    return norm


def apply_gradients(state: TrainState) -> torch.Tensor:
    """One optimizer update from the parameters' ``.grad``: clip to
    ``state.grad_clip``, Adam at ``state.schedule(state.step)``, then count
    the update. Returns the gradients' global norm before clipping."""
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    norm = _clip_by_global_norm_(grads, state.grad_clip)
    for group in state.optimizer.param_groups:
        group["lr"] = state.schedule(state.step)
    state.optimizer.step()
    state.step += 1
    return norm


def make_train_step(task: Task, from_images: bool = False, mesh=None):
    """The train step ``step(state, x, marks=None, generator=None) -> metrics``.

    Synthetic mode: ``x`` is the ``torch.Generator`` the batch is drawn
    from (``task.make_batch``; phantoms, then the preset's noise).
    ``from_images``: ``x`` is a batch of ground-truth images (radial:
    complex, or a (re, im) pair) and ``task.batch_from_images``
    synthesises the measurement inside the step, with the preset's noise
    drawn from ``generator`` when one is given (noiseless without).
    The step updates ``state`` in place and returns ``{"loss",
    "grad_norm"}`` and the task's aux terms (sino_unet's ``sino_loss`` and
    ``img_loss``) as 0-d device tensors (the norm is taken before
    clipping).

    The step runs inside the span ``train.step`` (``utils/trace.py``), its
    phases inside ``train.synthesis``, ``train.forward`` (with the loss),
    ``train.backward`` (with the gradient all-reduce) and
    ``train.optimizer``. ``marks``: a list that receives the boundaries of
    those spans as ``(name, CUDA event)`` (host seconds on the CPU): the
    step's start, then the end of each phase, for :func:`split_ms`. The
    spans record their events for it when no recording is active; on a
    card, under a recording that records no event on the step's device (or
    while the stream is captured), the step raises.

    ``mesh``: the step of one rank of a data-parallel mesh (the JAX
    package's ``make_sharded_train_step``): it keeps its data shard's rows
    of the synthesised global batch, and averages the gradients (before the
    clip) and the metrics over the data axis."""
    device = next(task.model.parameters()).device
    f32_convs = not task.config.model.use_bfloat16
    synth = task.batch_from_images if from_images else task.make_batch

    def step(state: TrainState, x, marks=None, generator=None) -> dict:
        own = marks is not None and trace.active() is None
        with (trace.recording(device, anchor=False) if own else contextlib.nullcontext()), \
                trace.span("train.step") as whole:
            with trace.span("train.synthesis") as synthesis, torch.no_grad():
                batch = synth(x, generator) if from_images else synth(x)
                if mesh is not None:
                    batch = shard_batch(batch, mesh)
            with trace.span("train.forward") as forward:
                loss, aux = task.loss_fn(state.model, batch)
            with trace.span("train.backward") as backward:
                state.optimizer.zero_grad(set_to_none=True)
                # cuDNN's TF32 default would reach the f32 convolutions'
                # backward, which runs outside the forward's per-layer pins
                with exact_f32_conv(f32_convs):
                    loss.backward()
                if mesh is not None:
                    all_reduce_grads(state.model.parameters(), mesh)
            with trace.span("train.optimizer") as optimizer:
                norm = apply_gradients(state)
            # aux: the task's loss terms (sino_unet's sino_loss / img_loss)
            metrics = {"loss": loss.detach(), "grad_norm": norm,
                       **{k: v.detach() for k, v in aux.items()}}
            if mesh is not None:
                metrics = mean_over(metrics, mesh)
        if marks is not None:
            cuda = device.type == "cuda"
            marks.append(("start", whole.mark(False, cuda)))
            marks += [(name, s.mark(True, cuda)) for name, s in (
                ("synthesis", synthesis), ("forward", forward), ("backward", backward),
                ("optimizer", optimizer))]
        return metrics

    return step


def split_ms(marks) -> dict:
    """Per-phase milliseconds from a step's ``marks`` (synchronises)."""
    out = {}
    for (_, a), (name, b) in zip(marks, marks[1:]):
        if isinstance(a, float):
            out[name] = (b - a) * 1e3
        else:
            b.synchronize()
            out[name] = a.elapsed_time(b)
    return out


def make_eval_step(task: Task):
    """``evaluate(model, batch) -> {"psnr", "ssim"}``: batch means of
    ``recon_fn``'s PSNR and SSIM, as 0-d tensors, under inference mode."""

    @torch.inference_mode()
    def evaluate(model, batch):
        recon = task.recon_fn(model, batch)
        return {"psnr": psnr(recon, batch["image"]).mean(),
                "ssim": ssim(recon, batch["image"]).mean()}

    return evaluate


class TrainResult(NamedTuple):
    state: TrainState
    history: list
    final_eval: dict
    task: Task


def _profile_activities(device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _file_batches(data: str, split: str, tc, image_size: int):
    """(train dataset, validation image batches) of the slice store ``data``."""
    train_ds = SliceDataset(data, split=split)
    try:
        if train_ds.image_size != image_size:
            raise ValueError(f"dataset slices are {train_ds.image_size}² but config expects "
                             f"{image_size}²")
        if len(train_ds) < tc.batch_size:
            # iterate_batches(drop_remainder=True) would never yield, and the
            # prefetcher would wait forever with no diagnostic
            raise ValueError(f"{split!r} split has {len(train_ds)} slices < batch_size "
                             f"{tc.batch_size}")
        n_val = max(1, -(-tc.val_slices // tc.batch_size))
        # a read error here propagates: validating on the train batch instead
        # would pick the best checkpoint on training data with no diagnostic
        val_ds = SliceDataset(data, split="val")
        try:
            batches = iterate_batches(val_ds, tc.batch_size, shuffle=False)
            val_images = [next(batches)
                          for _ in range(min(n_val, len(val_ds) // tc.batch_size))]
        finally:
            val_ds.close()
        if not val_images:  # a tiny store: validate on the first train batch
            val_images = [next(iterate_batches(train_ds, tc.batch_size, shuffle=False))]
    except BaseException:
        train_ds.close()
        raise
    return train_ds, val_images


def _tb_writer(tb_dir: str):
    """A TensorBoard ``SummaryWriter`` on ``tb_dir``; the tensorboard
    package is imported only here."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError as e:
        raise ImportError(f"--tb-dir (tb_dir=) needs the tensorboard package, which is not "
                          f"installed ({e}); install it or drop --tb-dir") from e
    return SummaryWriter(tb_dir)


def _train_mesh(tc, n_devices, angle_devices):
    """The (data, angle) mesh of a run over D·G ranks, or None for one device."""
    D, G = n_devices or 1, angle_devices or 1
    if D * G == 1:
        return None
    if tc.batch_size % D:
        raise ValueError(f"batch_size {tc.batch_size} not divisible by {D} devices")
    if not dist.is_initialized():
        raise RuntimeError(
            "train(n_devices=, angle_devices=) runs in every rank of a process group: "
            "start the ranks with `python -m pdunet_tpu_torch.train --devices D "
            "--angle-devices G` (or torchrun), which joins them with "
            "parallel.init_distributed")
    return make_mesh(D * G, shape=(D, G))


def train(config: ExperimentConfig, steps: Optional[int] = None, fixed_data: bool = False,
          metrics_path: Optional[str] = None, verbose: bool = True,
          profile_dir: Optional[str] = None, device="cuda", data: Optional[str] = None,
          split: str = "train", n_devices: Optional[int] = None,
          angle_devices: Optional[int] = None, tb_dir: Optional[str] = None) -> TrainResult:
    """Train one experiment preset end to end on ``device``.

    ``steps`` overrides ``train.steps`` (and the schedule's length).
    ``fixed_data=True`` reuses step 0's batch every step (the overfit
    smoke test) and evaluates on it. ``data``: the path of a slice store
    (``data/datasets.py``) whose ``split`` holds the ground truth, in place
    of synthetic phantoms; validation then reads its ``val`` split. With
    ``train.ckpt_dir`` the run checkpoints every ``ckpt_every`` steps (keep
    ``max_checkpoints``), resumes from the latest checkpoint there, and
    keeps the best validation PSNR's weights in ``best/`` with
    ``best.json``. ``profile_dir``: a ``torch.profiler`` trace of steps 10-15 (counted
    from the start or resume step) as ``trace.json`` there, the program's
    spans (``utils/trace.py``) among its ranges.

    ``n_devices`` / ``angle_devices``: above 1, this call is one rank of a
    (data = n_devices, angle = angle_devices) mesh over the initialised
    process group (the module docstring); the batch must divide by
    ``n_devices``. ``tb_dir``: TensorBoard scalars there."""
    tc = config.train
    n_steps = tc.steps if steps is None else steps
    device = torch.device(device)
    if data is not None and fixed_data:
        raise ValueError("fixed_data and data= are mutually exclusive")
    mesh = _train_mesh(tc, n_devices, angle_devices)
    primary = mesh is None or mesh.rank == 0
    verbose = verbose and primary
    task = build_task(config, device=device,
                      mesh=mesh if (angle_devices or 1) > 1 else None)
    state = build_state(task, n_steps=n_steps,
                        init_seed=derive_seed(tc.seed, INIT_STREAM))
    if mesh is not None:
        replicate(state.model, mesh)

    ckpt_mgr = best_mgr = None
    start_step = 0
    best_psnr, best_step = float("-inf"), -1
    if tc.ckpt_dir:
        # every rank restores; only rank 0 writes
        ckpt_mgr = CheckpointManager(tc.ckpt_dir, max_to_keep=tc.max_checkpoints,
                                     save_interval_steps=tc.ckpt_every, primary=primary)
        # the best validation weights survive keep-N rotation in their own
        # single-slot manager (infer --ckpt best loads it)
        best_mgr = CheckpointManager(os.path.join(tc.ckpt_dir, "best"), max_to_keep=1,
                                     primary=primary)
        if ckpt_mgr.restore(state) is not None:
            start_step = state.step
            if verbose:
                print(f"[train] resumed from step {start_step}")
        best_json = pathlib.Path(tc.ckpt_dir, "best.json")
        # a resumed run keeps the historical best; metadata without its
        # weight slot is stale, and best tracking starts afresh
        if best_json.exists() and best_mgr.latest_step() is not None:
            prev = json.loads(best_json.read_text())
            best_psnr, best_step = prev["psnr"], prev["step"]
        if mesh is not None:
            dist.barrier()  # every rank has read the run before rank 0 writes to it

    if mesh is None:
        step_fn = make_train_step(task, from_images=data is not None)
    else:  # the JAX package's make_sharded_train_step
        step_fn = make_train_step(task, from_images=data is not None, mesh=mesh)
    eval_fn = make_eval_step(task)

    def run_eval(batches):
        sums = {}
        for b in batches:
            ev = (eval_fn(state.model, b) if mesh is None
                  else mean_over(eval_fn(state.model, shard_batch(b, mesh)), mesh))
            for k, v in ev.items():
                sums[k] = sums.get(k, 0.0) + float(v)
        return {k: v / len(batches) for k, v in sums.items()}

    def data_generator(i):
        return _generator(device, derive_seed(tc.seed, DATA_STREAM, 0 if fixed_data else i))

    history = []
    mfile = open(metrics_path, "a") if metrics_path and primary else None
    tb = _tb_writer(tb_dir) if tb_dir and primary else None
    prof = train_ds = prefetcher = None
    try:
        # a fixed validation set of ≥ val_slices held-out slices, as whole
        # batches (noiseless when they come from the store)
        with torch.no_grad():
            if data is not None:
                train_ds, val_images = _file_batches(data, split, tc, task.image_size)
                val_batches = [task.batch_from_images(torch.as_tensor(v, device=device))
                               for v in val_images]
                batch_iter = iterate_batches(train_ds, tc.batch_size, shuffle=True,
                                             seed=tc.seed)
                prefetcher = HostPrefetcher(lambda _i: next(batch_iter), depth=2)
            else:
                n_val = max(1, -(-tc.val_slices // tc.batch_size))
                val_seed = derive_seed(tc.seed, VAL_STREAM)
                val_batches = [task.make_batch(_generator(device, derive_seed(val_seed, j)))
                               for j in range(n_val)]
        t0 = time.perf_counter()
        for i in range(start_step, n_steps):
            if profile_dir and primary and i == start_step + 10:
                prof = torch.profiler.profile(activities=_profile_activities(device))
                prof.start()
            if prof is not None and i == start_step + 15:
                prof.stop()
                os.makedirs(profile_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
                prof = None
            if prefetcher is not None:
                # the host batch goes to the device here; the step draws
                # the preset's noise from the step's generator
                images = torch.as_tensor(next(prefetcher), device=device)
                metrics = step_fn(state, images, generator=data_generator(i))
            else:
                metrics = step_fn(state, data_generator(i))
            watchdog.beat()

            if (i + 1) % tc.log_every == 0 or i == n_steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=i + 1, wall_s=round(time.perf_counter() - t0, 2))
                history.append(m)
                if verbose:
                    print(f"[train] {json.dumps(m)}")
                if mfile:
                    mfile.write(json.dumps(m) + "\n")
                    mfile.flush()
                if tb:
                    for k, v in m.items():
                        if k != "step":
                            tb.add_scalar(k, v, i + 1)
            if (i + 1) % tc.eval_every == 0 and not fixed_data:
                ev = run_eval(val_batches)
                if verbose:
                    print(f"[eval]  step {i + 1}: {json.dumps(ev)}")
                if mfile:
                    mfile.write(json.dumps({"step": i + 1, **ev}) + "\n")
                    mfile.flush()
                if tb:
                    for k, v in ev.items():
                        tb.add_scalar(f"val_{k}", v, i + 1)
                if ev["psnr"] > best_psnr:
                    best_psnr, best_step = ev["psnr"], i + 1
                    if best_mgr is not None and best_mgr.save(best_step, state, config=config,
                                                              force=True):
                        pathlib.Path(tc.ckpt_dir, "best.json").write_text(
                            json.dumps({"step": best_step, "psnr": best_psnr}))
            if ckpt_mgr is not None:
                ckpt_mgr.save(i + 1, state, config=config)
    finally:
        if prof is not None:
            prof.stop()
        if mfile:
            mfile.close()
        if tb:
            tb.close()
        if prefetcher is not None:
            prefetcher.close()
        if train_ds is not None:
            train_ds.close()

    if fixed_data:
        with torch.no_grad():
            final_eval = run_eval([task.make_batch(data_generator(0))])
    else:
        final_eval = run_eval(val_batches)
    if ckpt_mgr is not None and ckpt_mgr.latest_step() != n_steps:
        ckpt_mgr.save(n_steps, state, config=config, force=True)
    if mesh is not None:
        dist.barrier()  # no rank returns before rank 0's last checkpoint is written
    return TrainResult(state, history, final_eval, task)
