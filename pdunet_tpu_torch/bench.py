"""Benchmark entry point of the PyTorch port (port of ``bench.py``).

Prints ONE JSON line with the headline metric: 256² sparse-view CT
reconstructions per second per card through the ``pdunet_parallel``
Primal-Dual UNet (inference, random weights from seed 0), at the JAX
harness's defaults (batch 256, 4 unrolled iterations, 360 angles kept 4×
sparse). The line carries no ``vs_baseline``: the JAX harness divides by
``TARGET_PER_CHIP = 125``, a target set for a TPU v5e-8, which says nothing
about an H100.

    python -m pdunet_tpu_torch.bench                  # headline, on the card
    python -m pdunet_tpu_torch.bench --all            # + roofline, A / A† / FBP, train rows
    python -m pdunet_tpu_torch.bench --train-scan     # + the train step's batch ladder
    python -m pdunet_tpu_torch.bench --preset-recon pdunet_radial --batch 128
    python -m pdunet_tpu_torch.bench --preset-recon lpd_parallel --batch 256
    python -m pdunet_tpu_torch.bench --preset-recon pdunet_fan --batch 128
    python -m pdunet_tpu_torch.bench --preset-recon sino_unet_radial --batch 64
    python -m pdunet_tpu_torch.bench --unet-scan      # UNet variants and parts → unet_scan.json
    python -m pdunet_tpu_torch.bench --device cpu --batch 2 --image-size 32 --n-iters 2

``--all`` prints the secondary rows to stderr and writes them to
``bench_details.json``: the roofline, the A / A† / FBP rows, and the train
step of the headline config at ``min(batch, 32)`` (seconds per step, its
split into synthesis, forward with the loss, backward and optimizer, and
peak memory). ``--train-scan`` adds the train step's batch ladder: that
batch without remat, then 2×, 4× and 8× with remat, stopping at the first
batch that runs out of card memory. ``--unet-scan`` times the UNet's
stem x upsample variants and its per-level parts at the flagship
``fbp_unet`` shape and writes them to ``unet_scan.json`` in the working
directory. Every preset runs (``--matrix`` benches all seven at
``MATRIX_BATCH``). Rows carry no test PSNR/SSIM: the JAX harness reads
those from artifacts of checkpoints trained on a TPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time

import torch

from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.training.loop import (
    TrainState,
    build_optimizer,
    make_train_step,
    split_ms,
)
from pdunet_tpu_torch.training.tasks import build_geometries, build_task
from pdunet_tpu_torch.utils import watchdog

#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), for the roofline
H100_BF16_PEAK = 989e12

#: the batch each preset's end-to-end recon is benchmarked at (--matrix),
#: the JAX harness's saturating batches
MATRIX_BATCH = {"pdunet_parallel": 256, "fbp_unet_parallel": 256, "sino_unet_parallel": 128,
                "lpd_parallel": 256, "pdunet_fan": 128, "pdunet_radial": 128,
                "sino_unet_radial": 64}

#: shortest timed window: enough calls that event and launch jitter (µs) vanish
_MIN_WINDOW_S = 0.1

#: which batch entry of each model kind the timed call takes as its argument
#: (the JAX harness's loop carry; the other entries stay fixed); the radial
#: sino_unet's is "k_in_w"
_CARRY_KEY = {"pdunet": "f0", "lpd": "f0", "fbp_unet": "fbp", "sino_unet": "sino_in"}


def _window(call, device, iters: int) -> float:
    """Seconds for ``iters`` back-to-back ``call()``: CUDA events on the
    card, the host clock on the CPU."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            call()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        call()
    return time.perf_counter() - t0


def timeit(fn, x0, iters: int = 10, aux=()) -> float:
    """Seconds per call of ``fn(x0, *aux)``.

    One warm call (it builds the kernels at first use), then windows of
    ``iters`` back-to-back calls, ``iters`` growing ×8 until a window lasts
    0.1 s (or reaches 10,000 calls); the best of three such
    windows. On the card the window is timed by CUDA events, which PyTorch
    records in stream order, so no host synchronisation sits inside it; on
    the CPU by ``time.perf_counter``. The JAX harness's device
    ``fori_loop``, scalar pull and 0-iteration baseline are not carried
    over: they worked around a TPU backend whose ``block_until_ready``
    returned before the device finished."""
    with torch.inference_mode():
        fn(x0, *aux)
        if x0.device.type == "cuda":
            torch.cuda.synchronize(x0.device)
        watchdog.beat()
        while True:
            best = _window(lambda: fn(x0, *aux), x0.device, iters)
            watchdog.beat()
            if best >= _MIN_WINDOW_S or iters >= 10000:
                break
            iters *= 8
        for _ in range(2):
            best = min(best, _window(lambda: fn(x0, *aux), x0.device, iters))
    return best / iters


def device_kind(device) -> str:
    device = torch.device(device)
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type


def bench_preset_recon(name: str, batch_size: int, stem: int | None = None,
                       image_size: int | None = None, n_angles: int | None = None,
                       sparsity: int | None = None, device="cuda") -> dict:
    """End-to-end recon throughput of one preset at its config (dtype, stem,
    n_iters as shipped), with random weights from seed 0. ``stem``
    overrides the model's space-to-depth stem; ``image_size`` /
    ``n_angles`` / ``sparsity`` override the geometry (--scale-scan)."""
    config = get_preset(name)
    config = dataclasses.replace(
        config, train=dataclasses.replace(config.train, batch_size=batch_size))
    if stem is not None:
        config = dataclasses.replace(config, model=dataclasses.replace(config.model, stem=stem))
    geom_over = {k: v for k, v in (("image_size", image_size), ("n_angles", n_angles),
                                   ("sparsity", sparsity)) if v is not None}
    if geom_over:
        config = dataclasses.replace(
            config, geometry=dataclasses.replace(config.geometry, **geom_over))
    task = build_task(config, device=device)
    watchdog.beat()
    with torch.inference_mode():
        batch = task.make_batch(torch.Generator(device=device).manual_seed(0))
    radial_sino = config.model.kind == "sino_unet" and config.geometry.kind == "radial"
    carry_key = "k_in_w" if radial_sino else _CARRY_KEY[config.model.kind]
    carry0 = batch.pop(carry_key)
    task.model.eval()

    def recon_with_carry(x):
        return task.recon_fn(task.model, dict(batch, **{carry_key: x}))

    dt = timeit(recon_with_carry, carry0)
    row = {
        "preset": name,
        "batch": batch_size,
        "recon_slices_per_sec": round(batch_size / dt, 2),
        "sec_per_slice": round(dt / batch_size, 6),
        "device": device_kind(device),
    }
    if sparsity is not None:
        row["sparsity"] = sparsity
    if geom_over:
        g = config.geometry
        row.update(image_size=g.image_size, n_angles=g.n_angles)
        row["mpixels_per_sec"] = round(batch_size / dt * g.image_size ** 2 / 1e6, 2)
    return row


def time_train_steps(step, state, device, iters: int = 5) -> tuple:
    """(seconds per train step, its split) of ``step(state, generator)``.

    Two warm steps, then the best of three windows of ``iters`` back-to-back
    steps, each drawing its own batch (timed as :func:`timeit`'s windows).
    The split is the mean over ``iters`` more steps of the per-phase times
    between the step's CUDA events (``make_train_step``'s marks):
    synthesis, forward with the loss, backward, optimizer. A phase whose
    host work outlasts the device's queue reads as the host's time."""
    device = torch.device(device)
    seeds = itertools.count()

    def one(marks=None):
        step(state, torch.Generator(device=device).manual_seed(next(seeds)), marks)

    for _ in range(2):
        one()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    best = float("inf")
    for _ in range(3):
        watchdog.beat()
        best = min(best, _window(one, device, iters))
    sums = {}
    for _ in range(iters):
        marks = []
        one(marks)
        for k, v in split_ms(marks).items():
            sums[k] = sums.get(k, 0.0) + v / iters
    return best / iters, {f"{k}_sec": round(v / 1e3, 6) for k, v in sums.items()}


def bench_train(config, batch: int, remat: bool = False, device="cuda") -> dict:
    """Train-step row of ``config`` at ``batch``: Adam at a constant 1e-3
    (as the JAX harness), random weights from seed 0."""
    config = dataclasses.replace(
        config, model=dataclasses.replace(config.model, remat=remat),
        train=dataclasses.replace(config.train, batch_size=batch))
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    task = build_task(config, device=device)
    state = TrainState(task.model, build_optimizer(task.model), lambda i: 1e-3)
    dt, split = time_train_steps(make_train_step(task), state, device)
    return {"batch": batch, "remat": remat, "step_sec": round(dt, 6),
            "slices_per_sec": round(batch / dt, 2),
            "split": split,
            "peak_mem_gib": (round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
                            if on_card else None)}


def train_scan(config, batch: int, device="cuda") -> list:
    """The train step's memory/speed ladder (the JAX harness's 32 / 64 /
    128 / 256 at the full batch): ``batch`` without remat, then 2×, 4×, 8×
    with remat. Running out of card memory ends the ladder with an error
    row; any other failure raises."""
    rows = []
    for b, remat in ((batch, False), (2 * batch, True), (4 * batch, True), (8 * batch, True)):
        try:
            row = bench_train(config, b, remat=remat, device=device)
        except torch.cuda.OutOfMemoryError:
            rows.append({"batch": b, "remat": remat, "error": "OutOfMemoryError"})
            torch.cuda.empty_cache()
            break
        rows.append(row)
        print(json.dumps(row), file=sys.stderr)
    return rows


def projector_flops_per_apply(meta: dict, K: int, S: int) -> int:
    """Analytic FLOPs of one A (or A†) of the factored projector, as the JAX
    harness counts them: per angle group stage 1 2·(units·N²·K) MACs, stage 2
    4·(rows·N·K), stage 3 2·(rows·K·S), 2 FLOP per MAC; mirror-pair plans
    run stage 1 once per pair and stages 2-3 per emitted row (2 per pair)."""
    N = meta["N"]
    if meta["use_pairs"]:
        units1 = meta["P_x"] + meta["P_y"]
        rows23 = 2 * units1
    else:
        units1 = rows23 = meta["A_x"] + meta["A_y"]
    return 2 * (2 * units1 * N * N * K + 4 * rows23 * N * K + 2 * rows23 * K * S)


def _roofline(task, batch, dt: float, n_iters: int, B: int, sparse_geom, device) -> dict:
    """Conv-side FLOPs of one recon from FlopCounterMode (the hand-written
    projector kernels are ctypes calls it does not see, as XLA's cost model
    scored the Pallas calls at zero) plus the analytic projector FLOPs, over
    the H100's dense bf16 peak. Utilisations are left out off the card."""
    from torch.utils.flop_counter import FlopCounterMode

    from pdunet_tpu_torch.geometry import build_parallel_plan

    with torch.inference_mode(), FlopCounterMode(display=False) as counter:
        task.recon_fn(task.model, batch)
    flops = float(counter.get_total_flops())
    plan = build_parallel_plan(sparse_geom, device="cpu")
    proj_slice = 2 * n_iters * projector_flops_per_apply(
        plan.meta, plan.spec.shape[0], plan.Wc.shape[1])
    total_slice = flops / B + proj_slice
    on_card = torch.device(device).type == "cuda"

    def util(achieved):
        return round(achieved / H100_BF16_PEAK, 4) if on_card else None

    return {
        "device_kind": device_kind(device),
        "peak_ref": "H100 SXM dense bf16 tensor cores, 989 TFLOP/s",
        "conv_flops_per_batch": flops,
        "tflops_per_slice": round(flops / B / 1e12, 6),
        "achieved_tflops_per_sec": round(flops / dt / 1e12, 2),
        "conv_util_vs_bf16_peak": util(flops / dt),
        "projector_tflops_per_slice_analytic": round(proj_slice / 1e12, 6),
        "total_tflops_per_slice": round(total_slice / 1e12, 6),
        "achieved_total_tflops_per_sec": round(total_slice * B / dt / 1e12, 2),
        "total_util_vs_bf16_peak_est": util(total_slice * B / dt),
        "note": "conv-only figures exclude the hand-written projector kernels "
                "(FlopCounterMode does not see them); *_total adds the analytic "
                "projector FLOPs; utilisations only on the card",
    }


def bench_unet_scan(batch: int = 128, image_size: int = 256, base_features: int = 64,
                    depth: int = 3, device="cuda") -> dict:
    """Where the UNet's time goes, at the flagship fbp_unet shape (bf16,
    random weights from seed 0):

    * variants: the whole forward for stem ∈ {1, 2} x upsample ∈
      {convtranspose, shuffle};
    * parts: each stem-2 piece timed alone at its shape in the network
      (encoder and decoder ConvBlocks per level, the bottleneck, both
      upsample ops, the 1x1 head).

    Shapes are NCHW ``[batch, channels, h, w]``; the parts' inputs and
    weights lie channels_last, as inside the UNet."""
    from pdunet_tpu_torch.models.unet import (
        Conv,
        ConvBlock,
        ConvTranspose,
        UNet,
        _d2s_channels_last,
    )

    device = torch.device(device)
    bf16 = torch.bfloat16
    kw = dict(dtype=bf16, device="cpu")

    def t_module(module, shape, dtype=bf16, memory_format=torch.contiguous_format):
        torch.manual_seed(0)  # the weights of modules built without a generator
        module = module.to(device)
        x = torch.ones(shape, dtype=dtype, device=device).to(memory_format=memory_format)
        return timeit(module, x)

    class Shuffle(torch.nn.Module):
        def __init__(self, cin, features):
            super().__init__()
            self.conv = Conv(cin, 4 * features, 1, **kw)

        def forward(self, x):
            return _d2s_channels_last(self.conv(x), 2)

    out = {"batch": batch, "image_size": image_size, "base_features": base_features,
           "depth": depth, "layout": "NHWC", "device": device_kind(device),
           "variants": [], "parts": []}
    for stem in (1, 2):
        for up in ("convtranspose", "shuffle"):
            m = UNet(in_channels=1, base_features=base_features, depth=depth, stem=stem,
                     upsample=up, generator=torch.Generator().manual_seed(0), **kw)
            dt = t_module(m, (batch, 1, image_size, image_size), torch.float32)
            out["variants"].append({"stem": stem, "upsample": up,
                                    "ms_per_batch": round(dt * 1e3, 3),
                                    "slices_per_sec": round(batch / dt, 2)})
            print(json.dumps(out["variants"][-1]), file=sys.stderr)

    stem = 2
    feats = UNet.level_features(base_features, stem, depth)
    n0 = image_size // stem

    def part(name, module, shape, **extra):
        cl = torch.channels_last
        dt = t_module(module.to(memory_format=cl), shape, memory_format=cl)
        out["parts"].append({"part": name, "shape": list(shape), **extra,
                             "ms_per_batch": round(dt * 1e3, 3)})

    for d in range(depth):
        h = n0 >> d
        c_in = stem * stem if d == 0 else feats[d - 1]
        part(f"enc{d}", ConvBlock(c_in, feats[d], **kw), (batch, c_in, h, h),
             features=feats[d])
    h = n0 >> depth
    part("bottleneck", ConvBlock(feats[depth - 1], feats[depth], **kw),
         (batch, feats[depth - 1], h, h), features=feats[depth])
    for d in reversed(range(depth)):
        h = n0 >> (d + 1)
        c_in = feats[d + 1]
        part(f"up{d}_convtranspose", ConvTranspose(c_in, feats[d], **kw), (batch, c_in, h, h))
        part(f"up{d}_shuffle", Shuffle(c_in, feats[d]), (batch, c_in, h, h))
        part(f"dec{d}", ConvBlock(2 * feats[d], feats[d], **kw),
             (batch, 2 * feats[d], 2 * h, 2 * h))
    part("head_1x1", Conv(feats[0], stem * stem, 1, **kw), (batch, feats[0], n0, n0))
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--batch", type=int, default=256)
    p.add_argument("--n-iters", type=int, default=4)
    p.add_argument("--image-size", type=int, default=256)
    p.add_argument("--device", default="cuda")
    p.add_argument("--all", action="store_true", help="also run secondary benches")
    p.add_argument("--matrix", action="store_true",
                   help="with --all: bench every preset end-to-end")
    p.add_argument("--train-scan", action="store_true",
                   help="with --all: the train step's batch ladder (remat above the "
                        "first rung)")
    p.add_argument("--dtype", choices=["preset", "f32", "bf16"], default="preset",
                   help="network compute dtype (default: the preset's, bf16)")
    p.add_argument("--scale-scan", action="store_true",
                   help="with --all: flagship recon throughput across image sizes")
    p.add_argument("--preset-recon", metavar="NAME",
                   help="bench ONE preset's end-to-end recon and exit")
    p.add_argument("--stem", type=int, default=None,
                   help="with --preset-recon: override the space-to-depth stem")
    p.add_argument("--sparsity", type=int, default=None,
                   help="with --preset-recon: override the undersampling factor")
    p.add_argument("--unet-scan", action="store_true",
                   help="time UNet upsample/stem variants and per-level parts at the "
                        "flagship fbp_unet shape; writes unet_scan.json and exits")
    args = p.parse_args(argv)
    args.all = args.all or args.matrix or args.train_scan or args.scale_scan
    return args


def _headline_task(args):
    config = get_preset("pdunet_parallel")
    model_over = {} if args.dtype == "preset" else {"use_bfloat16": args.dtype == "bf16"}
    config = dataclasses.replace(
        config,
        geometry=dataclasses.replace(config.geometry, image_size=args.image_size,
                                     n_angles=360, sparsity=4),
        model=dataclasses.replace(config.model, n_iters=args.n_iters, **model_over),
        train=dataclasses.replace(config.train, batch_size=args.batch),
    )
    return config, build_task(config, device=args.device)


def _secondary(args, config, task, batch, dt, result) -> dict:
    from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

    details = {"primary": result, "config": {
        "batch": args.batch, "n_iters": args.n_iters, "image_size": args.image_size,
        "dtype": args.dtype, "device": device_kind(args.device)}}
    _, sparse_geom = build_geometries(config.geometry)
    details["roofline"] = _roofline(task, batch, dt, args.n_iters, args.batch,
                                    sparse_geom, args.device)
    # the operator rows run at the compute dtype of the headline config
    op_dtype = torch.bfloat16 if config.model.use_bfloat16 else torch.float32
    ops = make_parallel_ops(sparse_geom, dtype=op_dtype, device=args.device)
    details["radon_fwd_slices_per_sec"] = round(args.batch / timeit(ops.A, batch["image"]), 2)
    details["radon_adj_slices_per_sec"] = round(args.batch / timeit(ops.At, batch["sino"]), 2)
    details["fbp_slices_per_sec"] = round(args.batch / timeit(ops.fbp, batch["sino"]), 2)
    if args.scale_scan:
        # recon work scales ~O(n_angles·N·K) in the projector and O(N²) in
        # the convolutions; batch halves per octave to bound memory
        details["scale_scan"] = []
        for size, n_ang, b in ((128, 180, 512), (256, 360, 256), (384, 540, 128),
                               (512, 720, 64)):
            try:
                row = bench_preset_recon("pdunet_parallel", b, image_size=size,
                                         n_angles=n_ang, device=args.device)
            except torch.cuda.OutOfMemoryError as e:
                row = {"image_size": size, "n_angles": n_ang, "batch": b,
                       "error": f"{type(e).__name__}: {e}"}
            details["scale_scan"].append(row)
            print(json.dumps(row), file=sys.stderr)
    train_batch = min(args.batch, 32)
    details["config"]["train_batch"] = train_batch
    train_row = bench_train(config, train_batch, device=args.device)
    details["train_step_sec"] = train_row["step_sec"]
    details["train_slices_per_sec"] = train_row["slices_per_sec"]
    details["train_split"] = dict(
        train_row["split"], batch=train_batch,
        note="synthesis: make_batch (f32 A + direct recon); forward: unroll + loss; "
             "backward: loss.backward(); optimizer: clip + Adam; device time between "
             "CUDA events")
    details["train_peak_mem_gib"] = train_row["peak_mem_gib"]
    if args.train_scan:
        details["train_scan"] = train_scan(config, train_batch, device=args.device)
    if args.matrix:
        details["presets"] = []
        for name, b in MATRIX_BATCH.items():
            row = bench_preset_recon(name, b, device=args.device)
            details["presets"].append(row)
            print(json.dumps(row), file=sys.stderr)
    return details


def main(argv=None):
    args = parse_args(argv)
    watchdog.start(float(os.environ.get("PDUNET_WATCHDOG_SECS", 0)), label="bench")

    if args.unet_scan:
        scan = bench_unet_scan(batch=min(args.batch, 128), image_size=args.image_size,
                               device=args.device)
        with open("unet_scan.json", "w") as f:
            json.dump(scan, f, indent=2)
        print(json.dumps(scan, indent=2))
        return 0

    if args.preset_recon:
        row = bench_preset_recon(args.preset_recon, args.batch, stem=args.stem,
                                 sparsity=args.sparsity, device=args.device)
        print(json.dumps(row))
        return 0

    config, task = _headline_task(args)
    task.model.eval()
    with torch.inference_mode():
        batch = task.make_batch(torch.Generator(device=args.device).manual_seed(0))

    dt = timeit(lambda f0: task.recon_fn(task.model, dict(batch, f0=f0)), batch["f0"])
    per_chip = args.batch / dt
    result = {"metric": "pdunet_256_sparse_ct_recon_throughput",
              "value": round(per_chip, 2), "unit": "slices/sec/chip",
              "batch": args.batch, "device": device_kind(args.device)}
    print(json.dumps(result), flush=True)

    if args.all:
        details = _secondary(args, config, task, batch, dt, result)
        print(json.dumps(details, indent=2), file=sys.stderr)
        with open("bench_details.json", "w") as f:
            json.dump(details, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
