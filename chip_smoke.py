#!/usr/bin/env python3
"""Smoke test of the PyTorch port (pdunet_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back to the CPU):
  1. build every CUDA source of the port with nvcc (sm_90a), all at once, and
     count the HGMMA (wgmma) instructions of each tensor-core kernel in the
     built library (cuobjdump -sass): the stage-1 / 1ᵀ kernels, row 6's
     packed probe (radon_proto_tc.cu) and row 5's pair probe
     (radon_pair_proto_tc.cu) included, must have some;
  2. at the serving path's shapes (pdunet_parallel: B=4, 256², 90 of 360
     angles, P=23 pairs per group, K=180), hold each kernel against its plain
     PyTorch version on the card, float32 and bf16 operands, both groups:
     relative error ≤ 1e-5 (f32, the split-bf16 tensor-core route) / ≤ 5e-3
     (bf16, the tensor-core route), each from the plan's trig tables, TF32
     off for the reference; both routes' tables bit-equal to the plain
     builders'; both routes against the plain versions of their own tiling
     and arithmetic; both again at B = 1 and 32 and at a size whose rows do
     not fill a tile (96², 24 of 96 angles);
  3. the adjoint dot-product test of the routed kernel pair in float32
     (≤ 1e-5, on the split route), and of the bf16 tensor-core pair per
     group: its mismatch at most 2× the plain bf16 pair's plus 1e-4;
  4. the serving path at full width (build_task → make_batch →
     batch_from_images → recon_fn → PSNR/SSIM) with random weights from a
     seed; launch counters, zeroed before build_task, must show each route's
     tables built once per group, every bf16 A and A† (the power iteration
     in build_task, 2·n_iters per op per batch in recon_fn) on the bf16
     tensor-core route, synthesis and FBP on the split route, and no
     per-angle launch; the card's f0 must match the plain path on the
     CPU, and a cut-down float32 task must reconstruct the same on the card
     and on the CPU, with TF32 off and with torch's default (cuDNN's TF32
     allowed: the UNet's f32 convolutions pin full f32 themselves);
  5. timings of each kernel beside its bound and its plain version, a
     torch.matmul of stage 1's shape as a labelled yardstick (bf16; full f32
     for the f32 route), each tensor-core route at B = 4 and B = 256, warm
     and with the L2 cache flushed before each call, the split route's
     bound (stage 1 as three bf16 products, stages 2-3 in FP32) beside the
     FP32 one, both adjoints' times against their slice counts at B = 4,
     the table build times, batch_from_images on the split route at batch
     4 and 256, and reconstruction slices/s and profile at batch 4;
  6. at the radial path's shapes (pdunet_radial: 256² complex images, 128 of
     512 golden-angle spokes of 512 samples, so the per-angle kernels see
     B' = 2·4 = 8 real images, A_x = A_y = 64 spokes, K = 256, S = 1024),
     both routes' per-angle trig tables bit-equal to the plain builders', and
     the per-angle kernels against their plain versions, f32 (the split-bf16
     tensor-core route) and bf16 (the tensor-core route), each from the
     plan's tables, both groups, to the same tolerances; both routes against
     the plain versions of their own tiling and arithmetic, again at B' = 2
     and on the ragged 32² radial plan (24 spokes of 64 samples); the complex
     adjoint dot test of the fourier-slice NUFFT (≤ 1e-5), the f32 dot test
     of the split route's per-angle operators (y = A x + noise, ≤ 1e-5) and
     the bf16 dot test of the tensor-core pair per group (≤ 2× the plain
     bf16 pair's mismatch plus 1e-4);
  7. the radial serving path at full width (build_task("pdunet_radial") →
     make_batch → batch_from_images(image_c) → recon_fn → PSNR/SSIM on the
     magnitude), random weights from a seed; launch counters, zeroed before
     build_task, must show each route's per-angle tables built once per
     group, every bf16 A and A† (the power iteration in build_task,
     2·n_iters per op per batch in recon_fn) on the tensor-core route,
     synthesis and the DCF adjoint (2 per op per batch_from_images, 4 per
     op per batch) on the split route, and no pair kernel; the
     card's sino and f0 must match the CPU plain path (batch 1), and a
     cut-down f32 radial task (split route) must reconstruct the same on
     card and CPU;
  8. timings of the per-angle kernels beside their bound, plain version and
     stage-1 matmul yardstick (bf16; full f32 for the f32 route), each
     tensor-core route at B' = 8 and B' = 256 (bench's batch 128), warm and
     L2-cold, the split route's bound beside the FP32 one, both adjoints'
     times against their slice counts at B' = 8, each call's device time by
     kernel on both routes, the table builds, batch_from_images on the split
     route at batch 4 and 128, and the radial recon at batch 4: slices/s,
     the host's time to enqueue one recon, and the profile; then σ of
     build_task's power iteration on the bf16 operators against σ from
     their plain versions on the card (≤ 5e-3);
  9. the two kernel probes as a user runs them (``python -m
     pdunet_tpu_torch.scripts.trig_proto`` on its three plans: flagship,
     256², 90 of 360 angles, B=32; sino_unet_parallel's dense 360-angle
     plan at B = 8 and 128; pdunet_fan's backing plan at B = 4 and 128;
     ``pack_proto`` on its three plans: flagship, pdunet_radial's 128-spoke
     plan at B' = 8, sino_unet_radial's dense 512-spoke plan at B' = 8 and
     128 with the shipped f32 adjoint's table probes; their own checks and
     timings); launch counters must show each probe kernel ran;
 10. at the flagship shapes, each probe kernel (doubling and no-trig pair
     forward and packed per-angle forward and adjoint, all on the tensor
     cores) against its plain version, f32 and bf16, both groups (≤ 1e-5 /
     ≤ 5e-3); the packed kernels with exact trig in bf16 too; then row 5's
     tensor-core kernels on the flagship groups (B =
     32), the dense plan (B = 8), pdunet_fan's backing plan (B = 4), a 96²
     plan (B = 4) and 384² and 512² plans (B = 2), both groups, bf16 and
     f32: against the plain versions (≤ 5e-3 / ≤ 1e-5), against the plain
     versions of their own arithmetic (the same trig in tables, bf16 or
     split) and doubling against the shipped tensor-core route from the
     plan's tables (< 2e-2, the probe's check); then row 6's tensor-core
     kernels on the flagship groups (B = 32), both radial plans (B' = 8), a
     96² plan (Np = 128 > N) and pdunet_fan's backing plan (odd S = 251)
     at B = 4, and 384² and 512² plans (the forwards' depth windows, 3 x
     128 and 2 x 256) at B = 2, both groups, bf16 with doubling and with
     exact trig and f32: against the plain versions (≤ 5e-3 / ≤ 1e-5),
     against the shipped tensor-core route from the plan's tables (bf16
     exact trig ≤ 5e-3, f32 ≤ 1e-5) and the f32 dot test (y = A x + noise,
     ≤ 1e-5);
 11. CUDA-event timings of the probe kernels beside their bound (f32: the
     split bound), plain version and stage-1 matmul yardstick, and the
     shipped tensor-core routes;
 12. bench's headline path (``pdunet_tpu_torch.bench``) at batch 32: its
     JSON row, and launch counters showing it ran the pair kernels only;
 13. training: a few steps of ``training.loop.train`` for ``pdunet_parallel``
     and ``pdunet_radial`` at full width (batch 4, bf16): finite losses,
     finite nonzero gradient norms, every parameter moved, the launch
     counters of the whole run (from 0 before it) and of one step after a
     warm one (16 bf16 forward and 14 bf16 adjoint group calls, the
     backward's included, and 2 + 2 split ones per step; no probe or
     other-geometry launch); the step's time (host clock), its
     split (CUDA events: synthesis, forward with the loss, backward,
     optimizer), idle share (torch.profiler) and peak memory; one f32 step
     of a cut-down task on the card and on the CPU from the same weights
     and images (loss ≤ 1e-5, gradient ≤ 1e-4); the golden-size runs of
     ``tests/test_goldens.py`` (the port's own draws) against their untrained
     eval, printed beside ``tests/goldens.json``; and at golden size, with
     cuDNN deterministic, a run that fails after step 10 of 15 and is
     resumed, bit for bit against one that never stopped, restored again
     by ``infer --ckpt-dir``;
 14. slice B (fbp_unet_parallel, sino_unet_parallel, lpd_parallel): the
     split pair route on sino_unet's dense 360-angle plan (P = 91 pairs per
     group), tables bit-equal to the plain builders', both kernels against
     their plain f32 versions at B = 8 and 128 (≤ 1e-5) and timed beside
     the split bound, the plain version and a full-f32 matmul of stage 1's
     shape, the f32 dot test there and the adjoint's slice-count sweep;
     then per preset at full width: the serving path with launch counts
     from 0 before build_task (SLICE_B_LAUNCHES: fbp 2 + 2 split per
     synthesis and none per recon, sino 2 split forward per synthesis and 2
     split adjoint per recon, lpd 42 + 42 bf16 in build_task and 20 + 20 per
     recon; each route's tables built once per plan and group; no
     per-angle or probe launch), recon time and profile, a
     cut-down f32 task on card and CPU, a few train() steps at the preset's
     batch (finite losses, every parameter moved, whole-run counts), one
     step's launches after a warm one (fbp 2 + 2 split, sino 4 + 2 split,
     lpd 40 + 38 bf16 and 2 + 2 split), its time, split, idle share and
     peak memory, and ``bench --preset-recon`` at MATRIX_BATCH with device
     time by kind; and the three golden-size runs.
 15. pdunet_fan: (a) both pair routes on its backing plans, the sparse one
     (104 angles from about −21° to 291°, P = 30 pairs per group, most of
     sign +1, 7 / 9 unpaired rows, S = 251, K = 179) and the dense one
     (402 angles, P = 120): tables bit-equal, both kernels against their
     plain versions at B = 4 and 128 (bf16 ≤ 5e-3, split f32 ≤ 1e-5), also
     where only the sign +1 pairs carry signal, the fan operators' f32 dot
     test, and device times per group call beside the bound, the plain
     version and a matmul of stage 1's shape; (b) the preset at full width
     as in phase 14 (SLICE_C_LAUNCHES: its unroll counts equal
     pdunet_parallel's, 8 + 8 bf16 per recon, since a fan A is one
     backing-plan call per group; the banded rebinning weights built once
     per plan and use, FAN_BAND_BUILDS), low-dose noise in its batches;
 16. sino_unet_radial: (a) the per-angle split route on its dense
     512-spoke plan (A_x = A_y = 256, K = 256, S = 1024): tables bit-equal
     and their size, both kernels against their plain f32 versions at B' =
     8 and 128 (≤ 1e-5) and timed beside the split bound, the plain version
     and a full-f32 matmul of stage 1's shape; (b) the preset at full width
     (2 split adjoint calls per recon; per step 4 split forward and 2 split
     adjoint; no pair or bf16 launch).
 17. file-backed data: the native data library must build; stores of 48
     slices at 256² in the npy container (real, and complex for MRI) and
     an HU-domain volume (convert_volume); (17) pdunet_parallel through
     ``train(data=...)`` for 20 steps with low-dose noise from each step's
     generator, (17b) pdunet_radial through ``train --data`` for 10 steps
     with k-space noise: launch counts from 0 before each run against the
     synthetic path's, validation on whole batches of the val split, one
     file-backed step's launches against the synthetic step's, the
     synthetic step, the file-backed one and one from host batches read
     beforehand (no producer thread), host time and idle share in turns,
     then ``infer --ckpt best
     --data ... --split test --corrupt --export-png`` (17: on the HU
     volume, with ``--hu-window 40 400``): launch counts, finite PSNR/SSIM,
     PNGs that decode;
 18. the Kaiser-Bessel gridding NUFFT at 256² with 128 spokes of 511
     samples (the odd readout warns and falls back): A and A† against the
     float64 numpy twins at B = 4 (≤ 1e-5), the dot test (≤ 1e-5), the
     adjoint bit for bit twice, CUDA-event times of A, A† and fbp at B = 4
     and 128 beside the adjoint's grid sum as a segment sum and as
     ``index_add_``; pdunet_radial at 511 samples served at batch 4 and
     trained 10 steps with no projector kernel launched, and its recon time
     and profile at batch 4.
 19. angle-sharded operators at full width, G = 2: (a) here, on each shard
     of pdunet_parallel's sparse pair plan (P = 23 per group: 12 rows per
     shard, the second shard's last a zero pad row), pdunet_fan's backing
     plan (sign +1 pairs) and pdunet_radial's 128-spoke fourier-slice plan
     (the per-angle kernels), each kernel of rows 1-4 against its plain
     version, f32 (split route, ≤ 1e-5) and bf16 (tensor-core route,
     ≤ 5e-3), from the shard's own tables, bit-equal to the plain
     builders'; (b) in 2 gloo ranks on this card (mesh 1 x 2, ``python -m
     pdunet_tpu_torch.parallel.check``), the sharded A, A†, fbp and both
     vjps of the three presets' bundles in f32 and bf16 against the
     unsharded ones here (≤ 1e-5 / ≤ 5e-3), the f32 dot test (y = A x +
     noise, ≤ 1e-5), vjp(A_sh) = A†_sh and vjp(A†_sh) = A_sh (≤ 1e-6), each
     rank's launches (2 forward and 4 adjoint group calls on the dtype's
     route, no other projector kernel) and tables (its shard's rows only),
     and per-rank CUDA-event times (time-shared on one card, not scaling);
 20. sharded training and serving of pdunet_parallel at full width (256²,
     batch 4): one f32 SGD step on the (2, 1), (1, 2) and (2, 2) meshes (2
     and 4 gloo ranks on this card) and on a world-1 NCCL group against the
     single-device step here (loss rtol 1e-4, parameters atol 1e-4, σ the
     same on every rank), three bf16 preset steps on (2, 2) and two of
     pdunet_radial on (1, 2) with finite losses and every kernel of the
     path launched in every rank; host ms per step for each mesh; then
     ``train --devices 2 --angle-devices 2 --steps 3 --ckpt-dir``, a
     single-device ``infer --ckpt-dir`` of its checkpoint, and ``infer
     --devices 2`` equal to ``--devices 1`` (PSNR rtol 1e-5, SSIM 1e-4).
 21. the ``scripts/`` backends (``pdunet_tpu_torch/scripts/``) as a user runs
     them, in a temporary root: ``acceleration_sweep`` on pdunet_parallel,
     pdunet_fan and pdunet_radial at 4x (20 steps at full width, batch 4,
     then each best checkpoint's infer on 64 slices), ``ood_eval`` on the
     pdunet_parallel cell (shepp_logan, hu_volume; 8-slice stores),
     ``ood_analysis`` in process over the three cells (indist, shepp_logan,
     hu_volume): each anchor PSNR mean within 0.01 dB of the JAX package's
     on the CPU (``scripts/ood_anchors_reference.json``, same slices) and
     each anchor resid_rel within 1%, printed beside the TPU artifact;
     ``classical_baselines`` in process at full width, its 9 rows within
     1.0 dB of ``artifacts/classical_baselines.json`` (the draws differ),
     with each row's per-slice spread; ``batch_frontier_ab`` (b4,
     b32_base, 64 samples; beside the others, in a thread) and
     ``results_tables``. Every child is a
     ``python -m pdunet_tpu_torch.{train,infer}`` on the card and a failed
     one raises; rows 1-4 must launch on both routes in each in-process run.
 22. cuDNN's NCHW <-> NHWC conversion kernels (nchwToNhwc, nhwcToNchw) per
     bf16 recon of pdunet_parallel, pdunet_radial and lpd_parallel at
     batch 8, from torch.profiler, beside the convolution kernels: the
     UNets and LPD's ConvNets run channels_last, so there must be none;
     where any remain, the convolution each surrounds (the op that
     launched it, its input shapes) is printed before the check fails.
     In lpd_parallel's recon the ConvNet counters (``convnet.*``) read 20
     channels_last calls and 40 padded convolutions per ``recon`` root
     span, as ``portbench/spans.py``'s ``launches`` reads them.

Output: a ``{"kernels": [...]}`` JSON line (twelve kernels: the six TPU
kernel rows, row 5 as its doubling and no-trig variants, and the trig-table
builders of both routes of the pair and of the per-angle kernels; rows 5
and 6 carry the shipped tensor-core route's times beside their own and
their probe script's records of its three plans; rows 1-4
carry their launches per train step, rows 1-2 also their launches on each
slice-B path and on pdunet_fan's, their dense-plan split-route times and
their times on the fan backing plans, rows 3-4 their launches on
sino_unet_radial's path and their times on its dense plan, and all four
their launches on the file-backed paths, rows 3-4 also on the gridding
path, where they must not run; rows 1-4 also their launches in each rank of
one sharded step per mesh, their sharded operators' per-rank times and
their worst error against the plain version over the shards, and their
launches by route in phase 21's in-process script runs), then the card's
name and power limit, then
the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import math
import pathlib
import subprocess
import sys
import time
import types

import torch

REPO = pathlib.Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet, dense): FP32 on CUDA cores,
# bf16 on tensor cores, HBM3 bandwidth. The bound of a kernel is the larger
# of its operations over the peak for its operand type and its bytes over
# the memory rate.
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def rel(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3):
    """Mean milliseconds of ``fn()`` over ``iters`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=10, flush=None):
    """Milliseconds of the device work of one ``fn()``: a sleep kernel holds
    the stream while the host enqueues the call between two CUDA events, so
    the host's launch overhead is left out; ``flush``, a buffer larger than
    the 50 MB L2 cache, is written before each call so that the call finds
    the cache cold."""
    fn()
    torch.cuda.synchronize()
    marks = []
    for _ in range(iters):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        marks.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / iters


def hgmma_counts(lib, names):
    """HGMMA (wgmma) instructions in each named kernel of a built library,
    from ``cuobjdump -sass`` (the toolkit's, else the one Triton bundles)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        import triton

        tool = str(pathlib.Path(triton.__file__).parent / "backends/nvidia/bin/cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    per_fn, fn = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            per_fn[fn] = 0
        elif fn is not None and "HGMMA" in line:
            per_fn[fn] += 1
    counts = {}
    for name in names:
        tag = f"{len(name)}{name}E"  # the mangled name's length prefix
        found = [n for f, n in per_fn.items() if tag in f]
        check(len(found) == 1, f"kernel {name} not found in {lib}")
        counts[name] = found[0]
    return counts


def pair_cost(B, N, P, K, S):
    """(flops, bytes) of one pair-group call, forward or adjoint (the same
    products transposed). Stage 1: B·P·N²·K complex-by-real MACs; stage 2:
    both members' complex phase products, B·P·N·K·2 complex MACs; stage 3:
    B·2P·K·S complex-to-real MACs. Trig evaluations are not counted.
    Bytes: the image and the sinogram block once each, the plan rows and the
    (K, S) DFT matrices once."""
    flops = 4 * B * P * N * N * K + 16 * B * P * N * K + 8 * B * P * K * S
    nbytes = 4 * (B * N * N + B * 2 * P * S + 3 * P * N + 2 * P + K + 2 * K * S)
    return flops, nbytes


def group_cost(B, N, A, K, S):
    """(flops, bytes) of one per-angle group call, forward or adjoint.
    Stage 1: B·A·N²·K complex-by-real MACs; stage 2: B·A·N·K complex MACs;
    stage 3: B·A·K·S complex-to-real MACs. Trig is not counted. Bytes: the
    image and the sinogram block once each, the two plan rows of every angle
    and the (K, S) matrices once."""
    flops = 4 * B * A * N * N * K + 8 * B * A * N * K + 4 * B * A * K * S
    nbytes = 4 * (B * N * N + B * A * S + 2 * A * N + K + 2 * K * S)
    return flops, nbytes


def bound_ms(flops, nbytes, tname):
    """Least time for the work on the card and what bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS[tname], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def split_bound_ms(cost, stage1):
    """Least time of one split-bf16 group call of ``cost = (flops, bytes)``
    (``pair_cost``'s or ``group_cost``'s) whose stage 1 (or 1ᵀ) is
    ``stage1`` of the flops: stage 1, run as three bf16 products, over the
    bf16 peak, plus stages 2-3 over the FP32 peak, against its bytes over
    the memory rate. A split kernel may beat 67 TFLOP/s, so the FP32 bound
    alone would read above 100%."""
    flops, nbytes = cost
    t_ops = 3 * stage1 / PEAK_FLOPS["bfloat16"] + (flops - stage1) / PEAK_FLOPS["float32"]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def check_kernels(kernels, errs, dtypes=(torch.float32, torch.bfloat16)):
    """Each kernel against its plain version on the same inputs, f32 and
    bf16 operands, both angle groups; records the worst errors in ``errs``."""
    for name, (call, kern, plain) in kernels.items():
        for cdt in dtypes:
            tname = str(cdt).split(".")[1]
            for g in "xy":
                out_k = call(g, cdt, kern)
                out_p = call(g, cdt, plain)
                torch.cuda.synchronize()
                check(out_k.shape == out_p.shape, f"{name} shape {out_k.shape}")
                check(bool(torch.isfinite(out_k).all()), f"{name} {tname} {g}: non-finite")
                r = rel(out_k, out_p)
                mae = float((out_k - out_p).abs().max())
                print(f"[check] {name} {tname} group {g}: rel {r:.3e} "
                      f"max_abs {mae:.3e} (tol {TOL[tname]:.0e})")
                check(r <= TOL[tname], f"{name} {tname} {g}: rel {r} > {TOL[tname]}")
                e = errs.setdefault((name, tname), [0.0, 0.0])
                e[0], e[1] = max(e[0], mae), max(e[1], r)


def time_kernels(kernels, errs, launches, cost, source, replaces, yardstick_ms, card,
                 bound_f32=None):
    """The ``{"kernels": [...]}`` entries: CUDA-event times of each kernel
    and its plain version (mean of the x and y group calls), beside the
    bound from ``cost = (flops, bytes)`` per call (``bound_f32``, a
    (ms, what) pair, replaces the float32 one where the f32 route does not
    run on the CUDA cores)."""
    entries = []
    for name, (call, kern, plain) in kernels.items():
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces[name], "launches": launches[name]}
        for cdt in (torch.bfloat16, torch.float32):
            tname = str(cdt).split(".")[1]
            fl, nb = cost
            k_ms = cuda_ms(lambda: (call("x", cdt, kern), call("y", cdt, kern))) / 2
            p_ms = cuda_ms(lambda: (call("x", cdt, plain), call("y", cdt, plain)),
                           iters=5) / 2
            bound, by = bound_ms(fl, nb, tname)
            if cdt == torch.float32 and bound_f32 is not None:
                bound, by = bound_f32
            print(f"[time] {name} {tname}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
                  f"bound {bound:.4f} ms ({by}; {fl / 1e9:.3f} GFLOP, {nb / 1e6:.3f} MB "
                  f"per call), {fl / (k_ms * 1e-3) / 1e12:.2f} TFLOP/s ({card})")
            suffix = "" if cdt == torch.bfloat16 else "_f32"
            entry.update({
                f"max_abs_err{suffix}": errs[(name, tname)][0],
                f"rel_err{suffix}": errs[(name, tname)][1],
                f"ms{suffix}": k_ms, f"plain_ms{suffix}": p_ms,
                f"bound_ms{suffix}": bound, f"bound_by{suffix}": by,
            })
        entry["library_ms"] = None
        entry["stage1_matmul_bf16_ms"] = yardstick_ms
        entry["operand_dtype"] = "bfloat16 (f32 keys: *_f32)"
        entries.append(entry)
    return entries


def recon_rate(one_recon, B, card, label):
    """Warm host-clock time of ``one_recon`` (ends in a synchronize)."""
    torch.cuda.synchronize()
    for _ in range(2):
        one_recon()
    torch.cuda.synchronize()
    reps = 10
    t0 = time.perf_counter()
    for _ in range(reps):
        one_recon()
    torch.cuda.synchronize()
    recon_s = (time.perf_counter() - t0) / reps
    print(f"[time] {label} recon_fn at batch {B}: {recon_s * 1e3:.3f} ms per batch, "
          f"{B / recon_s:.2f} slices/s ({card})")
    return recon_s


def host_ms(fn, reps=5):
    """Host milliseconds to run ``fn()`` with nothing synchronising inside
    the window (the device queue empty before it): what the host alone
    needs per call. Where it exceeds the device time, the host sets the
    pace."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total / reps * 1e3


def call_profile(fn, label, card, reps=3):
    """Device time of one ``fn()`` by kernel (torch.profiler over ``reps``
    calls): each kernel's share of the call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    total = sum(e.self_device_time_total for e in kern)
    if total == 0:
        print(f"[profile] {label}: the profiler saw no device time")
        return {}
    shares = {}
    for e in sorted(kern, key=lambda e: -e.self_device_time_total):
        name = e.key.replace("(anonymous namespace)::", "").split("(")[0].split("<")[0]
        name = name.split("::")[-1].split(" ")[-1]
        shares[name] = e.self_device_time_total / 1e3 / reps
        print(f"[profile] {label}: {shares[name]:.4f} ms per call "
              f"({e.self_device_time_total / total:.3f}) {name} ({card})")
    return shares


def split_sweep(ck, splits, call, tiles, counts, label, card):
    """Device time of the adjoint ``call(g)`` (mean of x and y) with its
    depth split forced to each of ``counts`` slices (``splits`` names the
    wrapper's split function in cuda_kernels), beside the blocks it
    launches over ``tiles`` output tiles: one block per SM fits, so
    ⌈tiles·G / n_sms⌉ waves."""
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    chosen = getattr(ck, splits)
    out = {}
    for G in counts:
        setattr(ck, splits, lambda *a, G=G: G)
        try:
            out[G] = sum(device_ms(lambda g=g: call(g)) for g in "xy") / 2
        finally:
            setattr(ck, splits, chosen)
        print(f"[time] {label}: G = {G} slices, {tiles * G} blocks "
              f"({-(-tiles * G // n_sms)} waves on {n_sms} SMs): {out[G]:.4f} ms ({card})")
    return out


def profile_recon(one_recon, card, reps=3, label="recons", gridding=False):
    """Device time of ``reps`` calls of ``one_recon`` (a recon or a train
    step) by kernel, from torch.profiler: where the time goes, and the
    device's idle share of the wall time. ``gridding`` (phase 18 only, so
    that earlier phases keep their groups) counts FFTs, gathers and segment
    sums as a group of their own. Returns {"wall_ms", "busy_ms",
    "idle_share", "groups_ms"}, each per call."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            one_recon()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a record_function range on the device's timeline (the
    # optimizer's "Optimizer.step#Adam.step") spans kernels already counted
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]
    busy_ms = sum(e.self_device_time_total for e in kern) / 1e3
    if busy_ms == 0:
        print("[profile] the profiler saw no device time")
        return {}
    groups = {}
    for e in kern:
        n = e.key
        g = ("mirror-pair projector kernels (radon_pair*.cu)" if "pair_" in n
             else "per-angle projector kernels (radon_group*.cu)"
             if "group_" in n
             else "FFTs, gathers and segment sums (gridding NUFFT, spoke transforms)"
             if gridding and any(s in n.lower() for s in ("fft", "indexselect", "segment_reduce"))
             else "convolutions" if any(s in n.lower() for s in ("conv", "gemm", "xmma", "cudnn", "wgrad", "dgrad", "implicit", "sm90"))
             else "other")
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3
    print(f"[profile] {reps} {label} under the profiler: wall {wall_ms:.3f} ms, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.3f} ({card})")
    for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f"[profile] {g}: {ms / reps:.4f} ms per call ({ms / busy_ms:.3f} of busy)")
    ranked = sorted(kern, key=lambda e: -e.self_device_time_total)
    # the top kernels, and every projector kernel
    for i, e in enumerate(ranked):
        if i < 12 or "pair_" in e.key or "group_" in e.key:
            print(f"[profile]   {e.self_device_time_total / 1e3 / reps:9.4f} ms/call "
                  f"x{e.count // reps:<4d} {e.key[:110]}")
    return {"wall_ms": wall_ms / reps, "busy_ms": busy_ms / reps,
            "idle_share": 1 - busy_ms / wall_ms,
            "groups_ms": {g: ms / reps for g, ms in groups.items()}}


#: the kernels of csrc/radon_pair_tc.cu and csrc/radon_pair_split.cu
TC_KERNELS = ("pair_tables", "pair_tc_prep", "pair_tc_fwd", "pair_tc_fwd_stage3",
              "pair_tc_adj_stage3t", "pair_tc_adj", "pair_tc_reduce")
SPLIT_KERNELS = ("pair_split_tables", "pair_split_prep", "pair_split_fwd",
                 "pair_split_fwd_stage3", "pair_split_adj_stage3t", "pair_split_adj",
                 "pair_split_reduce")


def pair_rows(plan, g):
    return [getattr(plan, f"pair_{nm}_{g}") for nm in ("pos", "sha", "shb", "sgn", "msk")]


def pair_calls(ck, plan, tabs, f, p):
    """(fwd, adj) for check_kernels: fwd(g, cdt, impl) runs a pair-forward
    implementation on the image batch f, adj(g, cdt, impl) an adjoint on
    p[g]; the wrappers get the group's trig tables (``tabs[cdt][g]``: the
    bf16 route's, or the float32 split route's), the adjoint kernels the
    image size (the plain versions read it off pos)."""
    L, N = plan.meta["S_ext"], plan.meta["N"]

    def fwd(g, cdt, impl):
        a = (f, *pair_rows(plan, g)[:4], plan.spec, plan.Wc, plan.Ws, L, g == "x", cdt)
        return impl(*a, tables=tabs[cdt][g]) if impl is ck.project_pair_group else impl(*a)

    def adj(g, cdt, impl):
        a = (p[g], *pair_rows(plan, g), plan.spec, plan.Wc, plan.Ws, L, g == "x")
        if impl is ck.backproject_pair_group:
            return impl(*a, N, cdt, tables=tabs[cdt][g])
        return impl(*a, cdt)

    return fwd, adj


def pair_counts(ck):
    """(launches, bf16 tensor-core launches, split-bf16 launches) of the
    pair wrappers, and the launches of the table builders."""
    return {"project_pair_group": (ck.project_pair_group.launches,
                                   ck.project_pair_group.launches_tc,
                                   ck.project_pair_group.launches_split),
            "backproject_pair_group": (ck.backproject_pair_group.launches,
                                       ck.backproject_pair_group.launches_tc,
                                       ck.backproject_pair_group.launches_split),
            "build_pair_tables": (ck.build_pair_tables.launches, 0, 0),
            "build_pair_split_tables": (ck.build_pair_split_tables.launches, 0, 0)}


def pair_tables(ck, plan):
    """The card's trig tables of both groups for both pair routes, checked
    bit-equal to the plain builders': {cdt: {group: tables}}."""
    L = plan.meta["S_ext"]
    args = {g: (*pair_rows(plan, g)[:3], plan.spec, L) for g in "xy"}
    return {torch.bfloat16: check_tables(ck.build_pair_tables, ck._pair_tables, args),
            torch.float32: check_tables(ck.build_pair_split_tables, ck._pair_split_tables,
                                        args)}


def route_times(ops, calls_for, cost, mm_shape, card, batches, dev, gen, cdt=torch.bfloat16,
                bound=None, key="tc"):
    """Device times per group call (mean of x and y) of each kernel's route
    at operand type ``cdt`` (``key``: "tc" for the bf16 tensor-core route,
    "split" for the f32 split-bf16 one), warm and with the L2 cache flushed
    before each call, at each batch size B, beside the bound and a
    torch.matmul of stage 1's shape in ``cdt`` (TF32 off: full f32 for
    float32). ``ops`` maps each kernel to its wrapper; ``calls_for(B)``
    gives each kernel's call(g, cdt, impl) on random inputs of batch B;
    ``cost(B)`` its (flops, bytes) per call; ``bound(B)``, if given, its
    (bound ms, what); ``mm_shape(B)`` the yardstick's (matrices, rows,
    depth, columns). Keys of float32 runs end in ``_f32``."""
    tname = str(cdt).split(".")[1]
    sfx = "" if cdt == torch.bfloat16 else "_f32"
    flush = torch.empty(64 * 2 ** 20, device=dev)  # 256 MB
    out = {op: {} for op in ops}
    for B in batches:
        calls = calls_for(B)
        fl, nb = cost(B)
        peak_bound = bound_ms(fl, nb, tname)  # the operand type's own peak
        bnd, by = bound(B) if bound is not None else peak_bound
        iters = 10 if B <= 32 else 4
        for op, impl in ops.items():
            call = calls[op]
            row = {f"ms_{key}{sfx}{mode}_b{B}":
                   sum(device_ms(lambda g=g: call(g, cdt, impl), iters, buf) for g in "xy") / 2
                   for mode, buf in (("", None), ("_cold", flush))}
            row[f"bound_ms{sfx}_b{B}"] = bnd
            if bound is not None:
                row[f"bound_ms{sfx}_{tname}_peak_b{B}"] = peak_bound[0]
            out[op].update(row)
            new_ms = row[f"ms_{key}{sfx}_b{B}"]
            print(f"[time] {op} {tname} at B={B}: {key} route {new_ms:.4f} ms warm, "
                  f"{row[f'ms_{key}{sfx}_cold_b{B}']:.4f} ms cold L2; bound "
                  f"{bnd:.4f} ms ({by}; over the {tname} peak alone {peak_bound[0]:.4f}), "
                  f"{fl / (new_ms * 1e-3) / 1e12:.1f} TFLOP/s ({card})")
        del calls
        n_mat, rows, depth, cols = mm_shape(B)
        Tm = torch.randn(n_mat, depth, cols, generator=gen, device=dev).to(cdt)
        Fm = torch.randn(rows, depth, generator=gen, device=dev).to(cdt)
        Fm = Fm.expand(n_mat, rows, depth).contiguous()
        mm = device_ms(lambda: torch.matmul(Fm, Tm), iters)
        del Fm, Tm
        print(f"[time] yardstick at B={B}: {tname} torch.matmul of stage 1's shape "
              f"({n_mat} x [{rows}x{depth}] @ [{depth}x{cols}]) {mm:.4f} ms ({card})")
        for op in out:
            out[op][f"stage1_matmul_{tname}_ms_b{B}"] = mm
    return out


def check_tables(build, plain, args_by_group):
    """The card's trig tables of each angle group against the plain builder
    on the same rows: bit-equal (the kernels form each value with the plain
    version's argument rounding and precise sincosf). Returns the tables by
    group."""
    tabs = {}
    for g, args in args_by_group.items():
        tabs[g] = build(*args)
        ref = plain(*args)
        torch.cuda.synchronize()
        pairs = list(zip(tabs[g], ref)) if isinstance(ref, tuple) else [(tabs[g], ref)]
        for t, r in pairs:
            mae = float((t.float() - r.float()).abs().max())
            print(f"[check] {build.__name__} group {g}: {tuple(t.shape)} {t.dtype} vs plain "
                  f"builder: max_abs {mae:.3e} (bit-equal: {torch.equal(t, r)})")
            check(torch.equal(t, r), f"{build.__name__} group {g}: not bit-equal")
    return tabs


def table_entry(build, plain, args, launches, replaces, path, card):
    """A trig-table builder's JSON entry: its device time for one group
    beside the plain builder's and its bound (bytes: the plan rows read
    once, the table written once). ``args`` are the builder's arguments;
    its tables were bit-equal to the plain builder's (check_tables)."""
    ms = device_ms(lambda: build(*args))
    plain_ms = cuda_ms(lambda: plain(*args), iters=5)
    tab = build(*args)
    tabs = tab if isinstance(tab, tuple) else (tab,)
    nbytes = (sum(t.numel() * t.element_size() for t in tabs)
              + 4 * sum(a.numel() for a in args if torch.is_tensor(a)))
    bound, by = bound_ms(0, nbytes, "bfloat16")
    name = build.__name__
    print(f"[time] {name} (one group, {[tuple(t.shape) for t in tabs]}, {nbytes / 1e6:.2f} MB): "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}) ({card})")
    source = {"build_pair_tables": "radon_pair_tc.cu", "build_pair_split_tables":
              "radon_pair_split.cu", "build_group_split_tables": "radon_group_split.cu"
              }.get(name, "radon_group_tc.cu")
    return {"name": name, "route": "cuda",
            "source": f"pdunet_tpu_torch/ops/radon/csrc/{source}",
            "replaces": replaces, "launches": launches, "max_abs_err": 0.0, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by, "library_ms": None,
            "path": path}


#: the kernels of csrc/radon_group_tc.cu and csrc/radon_group_split.cu
GROUP_TC_KERNELS = ("group_tc_tables", "group_tc_prep", "group_tc_fwd", "group_tc_w_prep",
                    "group_tc_round", "group_tc_fwd_stage3", "group_tc_adj_stage3t",
                    "group_tc_adj", "group_tc_reduce")
GROUP_SPLIT_KERNELS = ("group_split_tables", "group_split_prep", "group_split_fwd",
                       "group_split_fwd_stage3", "group_split_adj_stage3t", "group_split_adj",
                       "group_split_reduce")


def group_counts(ck):
    """(launches, bf16 tensor-core launches, split-bf16 launches) of the
    per-angle wrappers, and the launches of their table builders."""
    return {"project_group": (ck.project_group.launches, ck.project_group.launches_tc,
                              ck.project_group.launches_split),
            "backproject_group": (ck.backproject_group.launches,
                                  ck.backproject_group.launches_tc,
                                  ck.backproject_group.launches_split),
            "build_group_tables": (ck.build_group_tables.launches, 0, 0),
            "build_group_split_tables": (ck.build_group_split_tables.launches, 0, 0)}


def group_calls(ck, plan, tabs, f, p):
    """(fwd, adj) for check_kernels on a per-angle plan: fwd(g, cdt, impl)
    runs a per-angle forward implementation on the image batch f, adj(g,
    cdt, impl) an adjoint on p[g]; the wrappers get the group's trig tables
    (``tabs[cdt][g]``: the bf16 route's, or the float32 split route's) and
    the adjoint the image size (the plain versions read it off pos)."""
    L, N = plan.meta["S_ext"], plan.meta["N"]

    def rows(g):
        return (getattr(plan, f"pos_{g}"), getattr(plan, f"shift_{g}"), plan.spec,
                plan.Wc, plan.Ws, L, g == "x")

    def fwd(g, cdt, impl):
        if impl is ck.project_group:
            return impl(f, *rows(g), cdt, tables=tabs[cdt][g])
        return impl(f, *rows(g), cdt)

    def adj(g, cdt, impl):
        if impl is ck.backproject_group:
            return impl(p[g], *rows(g), N, cdt, tables=tabs[cdt][g])
        return impl(p[g], *rows(g), cdt)

    return fwd, adj


def group_tables(ck, plan):
    """The card's per-angle trig tables of both groups for both tensor-core
    routes, checked bit-equal to the plain builders': {cdt: {group:
    tables}}."""
    args = {g: (getattr(plan, f"pos_{g}"), getattr(plan, f"shift_{g}"), plan.spec,
                plan.meta["S_ext"]) for g in "xy"}
    return {torch.bfloat16: check_tables(ck.build_group_tables, ck._group_tables, args),
            torch.float32: check_tables(ck.build_group_split_tables, ck._group_split_tables,
                                        args)}


@contextlib.contextmanager
def plain_route(ck):
    """Send parallel.py's per-angle calls to their plain versions, run on
    the card's tensors: the reference of a whole power iteration (the main
    path never takes it)."""
    from pdunet_tpu_torch.ops.radon import parallel

    saved = parallel.project_group, parallel.backproject_group
    parallel.project_group = lambda f, *a, tables=None: ck._project_group(f, *a)
    # the plain adjoint reads N off pos: (..., contract_x, N, cdt) → (..., contract_x, cdt)
    parallel.backproject_group = lambda p, *a, tables=None: ck._backproject_group(
        p, *a[:-2], a[-1])
    try:
        yield
    finally:
        parallel.project_group, parallel.backproject_group = saved


def radial_phases(dev, card, gen):
    """Phases 6-8: the per-angle kernels and the pdunet_radial serving path.
    Returns the kernels' JSON entries and the path's summary numbers."""
    import inspect

    import numpy as np

    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.data.synth import random_phantom_batch
    from pdunet_tpu_torch.geometry import RadialGeometry
    from pdunet_tpu_torch.ops.metrics import psnr, ssim
    from pdunet_tpu_torch.ops.nufft import make_radial_ops
    from pdunet_tpu_torch.ops.nufft.fourier_slice import (
        build_fs_plan,
        fs_nufft_adjoint,
        fs_nufft_forward,
    )
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon.parallel import parallel_backproject, parallel_project
    from pdunet_tpu_torch.training.tasks import build_geometries, build_task, estimate_opnorm

    # -- 6. per-angle kernels against their plain versions -------------------
    config = get_preset("pdunet_radial")
    B = config.train.batch_size
    _, sparse = build_geometries(config.geometry)
    t0 = time.perf_counter()
    ops32 = make_radial_ops(sparse, dtype=torch.float32, device=dev)
    print(f"[chip_smoke] make_radial_ops (fourier-slice plan + Pipe-Menon DCF on the "
          f"host): {time.perf_counter() - t0:.2f} s")
    plan = ops32.plan.par_plan
    m = plan.meta
    N, S, K, L = m["N"], m["S"], m["K"], m["S_ext"]
    Bp = 2 * B   # (Re, Im) stacked along the batch
    print(f"[chip_smoke] radial plan: B'={Bp} N={N} S={S} K={K} L={L} "
          f"A_x={m['A_x']} A_y={m['A_y']} use_pairs={m['use_pairs']}")
    check(not m["use_pairs"], "the radial backing plan must not pair")
    f = torch.randn(Bp, N, N, generator=gen, device=dev)
    p = {g: torch.randn(Bp, m[f"A_{g}"], S, generator=gen, device=dev) for g in "xy"}

    # the card's trig tables (both tensor-core routes') against the plain builders
    tabs = group_tables(ck, plan)
    fwd, adj = group_calls(ck, plan, tabs, f, p)
    kernels = {
        "project_group": (fwd, ck.project_group, ck._project_group),
        "backproject_group": (adj, ck.backproject_group, ck._backproject_group),
    }
    errs = {}
    check_kernels(kernels, errs)
    # the tensor-core kernels against the plain versions of their own tiling
    # and arithmetic, which read the same (card-built) tables: bf16, and the
    # float32 split route (hi/lo operands, three products)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    bf16, f32 = torch.bfloat16, torch.float32
    split_rel = {}
    for cdt, cols in ((bf16, ck._TC_ADJ_COLS), (f32, ck._SPLIT_ADJ_COLS)):
        tname = str(cdt).split(".")[1]
        for g in "xy":
            rf = rel(fwd(g, cdt, ck.project_group),
                     ck._group_forward_tc(f, tabs[cdt][g], plan.Wc, plan.Ws, g == "x", cdt))
            G = ck.group_adjoint_splits(Bp, N, m[f"A_{g}"], n_sms, cols)
            ra = rel(adj(g, cdt, ck.backproject_group),
                     ck._group_adjoint_tc(p[g], tabs[cdt][g], plan.Wc, plan.Ws, g == "x", N, G,
                                          cdt))
            if cdt == f32:
                split_rel[g] = (rf, ra)
            print(f"[check] tensor-core per-angle ({tname} route) vs its tiled plain version, "
                  f"group {g}: fwd rel {rf:.3e}, adj rel {ra:.3e} (G = {G} slices; tol "
                  f"{TOL[tname]:.0e})")
            check(rf <= TOL[tname] and ra <= TOL[tname], "tiled plain version")
    # another batch size, and the ragged 32² radial plan (24 spokes of 64
    # samples: Np = 128 and 2Kp = 128 padded)
    small_plan = build_fs_plan(RadialGeometry(image_size=32, n_spokes=24), device=dev).par_plan
    for label, pl, B_ in (("B'=2", plan, 2), ("32² 24 spokes", small_plan, 4)):
        N_, S_ = pl.meta["N"], pl.meta["S"]
        tabs_ = tabs if pl is plan else group_tables(ck, pl)
        f_ = torch.randn(B_, N_, N_, generator=gen, device=dev)
        p_ = {g: torch.randn(B_, pl.meta[f"A_{g}"], S_, generator=gen, device=dev)
              for g in "xy"}
        fwd_, adj_ = group_calls(ck, pl, tabs_, f_, p_)
        check_kernels({f"project_group {label}": (fwd_, ck.project_group, ck._project_group),
                       f"backproject_group {label}": (adj_, ck.backproject_group,
                                                      ck._backproject_group)}, {})

    # complex adjoint dot test of the fourier-slice NUFFT (conjugating products)
    fs = ops32.plan
    x = torch.complex(torch.randn(B, N, N, generator=gen, device=dev),
                      torch.randn(B, N, N, generator=gen, device=dev))
    y = torch.complex(torch.randn(B, sparse.n_spokes, sparse.samples_per_spoke,
                                  generator=gen, device=dev),
                      torch.randn(B, sparse.n_spokes, sparse.samples_per_spoke,
                                  generator=gen, device=dev))
    c = torch.complex128
    lhs = torch.vdot(fs_nufft_forward(fs, x).flatten().to(c), y.flatten().to(c))
    rhs = torch.vdot(x.flatten().to(c), fs_nufft_adjoint(fs, y).flatten().to(c))
    dot_rel = float(abs(lhs - rhs) / abs(lhs))
    print(f"[check] fs NUFFT adjoint <Ax,y> vs <x,A^H y>: rel {dot_rel:.3e} (tol 1e-5)")
    check(dot_rel < 1e-5, f"fs NUFFT adjoint test failed: {dot_rel}")
    # float32 per-angle operators (the split route): y = A x plus a random
    # sinogram of the same norm keeps <Ax, y> near ‖Ax‖², so the mismatch
    # reads the pair's error and not a ratio of near-zero random products
    n_split = ck.project_group.launches_split, ck.backproject_group.launches_split
    xs = torch.randn(Bp, N, N, generator=gen, device=dev)
    ax = parallel_project(plan, xs)
    ys = torch.randn(ax.shape, generator=gen, device=dev)
    ys = ax + ys * (ax.norm() / ys.norm())
    lhs = torch.vdot(ax.double().flatten(), ys.double().flatten())
    rhs = torch.vdot(xs.double().flatten(), parallel_backproject(plan, ys).double().flatten())
    dot_f32 = float(abs(lhs - rhs) / abs(lhs))
    print(f"[check] radial float32 per-angle adjoint <Ax,y> vs <x,A^T y> (split-bf16 route): "
          f"rel {dot_f32:.3e} (tol 1e-5)")
    check(dot_f32 < 1e-5, f"radial float32 dot test failed: {dot_f32}")
    check(ck.project_group.launches_split == n_split[0] + 2
          and ck.backproject_group.launches_split == n_split[1] + 2,
          "the radial float32 dot test did not run the split route")
    # bf16: A and A† round different operands, so the pair is not an exact
    # transpose; the tensor-core pair must do no worse than the plain pair
    dot_bf16 = {}
    xr = torch.randn(Bp, N, N, generator=gen, device=dev)
    for g in "xy":
        yg = torch.randn(Bp, m[f"A_{g}"], S, generator=gen, device=dev)
        fwd_g, adj_g = group_calls(ck, plan, tabs, xr, {g: yg})

        def mismatch(impl_f, impl_a):
            a = fwd_g(g, bf16, impl_f)
            b = adj_g(g, bf16, impl_a)
            lhs = torch.vdot(a.double().flatten(), yg.double().flatten())
            rhs = torch.vdot(xr.double().flatten(), b.double().flatten())
            return float(abs(lhs - rhs) / abs(lhs))

        mk = mismatch(ck.project_group, ck.backproject_group)
        mp = mismatch(ck._project_group, ck._backproject_group)
        dot_bf16[g] = (mk, mp)
        print(f"[check] radial bf16 adjoint dot test, group {g}: tensor-core pair {mk:.3e}, "
              f"plain pair {mp:.3e} (tol 2 x plain + 1e-4)")
        check(mk <= 2 * mp + 1e-4, f"radial bf16 dot test group {g}: {mk} vs plain {mp}")

    # -- 7. the radial serving path at full width ------------------------------
    # counts from 0 before build_task: its power iteration runs the bf16
    # operators and builds the tables
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    task = build_task(config, device=dev)
    torch.cuda.synchronize()
    print(f"[chip_smoke] build_task({config.name}) on {dev}: "
          f"{time.perf_counter() - t0:.2f} s, sigma {task.sigma:.6g}")
    at_build = group_counts(ck)
    task.init_params(torch.Generator().manual_seed(0))
    task.model.eval()
    n_batches = 3
    data_gen = torch.Generator(device=dev).manual_seed(1234)
    results = []
    with torch.inference_mode():
        for _ in range(n_batches):
            clean = task.make_batch(data_gen)
            batch = task.batch_from_images(clean["image_c"])
            recon = task.recon_fn(task.model, batch)
            results.append((batch, recon, psnr(recon, batch["image"]),
                            ssim(recon, batch["image"])))
    torch.cuda.synchronize()
    counts = group_counts(ck)
    launches = {name: counts[name][0] for name in ("project_group", "backproject_group",
                                                   "build_group_tables",
                                                   "build_group_split_tables")}
    print(f"[chip_smoke] radial main-path launches (total, bf16 tensor-core, split): after "
          f"build_task {at_build}, after {n_batches} batches {counts}")
    check(ck.project_pair_group.launches == ck.backproject_pair_group.launches == 0
          and ck.build_pair_tables.launches == ck.build_pair_split_tables.launches == 0,
          "a pair kernel ran on the radial path")
    # build_task: the power iteration's (n + 1) bf16 A†A, 2 groups each, and
    # one bf16 table build per group. Per batch: make_batch and
    # batch_from_images each run A + the DCF adjoint in f32 on the split
    # route (2 group calls per op per batch_from_images; its tables built
    # once per group of the f32 plan, at the first synthesis), recon_fn
    # n_iters bf16 A and A†.
    n_iters = config.model.n_iters
    n_power = inspect.signature(estimate_opnorm).parameters["n_iters"].default
    check(at_build["build_group_tables"][0] == 2 and counts["build_group_tables"][0] == 2,
          "the per-angle bf16 trig tables were not built exactly once per group")
    check(at_build["build_group_split_tables"][0] == 0
          and counts["build_group_split_tables"][0] == 2,
          "the per-angle split trig tables were not built exactly once per group, at the "
          "first synthesis")
    for name in ("project_group", "backproject_group"):
        tc_build = 2 * (n_power + 1)
        check(at_build[name] == (tc_build, tc_build, 0),
              f"{name}: {at_build[name]} in build_task, expected {tc_build} on the tensor cores")
        n, n_tc, n_split = (c_ - b_ for c_, b_ in zip(counts[name], at_build[name]))
        check(n_tc == n_batches * 2 * n_iters,
              f"{name}: {n_tc} tensor-core launches in {n_batches} batches, expected "
              f"{n_batches * 2 * n_iters} (recon_fn)")
        check(n_split == n - n_tc == n_batches * 2 * 2,
              f"{name}: {n_split} split-route launches of {n - n_tc} float32 ones in "
              f"{n_batches} batches, expected {n_batches * 2 * 2} (synthesis, DCF adjoint)")
    all_ps, all_ss = [], []
    for i, (batch, recon, ps, ss) in enumerate(results):
        check(recon.shape == (B, N, N) and recon.dtype == torch.float32,
              f"radial recon {tuple(recon.shape)} {recon.dtype}")
        check(bool(torch.isfinite(recon).all()), "non-finite radial reconstruction")
        check(bool(torch.isfinite(ps).all() and torch.isfinite(ss).all()),
              "non-finite radial metrics")
        check(batch["sino"].shape == (B, sparse.n_spokes, sparse.samples_per_spoke),
              f"radial sino shape {tuple(batch['sino'].shape)}")
        f0_ps = psnr(batch["f0"].abs(), batch["image"])
        all_ps += ps.tolist()
        all_ss += ss.tolist()
        print(f"[recon] radial batch {i}: PSNR {ps.tolist()} SSIM {ss.tolist()} "
              f"(|f0| PSNR {[round(v, 2) for v in f0_ps.tolist()]})")
    # the card's synthesis + DCF adjoint against the plain path on the CPU (batch 1)
    batch = results[0][0]
    ops_cpu = make_radial_ops(sparse, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        sino_cpu = ops_cpu.A(batch["image_c"][:1].cpu())
        f0_cpu = ops_cpu.fbp(sino_cpu)
    sino_rel = rel(torch.view_as_real(batch["sino"][:1].cpu()), torch.view_as_real(sino_cpu))
    f0_rel = rel(torch.view_as_real(batch["f0"][:1].cpu()), torch.view_as_real(f0_cpu))
    print(f"[check] radial card vs CPU plain path at full size (batch 1): sino rel "
          f"{sino_rel:.3e}, f0 rel {f0_rel:.3e} (tol 1e-5 / 1e-4: the |r|-ramp of the "
          f"DCF lifts the kernels' 1e-6-level differences)")
    check(sino_rel < 1e-5 and f0_rel < 1e-4, "radial card synthesis disagrees with the CPU")
    # a cut-down float32 radial task: the whole recon on the card (every
    # per-angle call on the split route) vs on the CPU
    small = config.override({
        "geometry.image_size": 32, "geometry.n_angles": 96,
        "model.base_features": 8, "model.n_iters": 2, "model.use_bfloat16": False,
        "train.batch_size": 2})
    x0 = np.random.default_rng(0).standard_normal((32, 32))
    recons = []
    split_before = ck.project_group.launches_split
    for d in (dev, torch.device("cpu")):
        t_small = build_task(small, device=d, opnorm_x0=x0)
        with torch.inference_mode():
            mag = random_phantom_batch(torch.Generator().manual_seed(7), 2, 32,
                                       nonneg=True, device="cpu")
            ph = torch.linspace(-1.0, 1.0, 32)[None, None, :] * mag
            im = torch.polar(mag, ph).to(d)
            recons.append(t_small.recon_fn(t_small.model, t_small.batch_from_images(im)).cpu())
    small_rel = rel(recons[0], recons[1])
    print(f"[check] small f32 radial task recon (32², 24 spokes), card vs CPU: "
          f"rel {small_rel:.3e} (tol 1e-4)")
    check(small_rel < 1e-4, "small radial recon on the card disagrees with the CPU")
    check(ck.project_group.launches_split > split_before,
          "the small f32 radial task did not run the split route")

    # -- 8. timings ----------------------------------------------------------------
    def group_mean_cost(B_):
        costs = [group_cost(B_, N, m[f"A_{g}"], K, S) for g in "xy"]
        return sum(c_[0] for c_ in costs) / 2, sum(c_[1] for c_ in costs) / 2

    def group_split_bound(B_):
        stage1 = sum(4 * B_ * m[f"A_{g}"] * N * N * K for g in "xy") / 2
        return split_bound_ms(group_mean_cost(B_), stage1)

    A_g = m["A_x"]
    fl, nb = group_mean_cost(Bp)
    Tm = torch.randn(A_g, N, 2 * K, generator=gen, device=dev).to(bf16)
    Fm = f.to(bf16).reshape(1, Bp * N, N).expand(A_g, Bp * N, N).contiguous()
    mm_ms = cuda_ms(lambda: torch.matmul(Fm, Tm))
    print(f"[time] yardstick: bf16 torch.matmul of per-angle stage 1's shape "
          f"({A_g} x [{Bp * N}x{N}] @ [{N}x{2 * K}]): {mm_ms:.4f} ms ({card})")
    del Fm, Tm
    replaces = {
        "project_group": "pdunet_tpu/ops/radon/pallas_kernels.py:281",
        "backproject_group": "pdunet_tpu/ops/radon/pallas_kernels.py:309",
    }
    split_bound = group_split_bound(Bp)
    fp32_bound = bound_ms(fl, nb, "float32")
    print(f"[time] per-angle bounds per group call at B'={Bp}: split-bf16 route "
          f"{split_bound[0]:.4f} ms ({split_bound[1]}: stage 1 as 3 bf16 products at 989 "
          f"TFLOP/s, stages 2-3 at 67), FP32 CUDA cores {fp32_bound[0]:.4f} ms ({card})")
    entries = time_kernels(kernels, errs, launches, (fl, nb),
                           "pdunet_tpu_torch/ops/radon/csrc/radon_group_tc.cu", replaces,
                           mm_ms, card, bound_f32=split_bound)

    def group_inputs(B_):
        fwd_, adj_ = group_calls(
            ck, plan, tabs, torch.randn(B_, N, N, generator=gen, device=dev),
            {g: torch.randn(B_, m[f"A_{g}"], S, generator=gen, device=dev) for g in "xy"})
        return {"project_group": fwd_, "backproject_group": adj_}

    # B' = 8: the serving shape at batch 4; B' = 256: bench's batch 128
    group_ops = {"project_group": ck.project_group, "backproject_group": ck.backproject_group}
    ab = route_times(group_ops, group_inputs, group_mean_cost,
                     lambda B_: (A_g, B_ * N, N, 2 * K), card, (Bp, 256), dev, gen)
    # float32: the split-bf16 route, beside a full-f32 torch.matmul of stage
    # 1's shape (TF32 off) as the yardstick
    ab32 = route_times(group_ops, group_inputs, group_mean_cost,
                       lambda B_: (A_g, B_ * N, N, 2 * K), card, (Bp, 256), dev, gen,
                       cdt=f32, bound=group_split_bound, key="split")
    for e in entries:
        op = e["name"]
        fwd_op = op == "project_group"
        # "ms" / "ms_f32" are the device times of the routes the main path
        # takes; the back-to-back host-clocked times stay as ms_eager*
        e["ms_eager"], e["ms_eager_f32"] = e["ms"], e["ms_f32"]
        e.update(ab[op])
        e.update(ab32[op])
        e["ms"] = ab[op][f"ms_tc_b{Bp}"]
        e["ms_f32"] = ab32[op][f"ms_split_f32_b{Bp}"]
        e["bound_ms_f32_fp32"], e["bound_by_f32_fp32"] = fp32_bound
        e["launches_tc"], e["launches_split"] = counts[op][1], counts[op][2]
        e["source_f32"] = "pdunet_tpu_torch/ops/radon/csrc/radon_group_split.cu"
        e["rel_err_f32_vs_tiled_split"] = max(v[0 if fwd_op else 1] for v in split_rel.values())
        e["path"] = "pdunet_radial (B' = 2 x batch real images per group call)"
        e["operand_dtype"] = ("bfloat16 on tensor cores; f32 keys *_f32: split-bf16 route on "
                              "tensor cores, bound_ms_f32 its bound, bound_ms_f32_fp32 the FP32 "
                              "CUDA-core bound")
    group_args = (plan.pos_x, plan.shift_x, plan.spec, L)
    entries.append(table_entry(
        ck.build_group_tables, ck._group_tables, group_args, launches["build_group_tables"],
        "pdunet_tpu/ops/radon/pallas_kernels.py:99",
        "once per plan and angle group (pdunet_radial: in build_task)", card))
    entries.append(table_entry(
        ck.build_group_split_tables, ck._group_split_tables, group_args,
        launches["build_group_split_tables"], "pdunet_tpu/ops/radon/pallas_kernels.py:99",
        "once per f32 plan and angle group (pdunet_radial: at the first synthesis)", card))

    def one_recon():
        with torch.inference_mode():
            task.recon_fn(task.model, batch)

    # the adjoints' slice counts at B' = 8 (group_adjoint_splits' choice
    # among them): bf16 (128 x 256 tiles), split (128 x 128)
    group_sweep = split_sweep(
        ck, "group_adjoint_splits", lambda g: adj(g, bf16, ck.backproject_group),
        Bp * -(-N // 128) * -(-N // 256), (4, 8, 9, 16, 17, 33),
        f"backproject_group bf16 B={Bp}", card)
    group_split_sweep = split_sweep(
        ck, "group_adjoint_splits", lambda g: adj(g, f32, ck.backproject_group),
        Bp * -(-N // 128) * -(-N // 128), (2, 3, 4, 5, 8, 16),
        f"backproject_group float32 (split) B={Bp}", card)

    # each group call by kernel, on both tensor-core routes: the share of
    # stages 3 / 3ᵀ beside the products
    shares = {}
    for B_ in (Bp, 256):
        calls = group_inputs(B_)
        for op, impl in (("project_group", ck.project_group),
                         ("backproject_group", ck.backproject_group)):
            for cdt in (bf16, f32):
                key = f"{op}_b{B_}" if cdt == bf16 else f"{op}_float32_b{B_}"
                shares[key] = call_profile(
                    lambda call=calls[op], impl=impl, cdt=cdt: call("x", cdt, impl),
                    f"{op} {str(cdt).split('.')[1]} B={B_} group x", card)
        del calls

    # the whole recon, and the host's share
    recon_s = recon_rate(one_recon, B, card, config.name)
    enqueue_ms = host_ms(one_recon)
    print(f"[time] {config.name} recon_fn at batch {B}: host time to enqueue one recon "
          f"{enqueue_ms:.3f} ms ({card})")
    # the synthesis (f32 A + DCF adjoint) at batch 4 and 128 on the split route
    mag = random_phantom_batch(torch.Generator(device=dev).manual_seed(5), 128, N, nonneg=True,
                               device=dev)
    big = torch.polar(mag, torch.linspace(-1.0, 1.0, N, device=dev)[None, None, :] * mag)
    del mag
    synth = {}
    for B_, img in ((B, batch["image_c"]), (128, big)):
        synth[f"split_b{B_}"] = cuda_ms(lambda: task.batch_from_images(img),
                                        iters=10 if B_ == B else 3)
        print(f"[time] radial batch_from_images (f32 A + DCF adjoint) at batch {B_}: split "
              f"route {synth[f'split_b{B_}']:.4f} ms ({card})")
    del big
    profile_recon(one_recon, card)

    # σ of build_task's power iteration on the bf16 operators, on the
    # tensor-core route and on the plain versions
    ops_bf16 = make_radial_ops(sparse, dtype=bf16, device=dev)
    sigmas = {}
    for key in ("tc", "plain"):
        with plain_route(ck) if key == "plain" else contextlib.nullcontext():
            sigmas[key] = estimate_opnorm(ops_bf16.A, ops_bf16.At, (N, N), device=dev,
                                          is_complex=True)
    sigma_rel = abs(sigmas["tc"] - sigmas["plain"]) / sigmas["plain"]
    print(f"[check] radial sigma (power iteration, bf16 operators): tensor cores "
          f"{sigmas['tc']:.6g}, plain versions {sigmas['plain']:.6g}, rel {sigma_rel:.3e} "
          f"(tol 5e-3)")
    check(sigma_rel <= TOL["bfloat16"], "radial sigma moved beyond the bf16 tolerance")
    stats = {"recon_slices_per_s": B / recon_s, "recon_ms_per_batch": recon_s * 1e3,
             "synth_ms": synth[f"split_b{B}"], "batch_from_images_ms": synth, "batch": B,
             "psnr_mean": float(np.mean(all_ps)), "ssim_mean": float(np.mean(all_ss)),
             "adjoint_dot_rel": dot_rel, "adjoint_dot_rel_f32": dot_f32,
             "host_enqueue_ms": enqueue_ms, "call_profile_ms": shares,
             "adjoint_split_sweep_b8": group_sweep,
             "split_adjoint_split_sweep_b8": group_split_sweep,
             "bf16_dot_test": dot_bf16, "sigma": task.sigma, "sigma_routes": sigmas,
             "sino_rel_cpu": sino_rel, "f0_rel_cpu": f0_rel, "small_rel_cpu": small_rel}
    return entries, stats


#: the probe kernels (row 5: csrc/radon_pair_proto_tc.cu; row 6:
#: csrc/radon_proto_tc.cu) and the Pallas kernels they replace
PROBE_REPLACES = {
    "project_pair_group_doubling": "scripts/trig_proto.py:169",
    "project_pair_group_notrig": "scripts/trig_proto.py:169",
    "project_group_packed": "scripts/pack_proto.py:102",
    "backproject_group_packed": "scripts/pack_proto.py:127",
}
#: the kernels of csrc/radon_proto_tc.cu; the first six are row 6's
#: stage-1 / 1ᵀ products (bf16 with exact and doubling trig; split, exact)
PROTO_TC_KERNELS = tuple(f"proto_tc_{op}{d}" for op in ("fwd", "adj") for d in ("", "_dbl")) + (
    "proto_split_fwd", "proto_split_adj",
    "proto_tc_prep", "proto_tc_round", "proto_tc_w4_prep", "proto_tc_w_prep",
    "proto_tc_fwd_stage3", "proto_tc_adj_stage3t", "proto_split_fwd_stage3",
    "proto_split_adj_stage3t", "proto_tc_reduce")
#: the kernels of csrc/radon_pair_proto_tc.cu; the first four are row 5's
#: stage-1 products (bf16 and split; doubling and no-trig bodies)
PAIR_PROTO_TC_KERNELS = tuple(f"pair_proto_{r}_fwd_{b}" for r in ("tc", "split")
                              for b in ("dbl", "notrig")) + (
    "pair_proto_prep", "pair_proto_prep_f16", "pair_proto_tc_stage3", "pair_proto_split_stage3")
@contextlib.contextmanager
def fp16_parts(ck):
    """``ck._split`` making fp16 hi and lo parts (in the input's dtype)
    while it is active: the split products of row 5's no-trig f32 kernel."""
    split = ck._split

    def split16(x):
        hi = x.to(torch.float16).to(x.dtype)
        return hi, (x - hi).to(torch.float16).to(x.dtype)

    ck._split = split16
    try:
        yield split16
    finally:
        ck._split = split


def pair_own_arithmetic(ck, x, trig, sgn, Wc, Ws, contract_x, cdt, fp16=False):
    """Row 5's tensor-core forward in its own arithmetic and order
    (``ck._pair_forward_tc``) from its six (P, N, K) f32 trig tensors, put
    in tables: bf16; split into bf16 hi and lo parts; or (``fp16``, the
    no-trig f32 kernel) into fp16 parts, F too."""
    if cdt == torch.bfloat16:
        return ck._pair_forward_tc(x, ck._interleave(trig, cdt), sgn, Wc, Ws, contract_x, cdt)
    if not fp16:
        return ck._pair_forward_tc(x, ck._split_tables(trig), sgn, Wc, Ws, contract_x, cdt)
    tab = ck._interleave(trig, torch.float32)
    with fp16_parts(ck) as split16:
        return ck._pair_forward_tc(x, (torch.stack(split16(tab[0])), tab[1:]), sgn, Wc, Ws,
                                   contract_x, cdt)


#: pack_proto's plans (phase 9), which phase 10 checks row 6 on too
PROBE_PLANS = ("flagship", "radial", "radial-dense")


def probe_phases(dev, card, gen):
    """Phases 9-11: the two kernel probes as a user runs them, their kernels
    against their plain versions (rows 5 and 6 also against the shipped
    tensor-core routes), and their timings. Returns the kernels' JSON
    entries."""
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon import proto_kernels as pk
    from pdunet_tpu_torch.scripts import pack_proto, trig_proto

    # -- 9. the probe scripts (trig_proto and pack_proto, each on its three
    # plans): counts from 0 around them
    pk.reset_launch_counts()
    trig_records, records = {}, {}
    for name in trig_proto.PLANS:
        t0 = time.perf_counter()
        trig_records[name] = trig_proto.run(name, "cuda")
        print(f"[chip_smoke] trig_proto --plan {name}: {time.perf_counter() - t0:.1f} s")
    for name in PROBE_PLANS:
        t0 = time.perf_counter()
        records[name] = pack_proto.run(name, "cuda")
        print(f"[chip_smoke] pack_proto --plan {name}: {time.perf_counter() - t0:.1f} s")
    torch.cuda.synchronize()
    launches = {name: getattr(pk, name).launches for name in PROBE_REPLACES}
    print(f"[chip_smoke] probe-script launches: {launches}")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched by the probe scripts")

    # -- 10. each probe kernel against its plain version at the probes' shapes
    plan, f = trig_proto.setup(dev)
    m = plan.meta
    B, N, S, K, L = f.shape[0], m["N"], m["S"], m["K"], m["S_ext"]
    print(f"[chip_smoke] probe plan: B={B} N={N} S={S} K={K} L={L} P_x={m['P_x']} "
          f"P_y={m['P_y']} A_x={m['A_x']} A_y={m['A_y']}")

    def pair_of(pl, g):
        return [getattr(pl, f"pair_{nm}_{g}") for nm in ("pos", "sha", "shb", "sgn")]

    def pair(g):
        return pair_of(plan, g)

    def group_rows(pl, g):
        return (getattr(pl, f"pos_{g}"), getattr(pl, f"shift_{g}"), pl.spec, pl.Wc, pl.Ws,
                pl.meta["S_ext"], g == "x")

    def rows(g):
        return group_rows(plan, g)

    def seeds_of(pl, g):
        return [torch.from_numpy(s).to(dev)
                for s in pk.phase_seeds(*pair_of(pl, g)[:3], pl.meta["K"], pl.meta["S_ext"])]

    seeds = {g: seeds_of(plan, g) for g in "xy"}
    p = {g: torch.randn(B, m[f"A_{g}"], S, generator=gen, device=dev) for g in "xy"}

    def dbl(g, cdt, impl):
        return impl(f, *seeds[g], pair(g)[3], plan.spec, plan.Wc, plan.Ws, g == "x", cdt)

    def notrig(g, cdt, impl):
        return impl(f, *pair(g), plan.spec, plan.Wc, plan.Ws, L, g == "x", cdt)

    def pfwd(g, cdt, impl):
        return impl(f, *rows(g), cdt)

    def padj(g, cdt, impl):
        return (impl(p[g], *rows(g), cdt) if impl is pk._backproject_group_packed
                else impl(p[g], *rows(g), N, cdt))

    kernels = {
        "project_pair_group_doubling": (dbl, pk.project_pair_group_doubling,
                                        pk._project_pair_group_doubling),
        "project_pair_group_notrig": (notrig, pk.project_pair_group_notrig,
                                      pk._project_pair_group_notrig),
        "project_group_packed": (pfwd, pk.project_group_packed, pk._project_group_packed),
        "backproject_group_packed": (padj, pk.backproject_group_packed,
                                     pk._backproject_group_packed),
    }
    errs = {}
    check_kernels(kernels, errs)
    bf16, f32 = torch.bfloat16, torch.float32
    for g in "xy":
        # the packed kernels with exact trig in bf16 (the probe's like-with-like pair)
        r = rel(pk.project_group_packed(f, *rows(g), bf16, doubling=False),
                pk._project_group_packed(f, *rows(g), bf16, doubling=False))
        ra = rel(pk.backproject_group_packed(p[g], *rows(g), N, bf16, doubling=False),
                 pk._backproject_group_packed(p[g], *rows(g), bf16, doubling=False))
        print(f"[check] packed tensor-core exact-trig bf16 group {g}: fwd rel {r:.3e}, adj rel "
              f"{ra:.3e} (tol 5e-3)")
        check(r <= TOL["bfloat16"] and ra <= TOL["bfloat16"],
              "packed tensor-core exact-trig kernel")

    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan
    from pdunet_tpu_torch.ops.radon.fan import build_fan_plan
    from pdunet_tpu_torch.training.tasks import build_geometries

    # rows that do not fill a tile (96², Np = 128), pdunet_fan's backing plan
    # (sign +1 pairs, odd S = 251, K = 179) and N > 256: the forwards' depth
    # windows (384²: Np = 384, three windows of 128; 512²: two of 256, K = 335)
    extra = {"parallel96": build_parallel_plan(
                 ParallelGeometry(image_size=96, n_angles=96).subsample(4), device=dev),
             "fan": build_fan_plan(build_geometries(get_preset("pdunet_fan").geometry)[1],
                                   device=dev).par_plan}
    for n_ in (384, 512):
        extra[f"parallel{n_}"] = build_parallel_plan(
            ParallelGeometry(image_size=n_, n_angles=96).subsample(4), device=dev)

    # row 5's tensor-core kernels on every probe shape, both groups, bf16 and
    # f32: against the plain versions (≤ 5e-3 / ≤ 1e-5), against the plain
    # version of their own arithmetic (pair_own_arithmetic: the same trig in
    # tables, bf16 or split into hi and lo), and doubling against the
    # shipped tensor-core route from the plan's tables (< 2e-2, the probe's
    # check). The images come from a generator of their own, so that these
    # checks draw the same inputs whichever phases ran before.
    row5 = {}
    gen5 = torch.Generator(device=dev).manual_seed(5)
    shapes5 = [("flagship", plan, B), ("dense", trig_proto.plan_for("dense", dev, False)[0], 8),
               ("fan", extra["fan"], 4), ("parallel96", extra["parallel96"], 4),
               ("parallel384", extra["parallel384"], 2),
               ("parallel512", extra["parallel512"], 2)]
    for name, pl, Bs in shapes5:
        n_, K_, L_ = pl.meta["N"], pl.meta["K"], pl.meta["S_ext"]
        x = torch.randn(Bs, n_, n_, generator=gen5, device=dev)
        for g in "xy":
            pr = pair_of(pl, g)
            sd = seeds_of(pl, g)
            consts = (pl.spec, pl.Wc, pl.Ws)
            tabs = {bf16: ck.build_pair_tables(*pr[:3], pl.spec, L_),
                    f32: ck.build_pair_split_tables(*pr[:3], pl.spec, L_)}
            trig = {"project_pair_group_doubling": pk._doubling_pair_trig(*sd, pl.spec, n_),
                    "project_pair_group_notrig": pk._notrig_pair_trig(*pr[:3], pl.spec, L_)}
            for cdt in (bf16, f32):
                tname = str(cdt).split(".")[1]
                outs = {"project_pair_group_doubling": (
                            pk.project_pair_group_doubling(x, *sd, pr[3], *consts, g == "x", cdt),
                            pk._project_pair_group_doubling(x, *sd, pr[3], *consts, g == "x",
                                                            cdt)),
                        "project_pair_group_notrig": (
                            pk.project_pair_group_notrig(x, *pr, *consts, L_, g == "x", cdt),
                            pk._project_pair_group_notrig(x, *pr, *consts, L_, g == "x", cdt))}
                for kname, (o, r_) in outs.items():
                    own = pair_own_arithmetic(ck, x, trig[kname], pr[3], pl.Wc, pl.Ws, g == "x",
                                              cdt, fp16=kname == "project_pair_group_notrig")
                    torch.cuda.synchronize()
                    check(bool(torch.isfinite(o).all()), f"row 5 {kname} {name}: non-finite")
                    e, e_own = rel(o, r_), rel(o, own)
                    mae = float((o - r_).abs().max())
                    print(f"[check] row 5 {kname} {name} B={Bs} group {g} {tname}: vs plain rel "
                          f"{e:.3e} max_abs {mae:.3e}, vs its own arithmetic rel {e_own:.3e} "
                          f"(tol {TOL[tname]:.0e})")
                    check(e <= TOL[tname] and e_own <= TOL[tname],
                          f"row 5 {kname} {name} {g} {tname}: rel {e} / {e_own}")
                    ent = errs.setdefault((kname, tname), [0.0, 0.0])
                    ent[0], ent[1] = max(ent[0], mae), max(ent[1], e)
                    row5.setdefault(f"{kname}/{name}_{tname}_vs_plain", []).append(e)
                    row5.setdefault(f"{kname}/{name}_{tname}_vs_own_arithmetic", []).append(e_own)
                    del own
                shipped = ck.project_pair_group(x, *pr, *consts, L_, g == "x", cdt,
                                                tables=tabs[cdt])
                e = rel(outs["project_pair_group_doubling"][0], shipped)
                print(f"[check] row 5 doubling-tc vs the shipped tensor-core route, {name} B={Bs} "
                      f"group {g} {tname}: rel {e:.3e} (tol 2e-2)")
                check(e < 2e-2, f"row 5 doubling drifts from the shipped route, {name} {g}")
                row5.setdefault(f"project_pair_group_doubling/{name}_{tname}_vs_shipped",
                                []).append(e)
                del outs, shipped
            del tabs, trig
        del x
        torch.cuda.empty_cache()
    row5 = {k: max(v) for k, v in row5.items()}

    # row 6's tensor-core kernels on every probe shape: against the plain
    # version (bf16 doubling and exact trig ≤ 5e-3, f32 ≤ 1e-5), against the
    # shipped tensor-core route reading the plan's tables (bf16 exact trig
    # ≤ 5e-3, f32 ≤ 1e-5) and the f32 dot test (y = A x + noise: the split
    # products' ~4e-6 error would dominate the ratio of two near-zero
    # products of a random y)
    row6 = {}
    shapes = [("flagship", plan, B, "xy")]
    for name in PROBE_PLANS[1:]:
        shapes.append((name, pack_proto.plan_for(name, dev, small=False)[0], 8, "xy"))
    shapes += [(name, extra[name], 4 if name in ("parallel96", "fan") else 2, "xy")
               for name in ("parallel96", "fan", "parallel384", "parallel512")]
    for name, pl, Bs, groups in shapes:
        n_ = pl.meta["N"]
        targs = {g: (getattr(pl, f"pos_{g}"), getattr(pl, f"shift_{g}"), pl.spec,
                     pl.meta["S_ext"]) for g in groups}
        for g in groups:
            A_ = pl.meta[f"A_{g}"]
            tabs = {bf16: ck.build_group_tables(*targs[g]),
                    f32: ck.build_group_split_tables(*targs[g])}
            x = torch.randn(Bs, n_, n_, generator=gen, device=dev)
            y = torch.randn(Bs, A_, pl.meta["S"], generator=gen, device=dev)
            rw = group_rows(pl, g)
            for cdt, dbl_ in ((bf16, None), (bf16, False), (f32, None)):
                tname = str(cdt).split(".")[1]
                label = f"{name} B={Bs} group {g} {tname}" + (
                    " exact trig" if dbl_ is False else (" doubling" if cdt == bf16 else ""))
                out_f = pk.project_group_packed(x, *rw, cdt, doubling=dbl_)
                out_a = pk.backproject_group_packed(y, *rw, n_, cdt, doubling=dbl_)
                ref_f = pk._project_group_packed(x, *rw, cdt, doubling=dbl_)
                ref_a = pk._backproject_group_packed(y, *rw, cdt, doubling=dbl_)
                torch.cuda.synchronize()
                for op, o, r_ in (("fwd", out_f, ref_f), ("adj", out_a, ref_a)):
                    check(bool(torch.isfinite(o).all()), f"row 6 {op} {label}: non-finite")
                    e = rel(o, r_)
                    mae = float((o - r_).abs().max())
                    print(f"[check] row 6 packed-tc {op} {label} vs plain: rel {e:.3e} max_abs "
                          f"{mae:.3e} (tol {TOL[tname]:.0e})")
                    check(e <= TOL[tname], f"row 6 packed-tc {op} {label}: rel {e}")
                    key = ("project_group_packed" if op == "fwd" else "backproject_group_packed",
                           tname)
                    ent = errs.setdefault(key, [0.0, 0.0])
                    ent[0], ent[1] = max(ent[0], mae), max(ent[1], e)
                    row6.setdefault(f"{name}_{op}_{tname}_vs_plain", []).append(e)
                del ref_f, ref_a
                if cdt == bf16 and dbl_ is None:
                    continue  # the shipped route's trig is exact
                sf = ck.project_group(x, *rw, cdt, tables=tabs[cdt])
                sa = ck.backproject_group(y, *rw, n_, cdt, tables=tabs[cdt])
                ef, ea = rel(out_f, sf), rel(out_a, sa)
                print(f"[check] row 6 packed-tc vs the shipped tensor-core route, {label}: fwd "
                      f"rel {ef:.3e}, adj rel {ea:.3e} (tol {TOL[tname]:.0e})")
                check(ef <= TOL[tname] and ea <= TOL[tname],
                      f"row 6 packed-tc differs from the shipped route, {label}")
                row6.setdefault(f"{name}_{tname}_vs_shipped", []).append(max(ef, ea))
            ax = pk.project_group_packed(x, *rw, f32)
            yd = ax + 0.1 * ax.std() * torch.randn(ax.shape, generator=gen, device=dev)
            lhs = torch.vdot(ax.double().flatten(), yd.double().flatten())
            rhs = torch.vdot(x.double().flatten(),
                             pk.backproject_group_packed(yd, *rw, n_, f32).double().flatten())
            dot_rel = float(abs(lhs - rhs) / abs(lhs))
            print(f"[check] row 6 packed-tc f32 adjoint <Ax,y> vs <x,A^T y>, {name} B={Bs} "
                  f"group {g} (y = A x + noise): rel {dot_rel:.3e} (tol 1e-5)")
            check(dot_rel < 1e-5, f"row 6 packed-tc adjoint test failed: {dot_rel}")
            row6.setdefault(f"{name}_dot_rel_f32", []).append(dot_rel)
            del tabs, x, y, ax, yd
            torch.cuda.empty_cache()
    row6 = {k: max(v) for k, v in row6.items()}
    del extra

    # -- 11. timings beside the bound, the plain version and a matmul yardstick
    Tm = torch.randn(m["P_x"], N, 2 * K, generator=gen, device=dev).to(bf16)
    Fm = f.to(bf16).reshape(1, B * N, N).expand(m["P_x"], B * N, N).contiguous()
    pair_mm = cuda_ms(lambda: torch.matmul(Fm, Tm))
    Tm = torch.randn(m["A_x"], N, 2 * K, generator=gen, device=dev).to(bf16)
    Fm = f.to(bf16).reshape(1, B * N, N).expand(m["A_x"], B * N, N).contiguous()
    group_mm = cuda_ms(lambda: torch.matmul(Fm, Tm))
    del Tm, Fm
    print(f"[time] yardsticks: bf16 torch.matmul of stage 1's shape, pair "
          f"({m['P_x']} x [{B * N}x{N}] @ [{N}x{2 * K}]) {pair_mm:.4f} ms, per-angle "
          f"({m['A_x']} x ...) {group_mm:.4f} ms ({card})")

    def mean_cost(cost, counts, extra=0):
        fl = sum(cost(B, N, c, K, S)[0] + extra * B * c * K * S for c in counts) / 2
        return fl, sum(cost(B, N, c, K, S)[1] for c in counts) / 2

    pairs, angles = (m["P_x"], m["P_y"]), (m["A_x"], m["A_y"])
    # stage 1's share of the flops, for the split bound (pairs / angles)
    stage1 = {"pair": sum(4 * B * c * N * N * K for c in pairs) / 2,
              "group": sum(4 * B * c * N * N * K for c in angles) / 2}
    # packed stage 3 multiplies 4K rows of [Wc; Wc; −Ws; −Ws]: 4·B·A·K·S more FLOPs
    costs = {"project_pair_group_doubling": (mean_cost(pair_cost, pairs), pair_mm, "pair"),
             "project_pair_group_notrig": (mean_cost(pair_cost, pairs), pair_mm, "pair"),
             "project_group_packed": (mean_cost(group_cost, angles, extra=4), group_mm, "group"),
             "backproject_group_packed": (mean_cost(group_cost, angles), group_mm, "group")}
    tables = {g: {bf16: ck.build_group_tables(*rows(g)[:3], L),
                  f32: ck.build_group_split_tables(*rows(g)[:3], L)} for g in "xy"}
    pair_tabs = {g: {bf16: ck.build_pair_tables(*pair(g)[:3], plan.spec, L),
                     f32: ck.build_pair_split_tables(*pair(g)[:3], plan.spec, L)} for g in "xy"}
    entries = []

    def mean_ms(fn):
        return cuda_ms(lambda: [fn(g) for g in "xy"]) / 2

    for name, kern in kernels.items():
        cost, mm, kind = costs[name]
        fwd_op = name != "backproject_group_packed"
        row5_ = kind == "pair"
        # both rows' f32 routes are split-bf16 on the tensor cores: their
        # bound is stage 1 three times over the bf16 peak plus the rest over FP32
        src = "radon_pair_proto_tc.cu" if row5_ else "radon_proto_tc.cu"
        entries += time_kernels({name: kern}, errs, launches, cost,
                                f"pdunet_tpu_torch/ops/radon/csrc/{src}",
                                PROBE_REPLACES, mm, card,
                                bound_f32=split_bound_ms(cost, stage1[kind]))
        e = entries[-1]
        for cdt in (bf16, f32):
            sfx = "" if cdt == bf16 else "_f32"
            if row5_:
                e[f"shipped_tc_ms{sfx}"] = mean_ms(
                    lambda g, c=cdt: ck.project_pair_group(f, *pair(g), plan.spec, plan.Wc,
                                                           plan.Ws, L, g == "x", c,
                                                           tables=pair_tabs[g][c]))
            else:
                shipped = ck.project_group if fwd_op else ck.backproject_group
                e[f"shipped_tc_ms{sfx}"] = mean_ms(
                    lambda g, c=cdt: (shipped(f, *rows(g), c, tables=tables[g][c]) if fwd_op else
                                      shipped(p[g], *rows(g), N, c, tables=tables[g][c])))
        if row5_:
            e["checks"] = {k.split("/", 1)[1]: v for k, v in row5.items()
                           if k.startswith(name + "/")}
            e["probe_plans"] = {pname: {bk: rec[bk] for bk in rec if bk.startswith("B")}
                                for pname, rec in trig_records.items()}
            e["table_build_ms"] = {pname: rec.get("table_build_ms")
                                   for pname, rec in trig_records.items()}
            e["operand_dtype"] = ("bfloat16 on tensor cores (T̂ and both members' φ made on "
                                  "chip); *_f32: split-bf16 on tensor cores; shipped_tc_ms: "
                                  "project_pair_group from the trig tables (radon_pair_tc.cu / "
                                  "radon_pair_split.cu)")
            print(f"[time] {name}: tensor-core {e['ms']:.4f} / {e['ms_f32']:.4f} ms (bf16 / "
                  f"f32); shipped tensor-core {e['shipped_tc_ms']:.4f} / "
                  f"{e['shipped_tc_ms_f32']:.4f} (B={B}, mean of x and y) ({card})")
            continue
        e["exact_trig_ms"] = mean_ms(
            lambda g: (pk.project_group_packed(f, *rows(g), bf16, doubling=False) if fwd_op
                       else pk.backproject_group_packed(p[g], *rows(g), N, bf16, doubling=False)))
        other_op = "_adj_" if fwd_op else "_fwd_"
        e["checks"] = {k: v for k, v in row6.items() if other_op not in k}
        op = "fwd" if fwd_op else "adj"
        e["probe_plans"] = {pname: {bk: {tn: rec[bk][tn][op] for tn in rec[bk]}
                                    for bk in rec if bk.startswith("B")}
                            for pname, rec in records.items()}
        e["table_build_ms"] = {pname: rec.get("table_build_ms") for pname, rec in records.items()}
        e["operand_dtype"] = ("bfloat16 (doubling trig; exact_trig_ms: exact) on tensor cores; "
                              "*_f32: split-bf16 on tensor cores, exact trig; shipped_tc_ms: "
                              "project_group / backproject_group from the trig tables")
        print(f"[time] {name}: packed-tc {e['ms']:.4f} / {e['ms_f32']:.4f} ms (bf16 doubling / "
              f"f32), exact trig {e['exact_trig_ms']:.4f}; shipped tensor-core "
              f"{e['shipped_tc_ms']:.4f} / {e['shipped_tc_ms_f32']:.4f} (B={B}, mean of x and "
              f"y) ({card})")
    del tables, pair_tabs
    for e in entries:
        e["path"] = ("probe scripts (pdunet_tpu_torch.scripts.trig_proto / pack_proto), "
                     "flagship plan, B=32")
    return entries


def bench_phase(card):
    """Phase 12: bench's headline path on the card at batch 32 (the full
    batch-256 headline is a separate run); counts from 0 around it."""
    import io

    from pdunet_tpu_torch import bench
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon import proto_kernels as pk

    ck.reset_launch_counts()
    pk.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = bench.main(["--batch", "32"])
    torch.cuda.synchronize()
    check(rc == 0, f"bench exited {rc}")
    row = json.loads(out.getvalue().strip().splitlines()[0])
    print(json.dumps(row))
    n_fwd, n_adj = ck.project_pair_group.launches, ck.backproject_pair_group.launches
    print(f"[chip_smoke] bench headline path (batch 32): pair launches {n_fwd} / {n_adj}, "
          f"{row['value']} slices/s ({card})")
    check(row["metric"] == "pdunet_256_sparse_ct_recon_throughput" and "vs_baseline" not in row,
          f"bench headline row {row}")
    check(row["value"] > 0 and row["device"] == torch.cuda.get_device_name(0),
          f"bench headline value {row}")
    check(n_fwd > 0 and n_adj > 0, "bench's headline did not run the pair kernels")
    check(ck.project_group.launches == ck.backproject_group.launches == 0,
          "a per-angle kernel ran on bench's headline path")
    check(all(getattr(pk, n).launches == 0 for n in PROBE_REPLACES),
          "a probe kernel ran on bench's headline path")
    return row


#: train-step launches per route (tensor-core bf16, split-bf16 f32) of a
#: PD-UNet with n_iters = 4, derived from the code: the unroll runs 4 A and
#: 4 A† (2 group calls each); the backward runs A for the vjp of each A†
#: (4) and A† for the vjp of A in iterations 2-4 (iteration 1's A(f0) needs
#: no gradient); make_batch runs one f32 A and one f32 direct recon
TRAIN_STEP_LAUNCHES = {"fwd": {"tc": 16, "split": 2}, "adj": {"tc": 14, "split": 2}}


def _route_counts(ck, fwd, adj):
    return {"fwd": {"tc": fwd.launches_tc, "split": fwd.launches_split, "all": fwd.launches},
            "adj": {"tc": adj.launches_tc, "split": adj.launches_split, "all": adj.launches}}


def _other_launches(ck, pk, radial):
    """Launches of every kernel the path must not run: the probes and the
    other geometry's projector."""
    other = ([ck.project_pair_group, ck.backproject_pair_group] if radial
             else [ck.project_group, ck.backproject_group])
    other += [getattr(pk, n) for n in PROBE_REPLACES]
    return sum(fn.launches for fn in other)


def step_timings(step, state, data, B, name, card, reps=10) -> dict:
    """A train step's time (host clock over ``reps`` steps ending in a
    synchronize), its split between CUDA events (synthesis, forward with
    the loss, backward, optimizer), the profiler's idle share and by-kind
    device time, and peak memory; the steps draw from ``data``."""
    from pdunet_tpu_torch.training import loop

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mem = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    for i in range(reps):
        step(state, data.manual_seed(10 + i))
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / reps * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    split = {}
    for i in range(5):
        marks = []
        step(state, data.manual_seed(20 + i), marks)
        for k, v in loop.split_ms(marks).items():
            split[k] = split.get(k, 0.0) + v / 5
    prof = profile_recon(lambda: step(state, data.manual_seed(30)), card, label="train steps")
    print(f"[time] {name} train step at batch {B}: {step_ms:.3f} ms ({B / step_ms * 1e3:.2f} "
          f"slices/s), split by CUDA events {({k: round(v, 4) for k, v in split.items()})} "
          f"ms, peak memory {peak_gb:.3f} GiB ({base_mem / 2**30:.3f} GiB resident before "
          f"the steps) ({card})")
    return {"step_ms": step_ms, "split_ms": split, "peak_gb": peak_gb, "profile": prof}


class _Crash(Exception):
    """The simulated failure of a training run (phase 13's resume check)."""


def train_phases(dev, card):
    """Phase 13: training on the card. Per preset at full width (batch 4):
    a few steps of ``train()`` (finite losses, nonzero finite gradient norms,
    every parameter moved, launch counts of the whole run from 0), the
    launches of one step after a warm one against TRAIN_STEP_LAUNCHES, and
    the step's time, split, idle share and peak memory; a cut-down f32 step
    on card and CPU from the same weights and images; the golden-size runs
    (tests/test_goldens.py's config, the port's own draws) against their
    untrained eval; and at golden size a crashed and resumed run against an
    uninterrupted one (cuDNN deterministic), restored by ``infer``."""
    import io
    import os
    import shutil
    import tempfile

    from pdunet_tpu_torch import infer
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon import proto_kernels as pk
    from pdunet_tpu_torch.training import loop
    from pdunet_tpu_torch.training.checkpoint import CheckpointManager
    from pdunet_tpu_torch.training.tasks import build_task, estimate_opnorm

    stats = {}
    n_power = inspect.signature(estimate_opnorm).parameters["n_iters"].default
    # -- 13a. full-width steps of train(), both presets -----------------------
    for name in ("pdunet_parallel", "pdunet_radial"):
        radial = name == "pdunet_radial"
        fwd, adj = ((ck.project_group, ck.backproject_group) if radial
                    else (ck.project_pair_group, ck.backproject_pair_group))
        config = get_preset(name).override({"train.log_every": 1})
        n_iters, B = config.model.n_iters, config.train.batch_size
        check(n_iters == 4 and B == 4, f"{name}: expected 4 iterations at batch 4")
        n_steps = 4
        ck.reset_launch_counts()
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        res = loop.train(config, steps=n_steps, device=dev, verbose=False)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        counts = _route_counts(ck, fwd, adj)
        n_val = -(-config.train.val_slices // B)
        losses = [h["loss"] for h in res.history]
        norms = [h["grad_norm"] for h in res.history]
        print(f"[train] {name} train({n_steps} steps, batch {B}) on the card: {run_s:.2f} s "
              f"with build_task and {n_val} val batches; losses {losses}, grad norms "
              f"{norms}, final eval {res.final_eval}; launches {counts}")
        check(len(losses) == n_steps and all(math.isfinite(v) for v in losses),
              f"{name}: non-finite loss {losses}")
        check(all(math.isfinite(v) and v > 0 for v in norms), f"{name}: grad norms {norms}")
        trained = [p.detach().clone() for p in res.task.model.parameters()]
        res.task.init_params(torch.Generator().manual_seed(
            loop.derive_seed(config.train.seed, loop.INIT_STREAM)))
        still = [n for (n, p), q in zip(res.task.model.named_parameters(), trained)
                 if torch.equal(p.detach(), q)]
        check(not still, f"{name}: parameters that did not move: {still[:5]}")
        # the whole run from 0: build_task's power iteration (bf16), the
        # steps, the validation batches' synthesis and the final eval's recon
        want = {"fwd": {"tc": 2 * (n_power + 1) + n_steps * 16 + n_val * 2 * n_iters,
                        "split": (n_steps + n_val) * 2},
                "adj": {"tc": 2 * (n_power + 1) + n_steps * 14 + n_val * 2 * n_iters,
                        "split": (n_steps + n_val) * 2}}
        for op in ("fwd", "adj"):
            check({k: counts[op][k] for k in ("tc", "split")} == want[op]
                  and counts[op]["all"] == sum(want[op].values()),
                  f"{name} train(): {op} launches {counts[op]}, expected {want[op]}")
        check(_other_launches(ck, pk, radial) == 0,
              f"{name}: a probe or other-geometry kernel ran in train()")

        # one step's launches, after a warm step
        task = res.task
        state = loop.build_state(task, n_steps=100)
        step = loop.make_train_step(task)
        data = torch.Generator(device=dev)
        step(state, data.manual_seed(0))
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        pk.reset_launch_counts()
        n_counted = 3
        for i in range(n_counted):
            step(state, data.manual_seed(1 + i))
        torch.cuda.synchronize()
        counts = _route_counts(ck, fwd, adj)
        per_step = {op: {k: counts[op][k] / n_counted for k in ("tc", "split")}
                    for op in ("fwd", "adj")}
        print(f"[train] {name} launches per train step (after a warm one; fwd = "
              f"{fwd.__name__}, adj = {adj.__name__}): {per_step}, expected "
              f"{TRAIN_STEP_LAUNCHES}")
        check(per_step == TRAIN_STEP_LAUNCHES, f"{name}: per-step launches {per_step}")
        check(ck.build_pair_tables.launches + ck.build_group_tables.launches
              + ck.build_pair_split_tables.launches + ck.build_group_split_tables.launches == 0,
              f"{name}: trig tables rebuilt in a step")
        check(_other_launches(ck, pk, radial) == 0,
              f"{name}: a probe or other-geometry kernel ran in a step")

        stats[name] = {"train_steps": n_steps, "losses": losses, "grad_norms": norms,
                       "launches_per_step": per_step,
                       **step_timings(step, state, data, B, name, card)}
        del res, task, state, step
        torch.cuda.empty_cache()

    # -- 13b. a cut-down f32 step, card against CPU ---------------------------
    small = {"geometry.image_size": 32, "geometry.n_angles": 96, "model.base_features": 8,
             "model.n_iters": 2, "model.use_bfloat16": False, "train.batch_size": 2}
    # one power-iteration start vector for both devices (their generators differ)
    x0 = torch.randn(32, 32, generator=torch.Generator().manual_seed(0)).numpy()
    for name in ("pdunet_parallel", "pdunet_radial"):
        config = get_preset(name).override(small)
        cpu_task = build_task(config, device="cpu", opnorm_x0=x0)
        truth = "image_c" if name == "pdunet_radial" else "image"
        with torch.no_grad():
            images = cpu_task.make_batch(torch.Generator().manual_seed(7))[truth]
        out = []
        for d in (dev, torch.device("cpu")):
            task = cpu_task if d.type == "cpu" else build_task(config, device=d, opnorm_x0=x0)
            state = loop.build_state(task, init_seed=loop.derive_seed(0, loop.INIT_STREAM))
            m = loop.make_train_step(task, from_images=True)(state, images.to(d))
            out.append((float(m["loss"]), float(m["grad_norm"]),
                        torch.cat([p.grad.flatten().cpu() for p in task.model.parameters()])))
        (l0, n0, g0), (l1, n1, g1) = out
        errs = {"loss": abs(l0 - l1) / abs(l1), "grad_norm": abs(n0 - n1) / n1,
                "grad": rel(g0, g1)}
        print(f"[check] {name} f32 train step (cut-down), card vs CPU: {errs} (tol loss "
              f"1e-5, grad_norm and whole-model gradient 1e-4)")
        check(errs["loss"] < 1e-5 and errs["grad_norm"] < 1e-4 and errs["grad"] < 1e-4,
              f"{name}: card step disagrees with the CPU")
        stats[name]["f32_step_card_vs_cpu"] = errs

    # -- 13c. golden-size runs, and 13d. resume, both presets -------------------
    golden = json.loads((REPO / "tests" / "goldens.json").read_text())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    prev_det = torch.backends.cudnn.deterministic
    try:
        for name in ("pdunet_parallel", "pdunet_radial"):
            over = {"geometry.image_size": 32, "geometry.n_angles": 40,
                    "geometry.sparsity": 4, "model.base_features": 8, "model.depth": 1,
                    "model.n_iters": 2, "train.batch_size": 2, "train.learning_rate": 2e-3,
                    "train.warmup_steps": 10, "train.steps": 100, "train.log_every": 50,
                    "train.eval_every": 1000, "train.seed": 0, "train.n_ellipses": 4}
            if name == "pdunet_radial":
                over["geometry.samples_per_spoke"] = 48
            config = get_preset(name).override(over)
            untrained = loop.train(config, steps=0, device=dev, verbose=False).final_eval
            t0 = time.perf_counter()
            res = loop.train(config, device=dev, verbose=False)
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            fin = res.final_eval
            print(f"[train] {name} golden-size run (100 steps, the port's draws): final eval "
                  f"PSNR {fin['psnr']:.3f} dB SSIM {fin['ssim']:.4f}, untrained "
                  f"{untrained['psnr']:.3f} / {untrained['ssim']:.4f}; tests/goldens.json "
                  f"(JAX's draws, not gated) {golden[name]}; {run_s:.2f} s")
            check(fin["psnr"] > untrained["psnr"] and fin["ssim"] > untrained["ssim"],
                  f"{name}: training did not improve the eval ({untrained} -> {fin})")
            stats[name]["golden"] = {"final": fin, "untrained": untrained,
                                     "goldens_json": golden[name], "run_s": run_s}

            # a run that dies after step 10 of 15, resumed, against one that
            # never stopped: bitwise, with cuDNN's deterministic algorithms
            torch.backends.cudnn.deterministic = True
            ck_over = {"train.steps": 15, "train.ckpt_every": 5}
            dirs = {k: os.path.join(tmp, f"{name}_{k}") for k in ("whole", "resumed")}
            whole = loop.train(config.override({**ck_over, "train.ckpt_dir": dirs["whole"]}),
                               device=dev, verbose=False)
            cfg_r = config.override({**ck_over, "train.ckpt_dir": dirs["resumed"]})
            beat, beats = loop.watchdog.beat, []

            def crash_after_10():
                beats.append(1)
                if len(beats) == 11:
                    raise _Crash("simulated crash in step 11")

            loop.watchdog.beat = crash_after_10
            try:
                loop.train(cfg_r, device=dev, verbose=False)
                check(False, "the simulated crash did not happen")
            except _Crash:
                pass
            finally:
                loop.watchdog.beat = beat
            check(CheckpointManager(dirs["resumed"]).latest_step() == 10,
                  "no checkpoint at step 10 after the crash")
            resumed = loop.train(cfg_r, device=dev, verbose=False)
            same = all(torch.equal(a, b) for a, b in zip(resumed.state.model.parameters(),
                                                          whole.state.model.parameters()))
            diff = rel(torch.cat([p.detach().flatten() for p in resumed.state.model.parameters()]),
                       torch.cat([p.detach().flatten() for p in whole.state.model.parameters()]))
            print(f"[check] {name} resumed at step 10 of 15 vs uninterrupted (cuDNN "
                  f"deterministic): bitwise {same}, rel {diff:.3e}")
            check(same and resumed.state.step == 15, f"{name}: the resumed run differs")
            torch.backends.cudnn.deterministic = prev_det
            # infer restores it
            flags = [a for k, v in over.items() if not k.startswith("train.")
                     for a in ("--set", f"{k}={v}")]
            js = os.path.join(tmp, f"{name}_infer.json")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = infer.main(["--preset", name, "--device", str(dev),
                                 "--ckpt-dir", dirs["resumed"], "--ckpt",
                                 "latest", "--batch", "2", "--n-slices", "8",
                                 "--json-out", js, *flags])
            table = json.loads(pathlib.Path(js).read_text())
            print(f"[check] {name} infer --ckpt-dir (resumed run): {buf.getvalue().strip()}")
            check(rc == 0 and table["ckpt_step"] == 15 and math.isfinite(table["psnr_mean"]),
                  f"{name}: infer did not restore the checkpoint: {table}")
            state = loop.build_state(build_task(config, device=dev))
            CheckpointManager(dirs["resumed"]).restore(state)
            check(all(torch.equal(a, b) for a, b in zip(state.model.parameters(),
                                                         whole.state.model.parameters())),
                  f"{name}: the restored weights differ from the trained ones")
            stats[name]["resume_bitwise"] = same
    finally:
        torch.backends.cudnn.deterministic = prev_det
        shutil.rmtree(tmp, ignore_errors=True)
    return stats


#: the presets of slice B (ROADMAP.md item 11)
SLICE_B = ("fbp_unet_parallel", "sino_unet_parallel", "lpd_parallel")

#: pair-kernel group calls of each slice-B preset, derived from the code, as
#: (forward bf16, forward split, adjoint bf16, adjoint split) per phase:
#: "build" is build_task (lpd: the power iteration's 21 bf16 A†A, 2 groups
#: each), "synth" one make_batch or batch_from_images (f32 sparse A + FBP;
#: sino: the f32 dense A only), "recon" one recon_fn (fbp: none; sino: the
#: f32 dense FBP; lpd: 10 bf16 A and A†), "step" one train step after a warm
#: one (synth + the loss's forward + its backward: sino's FBP in the image
#: loss and its vjp, an A; lpd's unroll and its vjps, vjp(A†) = A in all 10
#: iterations and vjp(A) = A† in iterations 2-10, iteration 1's A(f0)
#: needing no gradient)
SLICE_B_LAUNCHES = {
    "fbp_unet_parallel": {"build": (0, 0, 0, 0), "synth": (0, 2, 0, 2),
                          "recon": (0, 0, 0, 0), "step": (0, 2, 0, 2)},
    "sino_unet_parallel": {"build": (0, 0, 0, 0), "synth": (0, 2, 0, 0),
                           "recon": (0, 0, 0, 2), "step": (0, 4, 0, 2)},
    "lpd_parallel": {"build": (42, 0, 42, 0), "synth": (0, 2, 0, 2),
                     "recon": (20, 0, 20, 0), "step": (40, 2, 38, 2)},
}


def _pair_route_counts(ck):
    """(forward bf16, forward split, adjoint bf16, adjoint split) launches."""
    f, a = ck.project_pair_group, ck.backproject_pair_group
    return (f.launches_tc, f.launches_split, a.launches_tc, a.launches_split)


def _times(n, counts):
    return tuple(n * c_ for c_ in counts)


def _plus(*counts):
    return tuple(sum(c_) for c_ in zip(*counts))


def dense_plan_phase(dev, card, gen):
    """Phase 14a: the split-bf16 pair route on sino_unet_parallel's dense
    plan (256², all 360 angles, P = 91 pairs per group): tables bit-equal
    to the plain builders', both kernels against their plain f32 versions
    at B = 8 (train) and 128 (bench), the f32 adjoint dot test, and device
    times beside the split bound, the plain version and a full-f32
    torch.matmul of stage 1's shape; the adjoint's slice-count sweep at B = 8."""
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon.parallel import (
        make_parallel_ops,
        parallel_backproject,
        parallel_project,
    )
    from pdunet_tpu_torch.training.tasks import build_geometries

    f32 = torch.float32
    dense, _ = build_geometries(get_preset("sino_unet_parallel").geometry)
    plan = make_parallel_ops(dense, dtype=f32, device=dev).plan
    m = plan.meta
    N, S, K, L, P = m["N"], m["S"], m["K"], m["S_ext"], m["P_x"]
    print(f"[chip_smoke] dense plan (sino_unet_parallel): N={N} S={S} K={K} L={L} "
          f"P_x={m['P_x']} P_y={m['P_y']} use_pairs={m['use_pairs']}")
    check(m["use_pairs"] and m["P_x"] == m["P_y"] and 2 * (P + m["P_y"]) >= len(dense.angles),
          "the dense plan must pair all its angles, two groups of equal size")
    tabs = {f32: check_tables(ck.build_pair_split_tables, ck._pair_split_tables,
                              {g: (*pair_rows(plan, g)[:3], plan.spec, L) for g in "xy"})}
    table_mb = sum(t.numel() * t.element_size() for g in "xy" for t in tabs[f32][g]) / 1e6
    print(f"[chip_smoke] dense plan split tables (T̂ hi/lo bf16 + φ f32), both groups: "
          f"{table_mb:.2f} MB")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {"P": P, "table_mb": table_mb}
    for B_ in (8, 128):
        f_ = torch.randn(B_, N, N, generator=gen, device=dev)
        p_ = {g: torch.randn(B_, 2 * m[f"P_{g}"], S, generator=gen, device=dev) for g in "xy"}
        fwd_, adj_ = pair_calls(ck, plan, tabs, f_, p_)
        kernels = {"project_pair_group": (fwd_, ck.project_pair_group, ck._project_pair_group),
                   "backproject_pair_group": (adj_, ck.backproject_pair_group,
                                              ck._backproject_pair_group)}
        errs = {}
        check_kernels({f"{k} dense B={B_}": v for k, v in kernels.items()}, errs, dtypes=(f32,))
        cost = pair_cost(B_, N, P, K, S)
        bound, by = split_bound_ms(cost, 4 * B_ * P * N * N * K)
        Fm = f_.reshape(1, B_ * N, N).expand(P, B_ * N, N).contiguous()
        Tm = torch.randn(P, N, 2 * K, generator=gen, device=dev)
        mm = device_ms(lambda: torch.matmul(Fm, Tm), 5)
        del Fm, Tm
        G = ck.pair_adjoint_splits(B_, N, P, n_sms, ck._SPLIT_ADJ_COLS)
        for op, (call, kern, plain) in kernels.items():
            ms = sum(device_ms(lambda g=g: call(g, f32, kern), 5) for g in "xy") / 2
            plain_ms = cuda_ms(lambda: (call("x", f32, plain), call("y", f32, plain)),
                               iters=2, warmup=1) / 2
            e = errs[(f"{op} dense B={B_}", "float32")]
            out[f"{op}_b{B_}"] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                                  "bound_by": by, "stage1_matmul_f32_ms": mm,
                                  "max_abs_err": e[0], "rel_err": e[1],
                                  "adjoint_slices": G if op.startswith("back") else None}
            print(f"[time] {op} float32 (split) on the dense plan at B={B_}: {ms:.4f} ms per "
                  f"group call, plain {plain_ms:.4f} ms, split bound {bound:.4f} ms ({by}; "
                  f"{cost[0] / 1e9:.3f} GFLOP, {cost[1] / 1e6:.3f} MB), {bound / ms:.3f} of the "
                  f"bound, full-f32 torch.matmul of stage 1's shape ({P} x [{B_ * N}x{N}] @ "
                  f"[{N}x{2 * K}]) {mm:.4f} ms; adjoint slices G = {G} ({card})")
        torch.cuda.empty_cache()
    # the f32 dot test on the dense plan (split route): y = A x + noise
    x = torch.randn(8, N, N, generator=gen, device=dev)
    ax = parallel_project(plan, x)
    y = torch.randn(ax.shape, generator=gen, device=dev)
    y = ax + y * (ax.norm() / y.norm())
    lhs = torch.vdot(ax.double().flatten(), y.double().flatten())
    rhs = torch.vdot(x.double().flatten(), parallel_backproject(plan, y).double().flatten())
    out["dot_rel"] = float(abs(lhs - rhs) / abs(lhs))
    print(f"[check] float32 adjoint <Ax,y> vs <x,A^T y> on the dense plan (split route, B=8): "
          f"rel {out['dot_rel']:.3e} (tol 1e-5)")
    check(out["dot_rel"] < 1e-5, f"dense-plan dot test failed: {out['dot_rel']}")
    # does the one-wave slice rule still pick well at 4x the pairs?
    p8 = {g: torch.randn(8, 2 * m[f"P_{g}"], S, generator=gen, device=dev) for g in "xy"}
    _, adj8 = pair_calls(ck, plan, tabs, x, p8)
    out["adjoint_split_sweep_b8"] = split_sweep(
        ck, "pair_adjoint_splits", lambda g: adj8(g, f32, ck.backproject_pair_group),
        8 * -(-N // 128) * -(-N // 128), (1, 2, 4, 8, 16),
        "backproject_pair_group float32 (split) dense B=8", card)
    return out


def slice_b_phases(dev, card):
    """Phase 14b-e: fbp_unet_parallel, sino_unet_parallel and lpd_parallel
    at full width. Per preset: the serving path (build_task → make_batch →
    batch_from_images → recon_fn → PSNR/SSIM, random weights from a seed)
    with its launch counts from 0 against SLICE_B_LAUNCHES and its recon
    time and profile at the preset's batch; a cut-down f32 task on card and
    CPU; a few train() steps (finite losses, every parameter moved, whole-run
    counts), one step's launches after a warm one, its time, split, idle
    share and peak memory; bench --preset-recon at MATRIX_BATCH with device
    time by kind; then the golden-size runs beside tests/goldens.json."""
    import io

    import numpy as np

    from pdunet_tpu_torch import bench
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.data.synth import random_phantom_batch
    from pdunet_tpu_torch.ops.metrics import psnr, ssim
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon import proto_kernels as pk
    from pdunet_tpu_torch.training import loop
    from pdunet_tpu_torch.training.tasks import build_task, estimate_opnorm

    n_power = inspect.signature(estimate_opnorm).parameters["n_iters"].default
    check(2 * (n_power + 1) == SLICE_B_LAUNCHES["lpd_parallel"]["build"][0],
          "SLICE_B_LAUNCHES assumes a 20-step power iteration")
    stats = {}
    for name in SLICE_B:
        config = get_preset(name)
        want = SLICE_B_LAUNCHES[name]
        B = config.train.batch_size
        lpd = name == "lpd_parallel"
        st = stats[name] = {"batch": B}

        # -- 14b. serving at full width, counts from 0 before build_task -------
        ck.reset_launch_counts()
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        task = build_task(config, device=dev)
        torch.cuda.synchronize()
        at_build = _pair_route_counts(ck)
        print(f"[chip_smoke] build_task({name}) on {dev}: {time.perf_counter() - t0:.2f} s, "
              f"sigma {task.sigma}, launches {at_build}")
        check(at_build == want["build"], f"{name}: build_task launches {at_build}, "
              f"expected {want['build']}")
        check((task.sigma is not None) == lpd, f"{name}: sigma {task.sigma}")
        task.init_params(torch.Generator().manual_seed(0))
        task.model.eval()
        n_batches = 2
        data_gen = torch.Generator(device=dev).manual_seed(1234)
        with torch.inference_mode():
            for i in range(n_batches):
                clean = task.make_batch(data_gen)
                batch = task.batch_from_images(clean["image"])
                recon = task.recon_fn(task.model, batch)
                ps, ss = psnr(recon, batch["image"]), ssim(recon, batch["image"])
                N = config.geometry.image_size
                check(recon.shape == (B, N, N) and recon.dtype == torch.float32
                      and bool(torch.isfinite(recon).all()), f"{name}: recon {recon.shape}")
                check(bool(torch.isfinite(ps).all() and torch.isfinite(ss).all()),
                      f"{name}: non-finite metrics")
                print(f"[recon] {name} batch {i}: PSNR {[round(v, 3) for v in ps.tolist()]} "
                      f"SSIM {[round(v, 4) for v in ss.tolist()]}")
        torch.cuda.synchronize()
        served = _pair_route_counts(ck)
        expect = _plus(want["build"], _times(n_batches, _plus(want["synth"], want["synth"],
                                                              want["recon"])))
        print(f"[chip_smoke] {name} serving launches (fwd bf16, fwd split, adj bf16, adj "
              f"split) after {n_batches} batches: {served}, expected {expect}; tables built "
              f"bf16 {ck.build_pair_tables.launches}, split {ck.build_pair_split_tables.launches}")
        check(served == expect, f"{name}: serving launches {served}, expected {expect}")
        check(ck.build_pair_tables.launches == (2 if lpd else 0)
              and ck.build_pair_split_tables.launches == 2,
              f"{name}: trig tables not built once per plan and group")
        check(_other_launches(ck, pk, radial=False) == 0,
              f"{name}: a per-angle or probe kernel ran on the serving path")
        st["serve_launches"] = served

        def one_recon():
            with torch.inference_mode():
                task.recon_fn(task.model, batch)

        recon_s = recon_rate(one_recon, B, card, name)
        st["recon_ms"] = recon_s * 1e3
        st["recon_profile"] = profile_recon(one_recon, card)

        # -- 14c. a cut-down f32 task, card against CPU ------------------------
        small = config.override({"geometry.image_size": 32, "geometry.n_angles": 40,
                                 "model.base_features": 8, "model.depth": 2,
                                 "model.n_iters": 2, "model.use_bfloat16": False,
                                 "train.batch_size": 2})
        x0 = np.random.default_rng(0).standard_normal((32, 32))
        recons = []
        for d in (dev, torch.device("cpu")):
            t_small = build_task(small, device=d, opnorm_x0=x0)
            with torch.inference_mode():
                im = random_phantom_batch(torch.Generator().manual_seed(7), 2, 32,
                                          device="cpu").to(d)
                recons.append(t_small.recon_fn(t_small.model,
                                               t_small.batch_from_images(im)).cpu())
        st["small_f32_card_vs_cpu"] = rel(recons[0], recons[1])
        print(f"[check] {name} small f32 task recon, card vs CPU: rel "
              f"{st['small_f32_card_vs_cpu']:.3e} (tol 1e-4)")
        check(st["small_f32_card_vs_cpu"] < 1e-4, f"{name}: small recon card vs CPU")
        del task, batch, recon
        torch.cuda.empty_cache()

        # -- 14d. training at full width at the preset's batch ------------------
        n_steps = 3
        tconfig = config.override({"train.log_every": 1})
        ck.reset_launch_counts()
        pk.reset_launch_counts()
        t0 = time.perf_counter()
        res = loop.train(tconfig, steps=n_steps, device=dev, verbose=False)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        ran = _pair_route_counts(ck)
        n_val = -(-tconfig.train.val_slices // B)
        losses = [h["loss"] for h in res.history]
        norms = [h["grad_norm"] for h in res.history]
        aux = {k: [h[k] for h in res.history] for k in ("sino_loss", "img_loss")
               if k in res.history[0]}
        print(f"[train] {name} train({n_steps} steps, batch {B}) on the card: {run_s:.2f} s "
              f"with build_task and {n_val} val batches; losses {losses} {aux}, grad norms "
              f"{norms}, final eval {res.final_eval}; launches {ran}")
        check(len(losses) == n_steps and all(math.isfinite(v) for v in losses),
              f"{name}: non-finite loss {losses}")
        check(all(math.isfinite(v) and v > 0 for v in norms), f"{name}: grad norms {norms}")
        check(set(aux) == ({"sino_loss", "img_loss"} if name == "sino_unet_parallel" else set()),
              f"{name}: aux terms {sorted(aux)} in the metrics")
        trained = [q.detach().clone() for q in res.task.model.parameters()]
        res.task.init_params(torch.Generator().manual_seed(
            loop.derive_seed(config.train.seed, loop.INIT_STREAM)))
        still = [n for (n, q), t in zip(res.task.model.named_parameters(), trained)
                 if torch.equal(q.detach(), t)]
        check(not still, f"{name}: parameters that did not move: {still[:5]}")
        # the whole run from 0: build_task, the steps, the validation
        # batches' synthesis and the final eval's recons
        expect = _plus(want["build"], _times(n_steps, want["step"]),
                       _times(n_val, _plus(want["synth"], want["recon"])))
        check(ran == expect, f"{name} train(): launches {ran}, expected {expect}")
        check(_other_launches(ck, pk, radial=False) == 0,
              f"{name}: a per-angle or probe kernel ran in train()")
        task = res.task
        state = loop.build_state(task, n_steps=100)
        step = loop.make_train_step(task)
        data = torch.Generator(device=dev)
        step(state, data.manual_seed(0))
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        n_counted = 2
        for i in range(n_counted):
            step(state, data.manual_seed(1 + i))
        torch.cuda.synchronize()
        per_step = _times(1 / n_counted, _pair_route_counts(ck))
        print(f"[train] {name} pair launches per train step after a warm one (fwd bf16, fwd "
              f"split, adj bf16, adj split): {per_step}, expected {want['step']}")
        check(per_step == want["step"], f"{name}: per-step launches {per_step}")
        check(ck.build_pair_tables.launches + ck.build_pair_split_tables.launches == 0,
              f"{name}: trig tables rebuilt in a step")
        st.update(train_steps=n_steps, losses=losses, grad_norms=norms, aux=aux,
                  launches_per_step=dict(zip(("fwd_tc", "fwd_split", "adj_tc", "adj_split"),
                                             per_step)),
                  **step_timings(step, state, data, B, name, card, reps=5))
        del res, task, state, step
        torch.cuda.empty_cache()

        # -- 14e. bench --preset-recon at the matrix batch, by kind -------------
        b = bench.MATRIX_BATCH[name]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--preset-recon", name, "--batch", str(b)])
        row = json.loads(buf.getvalue().strip().splitlines()[-1])
        print(json.dumps(row))
        check(rc == 0 and row["preset"] == name and row["recon_slices_per_sec"] > 0,
              f"{name}: bench row {row}")
        big = build_task(config.override({"train.batch_size": b}), device=dev)
        big.model.eval()
        with torch.inference_mode():
            bb = big.make_batch(torch.Generator(device=dev).manual_seed(0))
        st["bench_row"] = row

        def big_recon():
            with torch.inference_mode():
                big.recon_fn(big.model, bb)

        st["bench_profile"] = profile_recon(big_recon, card, reps=2, label=f"recons at batch {b}")
        del big, bb
        torch.cuda.empty_cache()
    # -- 14f. golden-size runs --------------------------------------------------
    golden = json.loads((REPO / "tests" / "goldens.json").read_text())
    for name in SLICE_B:
        over = {"geometry.image_size": 32, "geometry.n_angles": 40, "geometry.sparsity": 4,
                "model.base_features": 8, "model.depth": 2 if name.startswith("fbp") else 1,
                "model.n_iters": 2, "train.batch_size": 2, "train.learning_rate": 2e-3,
                "train.warmup_steps": 10, "train.steps": 100, "train.log_every": 50,
                "train.eval_every": 1000, "train.seed": 0, "train.n_ellipses": 4}
        config = get_preset(name).override(over)
        untrained = loop.train(config, steps=0, device=dev, verbose=False).final_eval
        t0 = time.perf_counter()
        fin = loop.train(config, device=dev, verbose=False).final_eval
        run_s = time.perf_counter() - t0
        print(f"[train] {name} golden-size run (100 steps, the port's draws): final eval PSNR "
              f"{fin['psnr']:.3f} dB SSIM {fin['ssim']:.4f}, untrained {untrained['psnr']:.3f} "
              f"/ {untrained['ssim']:.4f}; tests/goldens.json (JAX's draws, not gated) "
              f"{golden[name]}; {run_s:.2f} s")
        check(fin["psnr"] > untrained["psnr"] and fin["ssim"] > untrained["ssim"],
              f"{name}: training did not improve the eval ({untrained} -> {fin})")
        stats[name]["golden"] = {"final": fin, "untrained": untrained,
                                 "goldens_json": golden[name], "run_s": run_s}
    return stats


#: group calls of the slice-C paths, derived from the code, as (forward
#: bf16, forward split, adjoint bf16, adjoint split) per phase, on the pair
#: kernels (pdunet_fan) or the per-angle kernels (sino_unet_radial).
#: pdunet_fan is pdunet_parallel on the fan's backing plan, since one fan A
#: or A† is one backing-plan call per group: build_task's 21 bf16 A†A of
#: the power iteration, 2 groups each; per synthesis one f32 A and one FBP
#: (its backprojection on the split route); per recon 4 bf16 A and A†; per
#: step 16 + 2 forward and 14 + 2 adjoint (TRAIN_STEP_LAUNCHES).
#: sino_unet_radial runs the f32 dense radial operators only: per synthesis
#: one A of the complex images (2 groups, re and im stacked), per recon one
#: DCF adjoint, per step the synthesis, the img_loss's DCF adjoint and its
#: vjp (an A).
SLICE_C_LAUNCHES = {
    "pdunet_fan": {"build": (42, 0, 42, 0), "synth": (0, 2, 0, 2),
                   "recon": (8, 0, 8, 0), "step": (16, 2, 14, 2)},
    "sino_unet_radial": {"build": (0, 0, 0, 0), "synth": (0, 2, 0, 0),
                         "recon": (0, 0, 0, 2), "step": (0, 4, 0, 2)},
}

#: builds of the fan plans' banded rebinning weights (ops/radon/fan.py,
#: once per plan and use): the bf16 unroll plan's forward band in
#: build_task's power iteration, the f32 synthesis plan's forward and FBP
#: bands at the first synthesis; none after
FAN_BAND_BUILDS = {"build": 1, "serve": 3}


def _group_route_counts(ck):
    """(forward bf16, forward split, adjoint bf16, adjoint split) launches
    of the per-angle wrappers."""
    f, a = ck.project_group, ck.backproject_group
    return (f.launches_tc, f.launches_split, a.launches_tc, a.launches_split)


@contextlib.contextmanager
def counting_band_builds():
    """Count the fan plans' band-weight builds (ops/radon/fan.py builds
    them once per plan and use, where the JAX package regenerates them in
    every call): yields a list whose length is the count."""
    from pdunet_tpu_torch.ops.radon import fan

    real, calls = fan._band_weights, []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    fan._band_weights = counted
    try:
        yield calls
    finally:
        fan._band_weights = real


def _chunked(plain, chunk):
    """A plain version run over batch chunks of ``chunk`` (every function
    here is linear in its batch): the plain per-angle versions at B' = 128
    on the 512-spoke plan would hold tens of GB of intermediates."""
    def call(x, *a, **k):
        return torch.cat([plain(x[i:i + chunk], *a, **k) for i in range(0, x.shape[0], chunk)])
    return call


def fan_plan_phase(dev, card, gen):
    """Phase 15a: rows 1-2 on pdunet_fan's backing plans, the sparse one
    (104 backing angles from about −21° to 291°, P = 30 pairs per group,
    most of sign +1, S = 251, K = 179) and the dense one (402 angles, P =
    120). Per plan: both routes' tables bit-equal to the plain builders';
    both kernels against their plain versions at B = 4 and 128, bf16
    (≤ 5e-3) and split f32 (≤ 1e-5), also where only the sign +1 pairs carry
    signal (the forward's rows of those pairs; the adjoint with every other
    row of its input zeroed); the fan operators' f32 dot test; device times
    per group call beside the bound, the plain version and a torch.matmul
    of stage 1's shape; and a bf16 fan A and A† at B = 128 against their
    backing-plan calls alone (the rebinning's cost)."""
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon.fan import make_fan_ops
    from pdunet_tpu_torch.ops.radon.parallel import parallel_backproject, parallel_project
    from pdunet_tpu_torch.training.tasks import build_geometries

    f32, bf16 = torch.float32, torch.bfloat16
    dense, sparse = build_geometries(get_preset("pdunet_fan").geometry)
    out = {}
    for label, geom in (("sparse", sparse), ("dense", dense)):
        ops = make_fan_ops(geom, dtype=f32, device=dev)
        plan = ops.plan.par_plan
        m = plan.meta
        N, S, K, L = m["N"], m["S"], m["K"], m["S_ext"]
        angles = torch.tensor(plan.geom.angles).rad2deg()
        signs = {g: (getattr(plan, f"pair_sgn_{g}"), getattr(plan, f"pair_msk_{g}"))
                 for g in "xy"}
        n_plus = {g: int(((s > 0) & (k > 0)).sum()) for g, (s, k) in signs.items()}
        n_minus = {g: int((s < 0).sum()) for g, (s, _) in signs.items()}
        n_single = {g: int((k == 0).sum()) for g, (_, k) in signs.items()}
        print(f"[chip_smoke] fan backing plan ({label}): {len(angles)} angles from "
              f"{float(angles.min()):.2f} to {float(angles.max()):.2f} deg, N={N} S={S} K={K} "
              f"L={L} A_x={m['A_x']} A_y={m['A_y']} P_x={m['P_x']} P_y={m['P_y']}; pairs of "
              f"sign +1 {n_plus}, sign -1 {n_minus}, unpaired {n_single}")
        check(m["use_pairs"] and sum(n_plus.values()) > 0,
              f"fan {label} plan: expected a paired plan with sign +1 pairs")
        P = (m["P_x"] + m["P_y"]) / 2  # the mean group call's pairs (both 30, or 120)
        tabs = pair_tables(ck, plan)
        table_mb = {str(c).split(".")[1]: sum(t.numel() * t.element_size() for g in "xy"
                                            for t in (tabs[c][g] if isinstance(tabs[c][g], tuple)
                                                      else (tabs[c][g],))) / 1e6
                    for c in tabs}
        st = out[label] = {"P": P, "S": S, "K": K, "n_angles": len(angles),
                           "pairs_sign_plus": n_plus, "pairs_sign_minus": n_minus,
                           "unpaired": n_single, "table_mb": table_mb}
        for B_ in (4, 128):
            f_ = torch.randn(B_, N, N, generator=gen, device=dev)
            p_ = {g: torch.randn(B_, 2 * m[f"P_{g}"], S, generator=gen, device=dev)
                  for g in "xy"}
            fwd_, adj_ = pair_calls(ck, plan, tabs, f_, p_)
            kernels = {"project_pair_group": (fwd_, ck.project_pair_group,
                                              ck._project_pair_group),
                       "backproject_pair_group": (adj_, ck.backproject_pair_group,
                                                  ck._backproject_pair_group)}
            errs = {}
            check_kernels({f"{k} fan {label} B={B_}": v for k, v in kernels.items()}, errs)
            # only the sign +1 pairs: the forward's rows of those pairs, and
            # the adjoint with every other row of its input zeroed
            rows = {g: torch.stack([2 * torch.nonzero((s > 0) & (k > 0))[:, 0],
                                    2 * torch.nonzero((s > 0) & (k > 0))[:, 0] + 1], 1)
                    .flatten() for g, (s, k) in signs.items()}
            p_plus = {g: torch.zeros_like(p_[g]).index_copy_(1, rows[g],
                                                             p_[g].index_select(1, rows[g]))
                      for g in "xy"}
            _, adj_plus = pair_calls(ck, plan, tabs, f_, p_plus)
            for cdt in (f32, bf16):
                tname = str(cdt).split(".")[1]
                for g in "xy":
                    yk = fwd_(g, cdt, ck.project_pair_group).index_select(1, rows[g])
                    yp = fwd_(g, cdt, ck._project_pair_group).index_select(1, rows[g])
                    xk = adj_plus(g, cdt, ck.backproject_pair_group)
                    xp = adj_plus(g, cdt, ck._backproject_pair_group)
                    r_f, r_a = rel(yk, yp), rel(xk, xp)
                    print(f"[check] fan {label} B={B_} {tname} group {g}, sign +1 pairs only "
                          f"({n_plus[g]}): forward rel {r_f:.3e}, adjoint rel {r_a:.3e} "
                          f"(tol {TOL[tname]:.0e})")
                    check(r_f <= TOL[tname] and r_a <= TOL[tname],
                          f"fan {label} {tname} {g}: sign +1 pairs {r_f} / {r_a}")
                    st.setdefault(f"sign_plus_rel_{tname}", []).append(max(r_f, r_a))
            cost = pair_cost(B_, N, P, K, S)
            stage1 = 4 * B_ * P * N * N * K
            Tm = torch.randn(m["P_x"], N, 2 * K, generator=gen, device=dev)
            Fm = f_.reshape(1, B_ * N, N).expand(m["P_x"], B_ * N, N).contiguous()
            mm = {bf16: device_ms(lambda: torch.matmul(Fm.to(bf16), Tm.to(bf16)), 5),
                  f32: device_ms(lambda: torch.matmul(Fm, Tm), 5)}
            del Fm, Tm
            for op, (call, kern, plain) in kernels.items():
                for cdt in (bf16, f32):
                    tname = str(cdt).split(".")[1]
                    ms = sum(device_ms(lambda g=g: call(g, cdt, kern), 5) for g in "xy") / 2
                    plain_ms = cuda_ms(lambda: (call("x", cdt, plain), call("y", cdt, plain)),
                                       iters=2, warmup=1) / 2
                    bound, by = (bound_ms(*cost, "bfloat16") if cdt == bf16
                                 else split_bound_ms(cost, stage1))
                    e = errs[(f"{op} fan {label} B={B_}", tname)]
                    st[f"{op}_{tname}_b{B_}"] = {
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                        "stage1_matmul_ms": mm[cdt], "max_abs_err": e[0], "rel_err": e[1]}
                    print(f"[time] {op} {tname} on the fan {label} plan at B={B_}: {ms:.4f} ms "
                          f"per group call, plain {plain_ms:.4f} ms, bound {bound:.4f} ms ({by}; "
                          f"{cost[0] / 1e9:.3f} GFLOP, {cost[1] / 1e6:.3f} MB), {bound / ms:.3f} "
                          f"of the bound, torch.matmul of stage 1's shape ({m['P_x']} x [{B_ * N}x{N}] "
                          f"@ [{N}x{2 * K}], {tname}) {mm[cdt]:.4f} ms ({card})")
            del f_, p_, p_plus
            torch.cuda.empty_cache()
        # the fan operators' f32 dot test (split route): y = A x + noise
        x = torch.randn(4, N, N, generator=gen, device=dev)
        ax = ops.A(x)
        y = torch.randn(ax.shape, generator=gen, device=dev)
        y = ax + y * (ax.norm() / y.norm())
        lhs = torch.vdot(ax.double().flatten(), y.double().flatten())
        rhs = torch.vdot(x.double().flatten(), ops.At(y).double().flatten())
        st["fan_dot_rel"] = float(abs(lhs - rhs) / abs(lhs))
        print(f"[check] fan operators ({label}, float32, split route, B=4): <Ax,y> vs "
              f"<x,A^T y> rel {st['fan_dot_rel']:.3e} (tol 1e-5)")
        check(st["fan_dot_rel"] < 1e-5, f"fan {label} dot test: {st['fan_dot_rel']}")
        # what the rebinning products add: a whole fan A / A† against its
        # backing-plan call alone, bf16 operators at bench's batch
        ops16 = make_fan_ops(geom, dtype=bf16, device=dev)
        x = torch.randn(128, N, N, generator=gen, device=dev)
        y = ops16.A(x)
        p_par = torch.randn(128, len(angles), S, generator=gen, device=dev)
        st["rebin_b128_ms"] = {
            "fan_A": device_ms(lambda: ops16.A(x), 5),
            "backing_project": device_ms(lambda: parallel_project(ops16.plan.par_plan, x), 5),
            "fan_At": device_ms(lambda: ops16.At(y), 5),
            "backing_backproject": device_ms(
                lambda: parallel_backproject(ops16.plan.par_plan, p_par), 5)}
        print(f"[time] fan {label} bf16 operators at B=128, ms: {st['rebin_b128_ms']} "
              f"(the difference is the rebinning) ({card})")
        del ops, ops16, plan, tabs, x, y, p_par
        torch.cuda.empty_cache()
    return out


def radial_dense_phase(dev, card, gen):
    """Phase 16a: rows 3-4 on sino_unet_radial's dense 512-spoke plan
    (A_x = A_y = 256, S = 1024, K = 256), split f32 route: tables bit-equal
    to the plain builder's and their size, both kernels against their plain
    f32 versions at B' = 8 (batch 4) and 128 (batch 64; the plain version
    run over batch chunks), and device times per group call beside the
    split bound, the plain version and a full-f32 torch.matmul of stage 1's
    shape."""
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.ops.nufft.fourier_slice import build_fs_plan
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.training.tasks import build_geometries

    f32 = torch.float32
    dense, _ = build_geometries(get_preset("sino_unet_radial").geometry)
    plan = build_fs_plan(dense, dtype=f32, device=dev).par_plan
    m = plan.meta
    N, S, K, L = m["N"], m["S"], m["K"], m["S_ext"]
    A = (m["A_x"] + m["A_y"]) / 2  # the mean group call's angles (both 256)
    print(f"[chip_smoke] dense radial plan (sino_unet_radial): N={N} S={S} K={K} L={L} "
          f"A_x={m['A_x']} A_y={m['A_y']} use_pairs={m['use_pairs']}")
    check(not m["use_pairs"], "the dense radial plan must not pair its spokes")
    args = {g: (getattr(plan, f"pos_{g}"), getattr(plan, f"shift_{g}"), plan.spec, L)
            for g in "xy"}
    tabs = {f32: check_tables(ck.build_group_split_tables, ck._group_split_tables, args)}
    table_mb = {g: sum(t.numel() * t.element_size() for t in tabs[f32][g]) / 1e6 for g in "xy"}
    print(f"[chip_smoke] dense radial split tables (T̂ hi/lo bf16 + φ f32): {table_mb} MB "
          f"per group")
    out = {"A": A, "table_mb_per_group": table_mb}
    for B_ in (8, 128):
        f_ = torch.randn(B_, N, N, generator=gen, device=dev)
        p_ = {g: torch.randn(B_, m[f"A_{g}"], S, generator=gen, device=dev) for g in "xy"}
        fwd_, adj_ = group_calls(ck, plan, tabs, f_, p_)
        kernels = {"project_group": (fwd_, ck.project_group, _chunked(ck._project_group, 8)),
                   "backproject_group": (adj_, ck.backproject_group,
                                         _chunked(ck._backproject_group, 8))}
        errs = {}
        check_kernels({f"{k} dense radial B'={B_}": v for k, v in kernels.items()}, errs,
                      dtypes=(f32,))
        cost = group_cost(B_, N, A, K, S)
        bound, by = split_bound_ms(cost, 4 * B_ * A * N * N * K)
        # every angle multiplies the same image rows: 32 angles per matmul
        Fc = f_.reshape(1, B_ * N, N).expand(32, B_ * N, N).contiguous()
        Tm = torch.randn(m["A_x"], N, 2 * K, generator=gen, device=dev)
        mm = device_ms(lambda: [torch.matmul(Fc[:len(Tm[i:i + 32])], Tm[i:i + 32])
                                for i in range(0, len(Tm), 32)], 3)
        del Fc, Tm
        for op, (call, kern, plain) in kernels.items():
            ms = sum(device_ms(lambda g=g: call(g, f32, kern), 5) for g in "xy") / 2
            plain_ms = cuda_ms(lambda: (call("x", f32, plain), call("y", f32, plain)),
                               iters=1, warmup=1) / 2
            e = errs[(f"{op} dense radial B'={B_}", "float32")]
            out[f"{op}_b{B_}"] = {"ms": ms, "plain_ms": plain_ms, "plain": "batch chunks of 8",
                                  "bound_ms": bound, "bound_by": by, "stage1_matmul_f32_ms": mm,
                                  "max_abs_err": e[0], "rel_err": e[1]}
            print(f"[time] {op} float32 (split) on the dense radial plan at B'={B_}: {ms:.4f} ms "
                  f"per group call, plain (chunks of 8) {plain_ms:.4f} ms, split bound "
                  f"{bound:.4f} ms ({by}; {cost[0] / 1e9:.3f} GFLOP, {cost[1] / 1e6:.3f} MB), "
                  f"{bound / ms:.3f} of the bound, full-f32 torch.matmul of stage 1's shape "
                  f"({m['A_x']} x [{B_ * N}x{N}] @ [{N}x{2 * K}]) {mm:.4f} ms ({card})")
        del f_, p_
        torch.cuda.empty_cache()
    del tabs, plan
    torch.cuda.empty_cache()
    return out


def preset_path_phase(name, dev, card, counts_fn, want, radial, small_over, golden_over):
    """Phases 15b / 16b: one preset at full width. The serving path
    (build_task → make_batch → batch_from_images → recon_fn → PSNR/SSIM,
    random weights from a seed) with its launch counts from 0 before
    build_task against ``want`` (SLICE_C_LAUNCHES; ``counts_fn`` reads the
    route counts of the kernels it runs) and no launch of any other kernel;
    recon time and profile at the preset's batch; a cut-down f32 task on
    card and CPU; a few train() steps (finite losses, every parameter moved,
    whole-run counts), one step's launches after a warm one, its time,
    split, idle share and peak memory; bench --preset-recon at MATRIX_BATCH
    with device time by kind; the golden-size run (the port's draws)
    against its untrained eval, beside tests/goldens.json."""
    import io

    import numpy as np

    from pdunet_tpu_torch import bench
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.data.synth import random_phantom_batch
    from pdunet_tpu_torch.ops.metrics import psnr, ssim
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon import proto_kernels as pk
    from pdunet_tpu_torch.training import loop
    from pdunet_tpu_torch.training.tasks import build_task

    config = get_preset(name)
    B = config.train.batch_size
    N = config.geometry.image_size
    fan = config.geometry.kind == "fan"
    tables = ((lambda: (ck.build_group_tables.launches, ck.build_group_split_tables.launches))
              if radial else
              (lambda: (ck.build_pair_tables.launches, ck.build_pair_split_tables.launches)))
    want_tables = (0, 2) if radial else (2, 2)
    st = {"batch": B}

    # -- serving at full width, counts from 0 before build_task ---------------
    ck.reset_launch_counts()
    pk.reset_launch_counts()
    with counting_band_builds() as bands:
        t0 = time.perf_counter()
        task = build_task(config, device=dev)
        torch.cuda.synchronize()
        at_build = counts_fn(ck)
        bands_build = len(bands)
        print(f"[chip_smoke] build_task({name}) on {dev}: {time.perf_counter() - t0:.2f} s, "
              f"sigma {task.sigma}, launches {at_build}, band builds {bands_build}")
        check(at_build == want["build"], f"{name}: build_task launches {at_build}, "
              f"expected {want['build']}")
        task.init_params(torch.Generator().manual_seed(0))
        task.model.eval()
        n_batches = 2
        data_gen = torch.Generator(device=dev).manual_seed(1234)
        with torch.inference_mode():
            for i in range(n_batches):
                clean = task.make_batch(data_gen)
                batch = task.batch_from_images(clean.get("image_c", clean["image"]))
                recon = task.recon_fn(task.model, batch)
                ps, ss = psnr(recon, batch["image"]), ssim(recon, batch["image"])
                check(recon.shape == (B, N, N) and recon.dtype == torch.float32
                      and bool(torch.isfinite(recon).all()), f"{name}: recon {recon.shape}")
                check(bool(torch.isfinite(ps).all() and torch.isfinite(ss).all()),
                      f"{name}: non-finite metrics")
                print(f"[recon] {name} batch {i}: PSNR {[round(v, 3) for v in ps.tolist()]} "
                      f"SSIM {[round(v, 4) for v in ss.tolist()]}")
        torch.cuda.synchronize()
        bands_serve = len(bands)
    served = counts_fn(ck)
    expect = _plus(want["build"], _times(n_batches, _plus(want["synth"], want["synth"],
                                                          want["recon"])))
    print(f"[chip_smoke] {name} serving launches (fwd bf16, fwd split, adj bf16, adj split) "
          f"after {n_batches} batches: {served}, expected {expect}; tables built (bf16, split) "
          f"{tables()}; fan band builds {bands_build} in build_task, {bands_serve} in all")
    check(served == expect, f"{name}: serving launches {served}, expected {expect}")
    check(tables() == want_tables, f"{name}: trig tables {tables()}, expected {want_tables}")
    if fan:
        check((bands_build, bands_serve) == (FAN_BAND_BUILDS["build"], FAN_BAND_BUILDS["serve"]),
              f"{name}: band builds {bands_build} / {bands_serve}, expected {FAN_BAND_BUILDS}")
    check(_other_launches(ck, pk, radial=radial) == 0,
          f"{name}: an other-family or probe kernel ran on the serving path")
    st.update(serve_launches=served, band_builds=bands_serve)

    def one_recon():
        with torch.inference_mode():
            task.recon_fn(task.model, batch)

    st["recon_ms"] = recon_rate(one_recon, B, card, name) * 1e3
    st["recon_profile"] = profile_recon(one_recon, card)

    # -- a cut-down f32 task, card against CPU ----------------------------------
    small = config.override({"geometry.image_size": 32, "geometry.n_angles": 40,
                             "model.base_features": 8, "model.depth": 2, "model.n_iters": 2,
                             "model.use_bfloat16": False, "train.batch_size": 2, **small_over})
    x0 = np.random.default_rng(0).standard_normal((32, 32))
    recons = []
    for d in (dev, torch.device("cpu")):
        t_small = build_task(small, device=d, opnorm_x0=x0)
        with torch.inference_mode():
            im = random_phantom_batch(torch.Generator().manual_seed(7), 2, 32,
                                      device="cpu").to(d)
            recons.append(t_small.recon_fn(t_small.model, t_small.batch_from_images(im)).cpu())
    st["small_f32_card_vs_cpu"] = rel(recons[0], recons[1])
    print(f"[check] {name} small f32 task recon, card vs CPU: rel "
          f"{st['small_f32_card_vs_cpu']:.3e} (tol 1e-4)")
    check(st["small_f32_card_vs_cpu"] < 1e-4, f"{name}: small recon card vs CPU")
    del task, batch, recon
    torch.cuda.empty_cache()

    # -- training at full width at the preset's batch -----------------------------
    n_steps = 3
    tconfig = config.override({"train.log_every": 1})
    ck.reset_launch_counts()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    res = loop.train(tconfig, steps=n_steps, device=dev, verbose=False)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ran = counts_fn(ck)
    n_val = -(-tconfig.train.val_slices // B)
    losses = [h["loss"] for h in res.history]
    norms = [h["grad_norm"] for h in res.history]
    aux = {k: [h[k] for h in res.history] for k in ("sino_loss", "img_loss")
           if k in res.history[0]}
    print(f"[train] {name} train({n_steps} steps, batch {B}) on the card: {run_s:.2f} s "
          f"with build_task and {n_val} val batches; losses {losses} {aux}, grad norms "
          f"{norms}, final eval {res.final_eval}; launches {ran}")
    check(len(losses) == n_steps and all(math.isfinite(v) for v in losses),
          f"{name}: non-finite loss {losses}")
    check(all(math.isfinite(v) and v > 0 for v in norms), f"{name}: grad norms {norms}")
    check(set(aux) == ({"sino_loss", "img_loss"} if name == "sino_unet_radial" else set()),
          f"{name}: aux terms {sorted(aux)} in the metrics")
    trained = [q.detach().clone() for q in res.task.model.parameters()]
    res.task.init_params(torch.Generator().manual_seed(
        loop.derive_seed(config.train.seed, loop.INIT_STREAM)))
    still = [n for (n, q), t in zip(res.task.model.named_parameters(), trained)
             if torch.equal(q.detach(), t)]
    check(not still, f"{name}: parameters that did not move: {still[:5]}")
    expect = _plus(want["build"], _times(n_steps, want["step"]),
                   _times(n_val, _plus(want["synth"], want["recon"])))
    check(ran == expect, f"{name} train(): launches {ran}, expected {expect}")
    check(_other_launches(ck, pk, radial=radial) == 0,
          f"{name}: an other-family or probe kernel ran in train()")
    task = res.task
    state = loop.build_state(task, n_steps=100)
    step = loop.make_train_step(task)
    data = torch.Generator(device=dev)
    step(state, data.manual_seed(0))
    torch.cuda.synchronize()
    ck.reset_launch_counts()
    n_counted = 2
    with counting_band_builds() as bands:
        for i in range(n_counted):
            step(state, data.manual_seed(1 + i))
        torch.cuda.synchronize()
    per_step = _times(1 / n_counted, counts_fn(ck))
    print(f"[train] {name} launches per train step after a warm one (fwd bf16, fwd split, adj "
          f"bf16, adj split): {per_step}, expected {want['step']}; band builds {len(bands)}")
    check(per_step == want["step"], f"{name}: per-step launches {per_step}")
    check(sum(tables()) == 0 and not bands, f"{name}: tables or bands rebuilt in a step")
    st.update(train_steps=n_steps, losses=losses, grad_norms=norms, aux=aux,
              launches_per_step=dict(zip(("fwd_tc", "fwd_split", "adj_tc", "adj_split"),
                                         per_step)),
              **step_timings(step, state, data, B, name, card, reps=5))
    del res, task, state, step
    torch.cuda.empty_cache()

    # -- bench --preset-recon at the matrix batch, by kind -----------------------
    b = bench.MATRIX_BATCH[name]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = bench.main(["--preset-recon", name, "--batch", str(b)])
    row = json.loads(buf.getvalue().strip().splitlines()[-1])
    print(json.dumps(row))
    check(rc == 0 and row["preset"] == name and row["recon_slices_per_sec"] > 0,
          f"{name}: bench row {row}")
    big = build_task(config.override({"train.batch_size": b}), device=dev)
    big.model.eval()
    with torch.inference_mode():
        bb = big.make_batch(torch.Generator(device=dev).manual_seed(0))
    st["bench_row"] = row

    def big_recon():
        with torch.inference_mode():
            big.recon_fn(big.model, bb)

    st["bench_profile"] = profile_recon(big_recon, card, reps=2, label=f"recons at batch {b}")
    del big, bb
    torch.cuda.empty_cache()

    # -- the golden-size run ------------------------------------------------------------
    golden = json.loads((REPO / "tests" / "goldens.json").read_text())
    over = {"geometry.image_size": 32, "geometry.n_angles": 40, "geometry.sparsity": 4,
            "model.base_features": 8, "model.depth": 1, "model.n_iters": 2,
            "train.batch_size": 2, "train.learning_rate": 2e-3, "train.warmup_steps": 10,
            "train.steps": 100, "train.log_every": 50, "train.eval_every": 1000,
            "train.seed": 0, "train.n_ellipses": 4, **golden_over}
    gconfig = get_preset(name).override(over)
    untrained = loop.train(gconfig, steps=0, device=dev, verbose=False).final_eval
    t0 = time.perf_counter()
    fin = loop.train(gconfig, device=dev, verbose=False).final_eval
    run_s = time.perf_counter() - t0
    print(f"[train] {name} golden-size run (100 steps, the port's draws): final eval PSNR "
          f"{fin['psnr']:.3f} dB SSIM {fin['ssim']:.4f}, untrained {untrained['psnr']:.3f} / "
          f"{untrained['ssim']:.4f}; tests/goldens.json (JAX's draws, not gated) "
          f"{golden[name]}; {run_s:.2f} s")
    check(fin["psnr"] > untrained["psnr"] and fin["ssim"] > untrained["ssim"],
          f"{name}: training did not improve the eval ({untrained} -> {fin})")
    st["golden"] = {"final": fin, "untrained": untrained, "goldens_json": golden[name],
                    "run_s": run_s}
    return st


def slice_c_phases(dev, card, gen):
    """Phases 15-16: pdunet_fan (15a the pair kernels on its backing plans,
    15b the preset) and sino_unet_radial (16a the per-angle split kernels on
    its dense 512-spoke plan, 16b the preset)."""
    return {
        "fan_plans": fan_plan_phase(dev, card, gen),
        "pdunet_fan": preset_path_phase(
            "pdunet_fan", dev, card, _pair_route_counts, SLICE_C_LAUNCHES["pdunet_fan"],
            radial=False, small_over={}, golden_over={}),
        "radial_dense_plan": radial_dense_phase(dev, card, gen),
        "sino_unet_radial": preset_path_phase(
            "sino_unet_radial", dev, card, _group_route_counts,
            SLICE_C_LAUNCHES["sino_unet_radial"], radial=True,
            small_over={"geometry.samples_per_spoke": 48},
            golden_over={"geometry.samples_per_spoke": 48}),
    }


#: the stores of phases 17 / 17b: 48 slices at the presets' 256²
DATA_STORE = {"n_slices": 48, "image_size": 256}
#: phase 18's radial geometry: pdunet_radial's 128 measured spokes with an
#: odd readout, which only the gridding NUFFT takes; and its batches
GRIDDING_GEOM = {"image_size": 256, "n_spokes": 128, "samples_per_spoke": 511}
GRIDDING_BATCHES = (4, 128)

#: file-backed training and scoring (phases 17 / 17b): the preset, its
#: store (complex for the radial task), the noise its training applies from
#: the step's generator, the steps of train() and the validation interval,
#: whether it runs through the CLI, and infer's scoring flags
DATA_PATHS = {
    "pdunet_parallel": dict(complex_phase=False, noise={"train.photons_per_ray": 1e5},
                            steps=20, eval_every=10, cli=False,
                            score=("--hu-window", "40", "400")),
    # MRI magnitudes are not attenuation: no HU window
    "pdunet_radial": dict(complex_phase=True, noise={"train.kspace_snr_db": 30.0},
                          steps=10, eval_every=5, cli=True, score=()),
}


def _host_step_ms(fn, reps=10):
    """Warm host-clock milliseconds of ``fn()`` (reps ending in a synchronize)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


@contextlib.contextmanager
def recording_splits():
    """Record the (split, shuffled) of every iterate_batches call of the
    train loop: yields the list."""
    from pdunet_tpu_torch.training import loop

    real, reads = loop.iterate_batches, []

    def recording(ds, batch_size, shuffle=True, **kw):
        reads.append((ds.split, shuffle))
        return real(ds, batch_size, shuffle=shuffle, **kw)

    loop.iterate_batches = recording
    try:
        yield reads
    finally:
        loop.iterate_batches = real


def file_backed_phase(name, dev, card, tmp, store, score_store):
    """Phase 17 / 17b: file-backed training and scoring of ``name`` at full
    width from the slice store ``store``. train() (phase 17, the library
    call) or ``train --data`` (17b, the CLI) with the preset's noise from
    each step's generator: launch counts from 0 before it against the
    synthetic path's (SLICE_C_LAUNCHES' pattern: build_task, steps, the val
    split's synthesis and recons), validation on whole batches of the val
    split; one from-images step's launches after a warm one against the
    synthetic step's (TRAIN_STEP_LAUNCHES); the file-backed step (prefetched
    host batch, copy to the card, synthesis, step) against the synthetic one
    and one from host batches read beforehand, in turns, host clock and
    idle share; then ``infer --ckpt best --data
    score_store --split test --corrupt --export-png`` (phase 17 also with
    ``--hu-window 40 400``) with its launch counts, finite PSNR/SSIM and
    PNGs that decode."""
    import io
    import os

    from pdunet_tpu_torch import infer
    from pdunet_tpu_torch import train as train_cli
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.data.datasets import SliceDataset, iterate_batches
    from pdunet_tpu_torch.data.native import HostPrefetcher
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon import proto_kernels as pk
    from pdunet_tpu_torch.training import loop
    from pdunet_tpu_torch.training.tasks import build_task
    from pdunet_tpu_torch.utils.png import read_gray_png

    spec = DATA_PATHS[name]
    radial = spec["complex_phase"]
    counts_fn = _group_route_counts if radial else _pair_route_counts
    # pdunet's unroll: the same counts per phase on both geometries (a fan A
    # is one backing-plan call per group, as a parallel or radial one)
    want = SLICE_C_LAUNCHES["pdunet_fan"]
    want_step = tuple(TRAIN_STEP_LAUNCHES[op][r] for op in ("fwd", "adj")
                      for r in ("tc", "split"))
    over = {**spec["noise"], "train.eval_every": spec["eval_every"], "train.log_every": 1}
    config = get_preset(name).override(over)
    B, N, steps = config.train.batch_size, config.geometry.image_size, spec["steps"]
    ckpt_dir = os.path.join(tmp, f"{name}_ckpt")
    val_len = len(SliceDataset(store, "val"))
    n_val = max(1, min(-(-config.train.val_slices // B), val_len // B))
    n_evals = steps // spec["eval_every"] + 1  # the interval's evals and the final one
    st = {"batch": B, "steps": steps, "noise": spec["noise"], "n_val_batches": n_val}

    ck.reset_launch_counts()
    pk.reset_launch_counts()
    t0 = time.perf_counter()
    with recording_splits() as reads:
        if spec["cli"]:
            metrics = os.path.join(tmp, f"{name}_metrics.jsonl")
            sets = [a for k, v in over.items() for a in ("--set", f"{k}={v}")]
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = train_cli.main(["--preset", name, "--device", str(dev), "--data", store,
                                     "--split", "train", "--steps", str(steps), "--ckpt-dir",
                                     ckpt_dir, "--metrics", metrics, *sets])
            print(f"[train] {name} train --data: {buf.getvalue().strip().splitlines()[-1]}")
            check(rc == 0, f"{name}: train --data exited {rc}")
            rows = [json.loads(ln) for ln in pathlib.Path(metrics).read_text().splitlines()]
            losses = [r["loss"] for r in rows if "loss" in r]
            evals = [r for r in rows if "psnr" in r]
        else:
            res = loop.train(config.override({"train.ckpt_dir": ckpt_dir}), steps=steps,
                             device=dev, verbose=False, data=store, split="train")
            losses = [h["loss"] for h in res.history]
            evals = [res.final_eval]
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    ran = counts_fn(ck)
    expect = _plus(want["build"], _times(steps, want_step), _times(n_val, want["synth"]),
                   _times(n_evals * n_val, want["recon"]))
    print(f"[train] {name} file-backed ({'train --data' if spec['cli'] else 'train(data=)'}, "
          f"{steps} steps, batch {B}, {spec['noise']}): {run_s:.2f} s; losses "
          f"{[round(v, 5) for v in losses]}; evals {evals}; iterate_batches calls {reads}; "
          f"launches (fwd bf16, fwd split, adj bf16, adj split) {ran}, expected {expect}")
    check(len(losses) == steps and all(math.isfinite(v) for v in losses),
          f"{name}: file-backed losses {losses}")
    check(ran == expect, f"{name} file-backed train: launches {ran}, expected {expect}")
    check(_other_launches(ck, pk, radial=radial) == 0,
          f"{name}: an other-family or probe kernel ran in file-backed training")
    check(reads.count(("val", False)) == 1 and reads.count(("train", True)) == 1
          and ("train", False) not in reads,
          f"{name}: validation did not read whole batches of the val split: {reads}")
    check(os.path.isdir(os.path.join(ckpt_dir, "best")), f"{name}: no best checkpoint")
    st.update(train_s=run_s, losses=losses, evals=evals, launches=ran, split_reads=reads)

    # one from-images step after a warm one, and the steps in turns
    task = build_task(config, device=dev)
    state = loop.build_state(task, n_steps=100)
    synth_step = loop.make_train_step(task)
    file_step = loop.make_train_step(task, from_images=True)
    ds = SliceDataset(store, "train")
    batches = iterate_batches(ds, B, shuffle=True, seed=config.train.seed)
    pf = HostPrefetcher(lambda _i: next(batches), depth=2)
    gen = torch.Generator(device=dev)
    try:
        def one_file_step(i=0):
            images = torch.as_tensor(next(pf), device=dev)
            return file_step(state, images, generator=gen.manual_seed(100 + i))

        def one_synth_step(i=0):
            return synth_step(state, gen.manual_seed(200 + i))

        # the same copy and step from host batches read beforehand: no
        # producer thread beside the step
        preread = [b for b, _ in zip(iterate_batches(ds, B, shuffle=False), range(4))]

        def one_preread_step(i=0):
            images = torch.as_tensor(preread[i % 4], device=dev)
            return file_step(state, images, generator=gen.manual_seed(300 + i))

        one_file_step()
        torch.cuda.synchronize()
        ck.reset_launch_counts()
        for i in range(2):
            one_file_step(1 + i)
        torch.cuda.synchronize()
        per_step = _times(1 / 2, counts_fn(ck))
        print(f"[train] {name} launches per file-backed train step after a warm one: "
              f"{per_step}, expected the synthetic step's {want_step}")
        check(per_step == want_step, f"{name}: file-backed per-step launches {per_step}")
        fns = {"synthetic": one_synth_step, "file": one_file_step, "preread": one_preread_step}
        times = {k: [] for k in fns}
        for key in ("synthetic", "file", "preread", "preread", "file", "synthetic"):
            times[key].append(_host_step_ms(fns[key]))
        idle = {k: profile_recon(fn, card, label=f"{name} {k} steps") for k, fn in fns.items()}
    finally:
        pf.close()
        ds.close()
    step_ms = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"[time] {name} train step at batch {B}, host clock in turns (synthetic, file, "
          f"preread, preread, file, synthetic): synthetic {step_ms['synthetic']:.3f} ms, "
          f"file-backed {step_ms['file']:.3f} ms, file-backed from batches read beforehand "
          f"{step_ms['preread']:.3f} ms (turns {times}); idle share "
          f"{ {k: v.get('idle_share') for k, v in idle.items()} } ({card})")
    st.update(launches_per_step=dict(zip(("fwd_tc", "fwd_split", "adj_tc", "adj_split"),
                                         per_step)),
              step_ms=step_ms, step_turns_ms=times,
              idle_share={k: v.get("idle_share") for k, v in idle.items()},
              profile=idle)
    del task, state, synth_step, file_step
    torch.cuda.empty_cache()

    # scoring: the best checkpoint on the test split, corrupted and windowed
    png_dir = os.path.join(tmp, f"{name}_png")
    js = os.path.join(tmp, f"{name}_infer.json")
    sets = [a for k, v in spec["noise"].items() for a in ("--set", f"{k}={v}")]
    test_len = len(SliceDataset(score_store, "test"))
    ck.reset_launch_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = infer.main(["--preset", name, "--device", str(dev), "--ckpt-dir", ckpt_dir,
                         "--ckpt", "best", "--data", score_store, "--split", "test",
                         "--corrupt", *spec["score"], "--export-png", png_dir,
                         "--json-out", js, *sets])
    torch.cuda.synchronize()
    scored = counts_fn(ck)
    table = json.loads(pathlib.Path(js).read_text())
    n_b = test_len // B
    expect = _plus(want["build"], _times(n_b, _plus(want["synth"], want["recon"])))
    print(f"[infer] {name} --data --split test --corrupt {' '.join(spec['score'])}: "
          f"{buf.getvalue().strip()}; launches {scored}, expected {expect}")
    check(rc == 0 and table["n_slices"] == n_b * B and math.isfinite(table["psnr_mean"])
          and math.isfinite(table["ssim_mean"]), f"{name}: infer table {table}")
    check(scored == expect, f"{name} infer --data: launches {scored}, expected {expect}")
    pngs = sorted(os.listdir(png_dir))
    shapes = {p: read_gray_png(os.path.join(png_dir, p)).shape for p in pngs}
    check(len(pngs) == 2 * min(4, n_b * B) and set(shapes.values()) == {(N, N)},
          f"{name}: exported PNGs {shapes}")
    print(f"[check] {name} exported {len(pngs)} PNGs, each decoding (zlib) to {N}x{N}: {pngs}")
    st.update(infer=table, infer_launches=scored, pngs=pngs)
    return st


def data_path_phases(dev, card):
    """Phases 17 / 17b: file-backed pdunet_parallel and pdunet_radial at
    full width. Stores of 48 slices at 256² (0.8 / 0.1 / 0.1 splits) in the
    npy container, written with the native rasteriser (which must build
    here), and an HU-domain volume of the real one's slices
    (convert_volume), which phase 17 scores on."""
    import os
    import shutil
    import tempfile

    import numpy as np

    from pdunet_tpu_torch.data import datasets, native

    tmp = tempfile.mkdtemp(prefix="chip_smoke_data_")
    out = {}
    try:
        t0 = time.perf_counter()
        check(native.available(), "the native data library did not build on this machine")
        build_s = time.perf_counter() - t0
        print(f"[chip_smoke] native library {native.library_path().name}: built and loaded in "
              f"{build_s:.2f} s")
        stores = {}
        for name, spec in DATA_PATHS.items():
            t0 = time.perf_counter()
            stores[name] = datasets.write_phantom_dataset(
                os.path.join(tmp, f"{name}_store"), DATA_STORE["n_slices"],
                DATA_STORE["image_size"], seed=5, complex_phase=spec["complex_phase"])
            print(f"[chip_smoke] {name} store ({DATA_STORE}, complex "
                  f"{spec['complex_phase']}): {time.perf_counter() - t0:.2f} s")
        # a CT-like volume in Hounsfield units: the store's ellipses at
        # ±250 HU in water (0 HU), so a soft-tissue window (40 ± 200 HU)
        # holds every slice's content; it reads as 1 + HU/1000
        dens = datasets.SliceDataset(stores["pdunet_parallel"], "test")
        vol = np.load(os.path.join(stores["pdunet_parallel"], "slices.npy"))
        hu = datasets.convert_volume(250.0 * vol, os.path.join(tmp, "hu_store"), domain="hu")
        back = datasets.SliceDataset(hu, "test")
        hu_err = max(float(np.abs(back[i] - (1.0 + 0.25 * dens[i])).max())
                     for i in range(len(dens)))
        print(f"[check] the HU volume reads back as relative attenuation 1 + HU/1000: max abs "
              f"{hu_err:.3e} (tol 1e-5)")
        check(back.domain == "hu" and hu_err < 1e-5, "the HU store does not read back")
        out["native_build_s"] = build_s
        out["pdunet_parallel"] = file_backed_phase("pdunet_parallel", dev, card, tmp,
                                                   stores["pdunet_parallel"], hu)
        out["pdunet_radial"] = file_backed_phase("pdunet_radial", dev, card, tmp,
                                                 stores["pdunet_radial"],
                                                 stores["pdunet_radial"])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def gridding_phase(dev, card, gen):
    """Phase 18: the Kaiser-Bessel gridding NUFFT on the card, at 256² with
    128 golden-angle spokes of 511 samples (an odd readout: make_radial_ops
    warns and falls back). A and A† against the float64 numpy twins
    (dcf._np_nufft_forward / _np_nufft_adjoint) at B = 4 (≤ 1e-5), the dot
    test (≤ 1e-5), the adjoint twice bit for bit, CUDA-event times of A, A†
    and fbp at B = 4 and 128 and of the adjoint's grid sum by index_add_
    (atomics) beside the segment sum; then pdunet_radial at 511 samples
    served at batch 4 (``infer``) and trained 10 steps, with no per-angle
    (or any other) kernel launched."""
    import io
    import warnings

    import numpy as np

    from pdunet_tpu_torch import infer
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.geometry import RadialGeometry
    from pdunet_tpu_torch.ops.nufft import dcf, make_radial_ops
    from pdunet_tpu_torch.ops.nufft.nufft import _grid_sum, nufft_adjoint, nufft_forward
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon import proto_kernels as pk
    from pdunet_tpu_torch.training import loop
    from pdunet_tpu_torch.training.tasks import build_task

    geom = RadialGeometry(**GRIDDING_GEOM)
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ops = make_radial_ops(geom, device=dev)
    build_s = time.perf_counter() - t0
    msgs = [str(w.message) for w in caught]
    check(any("even samples_per_spoke" in m for m in msgs), f"no fallback warning: {msgs}")
    plan = ops.plan
    check(type(plan).__name__ == "NufftPlan", "the odd readout did not fall back to gridding")
    m = plan.meta
    N, G, J, S, R = m["N"], m["G"], m["J"], m["n_spokes"], m["n_samples"]
    n_taps = plan.idx.numel()
    print(f"[chip_smoke] gridding plan: N={N} G={G} J={J} {S} spokes x {R} samples, {n_taps} "
          f"taps, longest grid-cell segment {int(plan.seg_len.max())}; make_radial_ops "
          f"{build_s:.2f} s; warning: {msgs}")
    st = {"build_s": build_s, "n_taps": n_taps}

    cplx = lambda *shape: torch.complex(torch.randn(*shape, generator=gen, device=dev),
                                        torch.randn(*shape, generator=gen, device=dev))
    x, y = cplx(4, N, N), cplx(4, S, R)
    T = dcf._plan_tables(geom)
    fx, ay = nufft_forward(plan, x).cpu(), nufft_adjoint(plan, y).cpu()
    xh, yh = x.cpu().numpy().astype(np.complex128), y.cpu().numpy().astype(np.complex128)
    ref_f = np.stack([dcf._np_nufft_forward(T, xh[b]) for b in range(4)])
    ref_a = np.stack([dcf._np_nufft_adjoint(T, yh[b]) for b in range(4)])
    rel_f = float(np.linalg.norm(fx.numpy() - ref_f) / np.linalg.norm(ref_f))
    rel_a = float(np.linalg.norm(ay.numpy() - ref_a) / np.linalg.norm(ref_a))
    lhs = torch.vdot(fx.flatten().to(torch.complex128), y.cpu().flatten().to(torch.complex128))
    rhs = torch.vdot(x.cpu().flatten().to(torch.complex128), ay.flatten().to(torch.complex128))
    dot = float(abs(lhs - rhs) / abs(lhs))
    again = nufft_adjoint(plan, y)
    bitwise = torch.equal(again.cpu(), ay)
    print(f"[check] gridding A / A† at B=4 vs the float64 numpy twins: rel {rel_f:.3e} / "
          f"{rel_a:.3e} (tol 1e-5); dot test {dot:.3e} (tol 1e-5); adjoint twice bit for bit: "
          f"{bitwise}")
    check(rel_f <= 1e-5 and rel_a <= 1e-5, "gridding disagrees with the numpy twins")
    check(dot <= 1e-5, f"gridding dot test {dot}")
    check(bitwise, "the gridding adjoint is not bitwise repeatable")
    st.update(rel_fwd=rel_f, rel_adj=rel_a, dot=dot, adjoint_bitwise=bitwise)

    def index_add_grid(k):
        """The adjoint's grid sum as the reference's scatter-add: index_add_
        of the taps onto a real view of the grid (atomics on the card)."""
        B_ = k.shape[0]
        taps = (k.reshape(B_, -1, 1) * plan.w).reshape(B_, -1)
        grid = torch.zeros(B_, G * G, 2, device=dev)
        return grid.index_add_(1, plan.idx, torch.view_as_real(taps))

    def segment_grid(k):
        return _grid_sum(plan, k.reshape(k.shape[0], -1))

    ia = [index_add_grid(y) for _ in range(2)]
    ia_bitwise = torch.equal(ia[0], ia[1])
    ia_rel = rel(ia[0], torch.view_as_real(segment_grid(y).contiguous()))
    print(f"[check] index_add_ grid sum vs the segment sum: rel {ia_rel:.3e}; index_add_ twice "
          f"bit for bit: {ia_bitwise}")
    check(ia_rel < 1e-5, "the segment sum disagrees with index_add_")
    st["index_add_bitwise"] = ia_bitwise
    for B_ in GRIDDING_BATCHES:
        xb, yb = cplx(B_, N, N), cplx(B_, S, R)
        row = {"A": device_ms(lambda: ops.A(xb), 5), "At": device_ms(lambda: ops.At(yb), 5),
               "fbp": device_ms(lambda: ops.fbp(yb), 5),
               "grid_sum_segment": device_ms(lambda: segment_grid(yb), 5),
               "grid_sum_index_add": device_ms(lambda: index_add_grid(yb), 5)}
        # bytes each op must move: images and k-space once, plus the plan's
        # taps (int64 index and f32 weight); f32 bound by HBM
        nbytes = 8 * B_ * (N * N + S * R) + 12 * n_taps
        row["bytes_bound_ms"] = nbytes / PEAK_BYTES * 1e3
        print(f"[time] gridding at B={B_}: A {row['A']:.4f} ms, A† {row['At']:.4f} ms, fbp "
              f"{row['fbp']:.4f} ms; A†'s grid sum: segment sum {row['grid_sum_segment']:.4f} "
              f"ms, index_add_ {row['grid_sum_index_add']:.4f} ms; bytes bound "
              f"{row['bytes_bound_ms']:.4f} ms ({card})")
        st[f"b{B_}"] = row
        del xb, yb
        torch.cuda.empty_cache()
    del x, y, ia

    # pdunet_radial at 511 samples: served, then trained; no projector kernel
    R = GRIDDING_GEOM["samples_per_spoke"]
    config = get_preset("pdunet_radial").override({"geometry.samples_per_spoke": R})
    ck.reset_launch_counts()
    pk.reset_launch_counts()
    buf = io.StringIO()
    with warnings.catch_warnings(), contextlib.redirect_stdout(buf):
        warnings.simplefilter("ignore", UserWarning)
        rc = infer.main(["--preset", "pdunet_radial", "--device", str(dev), "--set",
                         f"geometry.samples_per_spoke={R}", "--n-slices", "8"])
        torch.cuda.synchronize()
        served = _group_route_counts(ck) + _pair_route_counts(ck)
        res = loop.train(config.override({"train.log_every": 1}), steps=10, device=dev,
                         verbose=False)
        torch.cuda.synchronize()
        trained = _group_route_counts(ck) + _pair_route_counts(ck)
        task = build_task(config, device=dev)
    losses = [h["loss"] for h in res.history]
    print(f"[infer] pdunet_radial at {R} samples: {buf.getvalue().strip()}")
    print(f"[train] pdunet_radial at {R} samples, 10 steps: losses "
          f"{[round(v, 5) for v in losses]}, final eval {res.final_eval}; projector launches "
          f"(per-angle, then pair) after serving {served}, after training {trained}")
    check(rc == 0 and len(losses) == 10 and all(math.isfinite(v) for v in losses),
          f"pdunet_radial at {R} samples: rc {rc}, losses {losses}")
    check(sum(trained) == 0 and _other_launches(ck, pk, radial=True) == 0,
          "a projector kernel ran on the gridding path")
    task.model.eval()
    with torch.inference_mode():
        clean = task.make_batch(torch.Generator(device=dev).manual_seed(0))
        batch = task.batch_from_images(clean["image_c"])

    def one_recon():
        with torch.inference_mode():
            task.recon_fn(task.model, batch)

    st["recon_ms_b4"] = recon_rate(one_recon, 4, card, f"pdunet_radial ({R} samples)") * 1e3
    st["recon_profile_b4"] = profile_recon(one_recon, card, gridding=True)
    st.update(served_launches=served, trained_launches=trained, losses=losses,
              final_eval=res.final_eval, sigma=task.sigma)
    del res, task, batch
    torch.cuda.empty_cache()
    return st


# -- 19-20. angle-sharded operators and sharded training / serving ---------

#: the wrappers of rows 1-4 of the kernel table, which the sharded paths run
ROWS_1_4 = ("project_pair_group", "backproject_pair_group", "project_group",
            "backproject_group")
#: overrides of every preset the mesh phases run (none: full width)
MESH_OVERRIDES = {}
#: the ops cases of phase 19: name → (preset whose sparse geometry, operand dtype)
MESH_OPS = {"parallel_f32": ("pdunet_parallel", "float32"),
            "parallel_bf16": ("pdunet_parallel", "bfloat16"),
            "fan_f32": ("pdunet_fan", "float32"), "fan_bf16": ("pdunet_fan", "bfloat16"),
            "radial_f32": ("pdunet_radial", "float32"),
            "radial_bf16": ("pdunet_radial", "bfloat16")}
MESH_STEP_SEED, MESH_INIT_SEED, MESH_LR = 7, 1, 1e-2
#: the backend of the world-1 group (NCCL's one check on a single card)
MESH_WORLD1_BACKEND = "nccl"
MESH_DIST = ["--dist-backend", "gloo", "--dist-timeout", "300"]


def _mesh_config(preset, **over):
    from pdunet_tpu_torch.configs import get_preset

    return get_preset(preset).override({**MESH_OVERRIDES, **over})


def _launch_check(cases, world, tmp, dev, backend="gloo"):
    """Run ``cases`` in ``world`` ranks of ``python -m
    pdunet_tpu_torch.parallel.check`` on ``dev``; each rank's results."""
    from pdunet_tpu_torch.parallel.launch import launch

    out = tmp / f"world{world}_{backend}"
    out.mkdir()
    torch.save(dict(device=dev.type, backend=backend, timeout_s=300.0, out=str(out),
                    cases=cases), out / "job.pt")
    t0 = time.perf_counter()
    launch("pdunet_tpu_torch.parallel.check", [str(out / "job.pt")], world, timeout_s=900)
    print(f"[chip_smoke] {world} ranks ({backend}) ran {[c['name'] for c in cases]} in "
          f"{time.perf_counter() - t0:.1f} s")
    return [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(world)]


def _mesh_geometry(preset):
    """The preset's sparse geometry, as the check worker's ``geometry``."""
    import dataclasses

    from pdunet_tpu_torch.training.tasks import build_geometries

    config = _mesh_config(preset)
    _, sparse = build_geometries(config.geometry)
    return config, sparse, dict(kind=config.geometry.kind, **dataclasses.asdict(sparse))


def shard_kernel_phase(dev, gen):
    """Phase 19a: every kernel of rows 1-4 against its plain version on each
    shard of G = 2 (``shard_plan``), on the card: the pair kernels on
    pdunet_parallel's sparse plan (both routes; the second shard's last row
    a zero pad row) and pdunet_fan's backing plan (sign +1 pairs), the
    per-angle kernels on pdunet_radial's fourier-slice plan; each shard's
    tables bit-equal to the plain builders'."""
    from pdunet_tpu_torch.ops.nufft import make_radial_ops
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon.fan import make_fan_ops
    from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops
    from pdunet_tpu_torch.parallel.angle_shard import shard_plan

    errs, rows = {}, {}
    plans = {}
    for preset, make in (("pdunet_parallel", make_parallel_ops), ("pdunet_fan", make_fan_ops),
                         ("pdunet_radial", make_radial_ops)):
        config, sparse, _ = _mesh_geometry(preset)
        plan = make(sparse, dtype=torch.float32, device=dev).plan
        plans[preset] = (getattr(plan, "par_plan", plan), config.train.batch_size
                         * (2 if preset == "pdunet_radial" else 1))
    for preset, (plan, B) in plans.items():
        N, S = plan.meta["N"], plan.meta["S"]
        pairs = plan.meta["use_pairs"]
        f = torch.randn(B, N, N, generator=gen, device=dev)
        for r in range(2):
            sp = shard_plan(plan, 2, r)
            key = "P_" if pairs else "A_"
            n_rows = {g: sp.meta[key + g] for g in "xy"}
            rows[f"{preset}/shard{r}"] = {
                "rows": n_rows, "of": {g: plan.meta[key + g] for g in "xy"},
                "pad_rows": {g: n_rows[g] - (min((r + 1) * n_rows[g], plan.meta[key + g])
                                             - min(r * n_rows[g], plan.meta[key + g]))
                             for g in "xy"}}
            p = {g: torch.randn(B, (2 if pairs else 1) * n_rows[g], S, generator=gen,
                                device=dev) for g in "xy"}
            if pairs:
                fwd, adj = pair_calls(ck, sp, pair_tables(ck, sp), f, p)
                kernels = {"project_pair_group": (fwd, ck.project_pair_group,
                                                  ck._project_pair_group),
                           "backproject_pair_group": (adj, ck.backproject_pair_group,
                                                      ck._backproject_pair_group)}
            else:
                fwd, adj = group_calls(ck, sp, group_tables(ck, sp), f, p)
                kernels = {"project_group": (fwd, ck.project_group, ck._project_group),
                           "backproject_group": (adj, ck.backproject_group,
                                                 ck._backproject_group)}
            print(f"[chip_smoke] {preset} shard {r} of 2: {rows[f'{preset}/shard{r}']}")
            check_kernels(kernels, errs)
    return {"rows": rows, "errs": {f"{k[0]}/{k[1]}": v for k, v in errs.items()}}


def mesh_ops_phase(dev, gen):
    """Phase 19b: the angle-sharded operator bundles (A, A†, fbp and both
    vjps) in 2 gloo ranks on the card, mesh (1, 2), against the unsharded
    bundles here on the same inputs (rel ≤ 1e-5 f32, ≤ 5e-3 bf16), the f32
    dot test on the sharded pair (y = A x + noise, ≤ 1e-5), vjp(A_sh) =
    A†_sh and vjp(A†_sh) = A_sh (≤ 1e-6), and each rank's launch counts
    (2 forward and 4 adjoint group calls, on the dtype's route) and trig
    tables (its own shard's rows only); per-rank CUDA-event times of the
    sharded A and A† (both ranks share the card: not a scaling number).
    Then phase 20's two-rank steps run in the same launch."""
    from pdunet_tpu_torch.ops.nufft import make_radial_ops
    from pdunet_tpu_torch.ops.radon.fan import make_fan_ops
    from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

    make = {"parallel": make_parallel_ops, "fan": make_fan_ops, "radial": make_radial_ops}
    refs, cases = {}, []
    for name, (preset, dtype) in MESH_OPS.items():
        config, sparse, spec = _mesh_geometry(preset)
        B = config.train.batch_size
        ops = make[spec["kind"]](sparse, dtype=getattr(torch, dtype), device=dev)
        N = sparse.image_size
        x = torch.randn(B, N, N, generator=gen, device=dev)
        if spec["kind"] == "radial":
            x = torch.complex(x, torch.randn(B, N, N, generator=gen, device=dev))
        with torch.no_grad():
            ax = ops.A(x)
            y = ax + 0.1 * ax.abs().mean() * torch.randn(ax.shape, generator=gen, device=dev,
                                                          dtype=ax.dtype)
            plan = getattr(ops.plan, "par_plan", ops.plan)
            key = "P_" if plan.meta["use_pairs"] else "A_"
            refs[name] = {"x": x, "y": y, "A": ax, "At": ops.At(y), "fbp": ops.fbp(y),
                          "dtype": dtype, "kind": spec["kind"],
                          "shard_rows": {g: math.ceil(plan.meta[key + g] / 2) for g in "xy"}}
        cases.append(dict(kind="ops", name=name, geometry=spec, dtype=dtype, mesh=(1, 2),
                          x=x.cpu(), y=y.cpu(), time=True))
    return refs, cases


def check_mesh_ops(refs, ranks, card):
    """The phase 19b checks on the ranks' results; returns the stats."""
    stats = {}
    for name, ref in refs.items():
        tname = ref["dtype"]
        got = ranks[0][name]
        errs = {k: rel(got[k].to(ref[k].device), ref[k]) for k in ("A", "At", "fbp")}
        for k, e in errs.items():
            check(e <= TOL[tname], f"sharded {name} {k}: rel {e} > {TOL[tname]}")
        vjp = {"A": rel(got["vjp_A"], got["At"]), "At": rel(got["vjp_At"], got["A"])}
        check(max(vjp.values()) <= 1e-6, f"sharded {name}: vjp pairing {vjp}")
        dot = None
        if tname == "float32":
            x, y = ref["x"].cpu().to(torch.complex128), ref["y"].cpu().to(torch.complex128)
            lhs = torch.vdot(got["A"].to(torch.complex128).flatten(), y.flatten())
            rhs = torch.vdot(x.flatten(), got["At"].to(torch.complex128).flatten())
            dot = float(abs(lhs - rhs) / abs(lhs))
            check(dot <= 1e-5, f"sharded {name}: dot test {dot}")
        route = "tc" if tname == "bfloat16" else "split"
        fwd, adj = (("project_pair_group", "backproject_pair_group") if ref["kind"] != "radial"
                    else ("project_group", "backproject_group"))
        per_rank = []
        for r, res in enumerate(ranks):
            c = res[name]["launches"]
            i = 1 if route == "tc" else 2
            check(c[fwd][0] == c[fwd][i] == 2 and c[adj][0] == c[adj][i] == 4,
                  f"sharded {name} rank {r}: launches {c}")
            others = [k for k in c if k not in (fwd, adj)]
            check(all(c[k][0] == 0 for k in others), f"sharded {name} rank {r}: {c}")
            rows = res[name]["table_rows"]
            mine = f"G2r{res[name]['coords'][1]}/"
            check(rows and all(k.startswith(mine) and v == ref["shard_rows"][k[-1]]
                               for k, v in rows.items()),
                  f"sharded {name} rank {r}: tables {rows}, want {ref['shard_rows']} rows")
            check("ms" in res[name], f"sharded {name} rank {r}: no CUDA-event times")
            per_rank.append({"launches": {fwd: c[fwd], adj: c[adj]}, "table_rows": rows,
                             "ms": res[name].get("ms")})
        print(f"[check] sharded {name} (mesh 1x2, 2 gloo ranks on one card): rel {errs}, "
              f"vjp {vjp}, dot {dot}; per rank {per_rank} (times are time-shared on one "
              f"card, not scaling) ({card})")
        stats[name] = {"rel": errs, "vjp_rel": vjp, "dot_rel": dot, "per_rank": per_rank}
    return stats


def _single_step(dev, config):
    """One f32 SGD step on this card from the mesh phases' weights and seed."""
    from pdunet_tpu_torch.training import loop
    from pdunet_tpu_torch.training.tasks import build_task

    task = build_task(config, device=dev)
    task.init_params(torch.Generator().manual_seed(MESH_INIT_SEED))
    state = loop.TrainState(task.model, torch.optim.SGD(task.model.parameters(), lr=MESH_LR),
                            lambda i: MESH_LR)
    m = loop.make_train_step(task)(state, torch.Generator(device=dev).manual_seed(
        MESH_STEP_SEED))
    return task, {k: float(v) for k, v in m.items()}


def _step_case(name, config, mesh, steps=3):
    return dict(kind="step", name=name, config=config.to_json(), mesh=mesh,
                init_seed=MESH_INIT_SEED, lr=MESH_LR, seed=MESH_STEP_SEED, steps=steps)


def check_steps(names, results, single, card):
    """Each f32 sharded step against the single-device step (loss and
    grad_norm rtol 1e-4, parameters atol 1e-4, the tolerances of
    __graft_entry__.py), σ the same on every rank; returns per-mesh stats."""
    task, m1 = single
    want = task.model.state_dict()
    stats = {}
    for name in names:
        ranks = results[name]
        m = ranks[0]["metrics"][0]
        loss_rel = abs(m["loss"] - m1["loss"]) / abs(m1["loss"])
        param_err = max(float((ranks[0]["params"][k] - v.cpu()).abs().max())
                        for k, v in want.items())
        gn_rel = abs(m["grad_norm"] - m1["grad_norm"]) / abs(m1["grad_norm"])
        check(loss_rel <= 1e-4, f"{name}: loss {m['loss']} vs {m1['loss']}")
        check(gn_rel <= 1e-4, f"{name}: grad_norm {m['grad_norm']} vs {m1['grad_norm']}")
        check(param_err <= 1e-4, f"{name}: parameters differ by {param_err}")
        sigmas = [r["sigma"] for r in ranks]
        check(len(set(sigmas)) == 1 and abs(sigmas[0] - task.sigma) <= 1e-6 * task.sigma,
              f"{name}: sigma {sigmas} vs {task.sigma}")
        stats[name] = _step_stats(name, ranks, card, loss_rel=loss_rel, grad_norm_rel=gn_rel,
                                  param_err=param_err)
    return stats


def _step_stats(name, ranks, card, **extra):
    host = [sum(r["host_ms"]) / len(r["host_ms"]) for r in ranks]
    launches = [r["launches"] for r in ranks]
    print(f"[time] sharded step {name} (mesh {ranks[0]['mesh']}, {len(ranks)} rank(s) on "
          f"one card): host ms per step by rank {host}; launches per rank in one "
          f"step {launches}; {extra} ({card})")
    return {"mesh": ranks[0]["mesh"], "host_ms_per_step": host, "launches_per_rank": launches,
            "metrics": ranks[0]["metrics"], **extra}


def mesh_phases(dev, card, gen):
    """Phases 19-20: the angle-sharded operators and sharded training and
    serving of pdunet_parallel at full width (256², batch 4) in gloo ranks
    that share this card, and a world-1 NCCL group."""
    import tempfile

    from pdunet_tpu_torch import infer
    from pdunet_tpu_torch import train as train_cli
    from pdunet_tpu_torch.training.checkpoint import CheckpointManager

    out = {"shard_kernels": shard_kernel_phase(dev, gen)}
    f32 = _mesh_config("pdunet_parallel", **{"model.use_bfloat16": False})
    bf16 = _mesh_config("pdunet_parallel")
    radial = _mesh_config("pdunet_radial")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh-") as tmp:
        tmp = pathlib.Path(tmp)
        refs, cases2 = mesh_ops_phase(dev, gen)
        steps2 = {"f32_21": (f32, (2, 1)), "f32_12": (f32, (1, 2))}
        cases2 += [_step_case(n, c, m) for n, (c, m) in steps2.items()]
        cases2.append(_step_case("radial_bf16_12", radial, (1, 2), steps=2))
        r2 = _launch_check(cases2, 2, tmp, dev)
        res = {c["name"]: [r[c["name"]] for r in r2] for c in cases2}
        out["sharded_ops"] = check_mesh_ops(refs, r2, card)
        cases4 = [_step_case("f32_22", f32, (2, 2)), _step_case("bf16_22", bf16, (2, 2))]
        r4 = _launch_check(cases4, 4, tmp, dev)
        res.update({c["name"]: [r[c["name"]] for r in r4] for c in cases4})
        nccl = [_step_case("f32_11_nccl", f32, (1, 1), steps=2)]
        r1 = _launch_check(nccl, 1, tmp, dev, backend=MESH_WORLD1_BACKEND)
        res["f32_11_nccl"] = [r1[0]["f32_11_nccl"]]
        single = _single_step(dev, f32)
        out["steps"] = check_steps(["f32_21", "f32_12", "f32_22", "f32_11_nccl"], res, single,
                                   card)
        for name in ("bf16_22", "radial_bf16_12"):
            for r in res[name]:
                check(all(math.isfinite(m["loss"]) and m["grad_norm"] > 0
                          for m in r["metrics"]), f"{name}: {r['metrics']}")
            out["steps"][name] = _step_stats(name, res[name], card)
        for name, rows in (("bf16_22", ("project_pair_group", "backproject_pair_group")),
                           ("radial_bf16_12", ("project_group", "backproject_group"))):
            for r in res[name]:
                check(all(r["launches"][k][0] > 0 for k in rows),
                      f"{name}: a kernel of the path did not launch: {r['launches']}")

        # the entry points: train on the 2x2 mesh, infer its checkpoint on one device,
        # and infer --devices 2 against --devices 1
        ck = tmp / "ck"
        t0 = time.perf_counter()
        check(train_cli.main(["--preset", "pdunet_parallel", "--device", dev.type, "--devices", "2",
                              "--angle-devices", "2", "--steps", "3", "--ckpt-dir", str(ck),
                              "--metrics", str(tmp / "m.jsonl"), "--set", "train.log_every=1",
                              "--set", "train.eval_every=3", *_mesh_sets(), *MESH_DIST]) == 0,
              "train --devices 2 --angle-devices 2 failed")
        train_s = time.perf_counter() - t0
        lines = [json.loads(s) for s in (tmp / "m.jsonl").read_text().splitlines()]
        check([m["step"] for m in lines] == [1, 2, 3, 3] and
              all(math.isfinite(v) for m in lines for v in m.values()),
              f"train 2x2 metrics {lines}")
        check(CheckpointManager(str(ck)).latest_step() == 3, "train 2x2: no step-3 checkpoint")
        serve = {}
        for label, extra in (("devices_1", ["--devices", "1"]),
                             ("devices_2", ["--devices", "2", *MESH_DIST])):
            js = tmp / f"{label}.json"
            t0 = time.perf_counter()
            check(infer.main(["--preset", "pdunet_parallel", "--device", dev.type,
                              "--ckpt-dir", str(ck),
                              "--n-slices", "8", "--json-out", str(js), *_mesh_sets(),
                              *extra]) == 0, f"infer {label} failed")
            serve[label] = {**json.loads(js.read_text()), "s": time.perf_counter() - t0}
        t1, t2 = serve["devices_1"], serve["devices_2"]
        check(t1["ckpt_step"] == 3 and math.isfinite(t1["psnr_mean"]), f"infer {t1}")
        check(abs(t2["psnr_mean"] - t1["psnr_mean"]) <= 1e-5 * abs(t1["psnr_mean"]) and
              abs(t2["ssim_mean"] - t1["ssim_mean"]) <= 1e-4 * abs(t1["ssim_mean"]),
              f"infer --devices 2 {t2} vs --devices 1 {t1}")
        print(f"[chip_smoke] train --devices 2 --angle-devices 2 (3 steps, gloo, one card): "
              f"{train_s:.1f} s, metrics {lines}; infer on its checkpoint: {serve} ({card})")
        out["entry_points"] = {"train_2x2_s": train_s, "train_2x2_metrics": lines,
                               "infer": serve}
    return out


# -- 21. the scripts/ backends ---------------------------------------------

#: the geometries of phase 21 (the sweep's cells, ood_analysis's presets)
SCRIPT_PRESETS = ("pdunet_parallel", "pdunet_fan", "pdunet_radial")
#: slices per OOD store in phase 21 (one ood_analysis batch of 8)
SCRIPT_OOD_SLICES = 8
#: phase 21's bounds: each anchor PSNR mean against the JAX package's on the
#: CPU (dB), its resid_rel (relative), and each classical row against the
#: reference's artifact (dB; the draws differ)
ANCHOR_DB, ANCHOR_RESID, CLASSICAL_DB = 0.01, 0.01, 1.0


def scripts_phase(card):
    """Phase 21: the ``scripts/`` backends as a user runs them, in a
    temporary root (each script's ``ROOT`` / ``ART``): acceleration_sweep's
    three cells (20 steps at full width, batch 4, and their infer),
    ood_eval on pdunet_parallel (shepp_logan, hu_volume), ood_analysis in
    process over the three cells, classical_baselines in process at full
    width, batch_frontier_ab (b4, b32_base) and results_tables. Children
    are ``python -m pdunet_tpu_torch.{train,infer}`` on the card; a failed
    child raises. The anchors are held against the JAX package's on the CPU
    (``scripts/ood_anchors_reference.json``), the classical rows against
    ``artifacts/classical_baselines.json``; rows 1-4's launches are counted
    in the two in-process runs."""
    import concurrent.futures
    import shutil
    import tempfile

    import numpy as np

    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.scripts import (
        acceleration_sweep,
        batch_frontier_ab,
        classical_baselines,
        ood_analysis,
        ood_eval,
        results_tables,
    )

    torch.cuda.empty_cache()  # the children share the card with this process
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_scripts_"))
    scripts = (acceleration_sweep, batch_frontier_ab, classical_baselines, ood_analysis,
               ood_eval)
    saved_roots, saved_art = {m: m.ROOT for m in scripts}, results_tables.ART
    for m in scripts:
        m.ROOT = tmp
    results_tables.ART = tmp / "artifacts" / "torch"
    art = tmp / "artifacts" / "torch"
    out = {"launches": {}, "s": {}}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        out["s"][name] = time.perf_counter() - t0
        print(f"[chip_smoke] phase 21 {name}: {out['s'][name]:.1f} s")

    def counted(name, fn):
        ck.reset_launch_counts()
        timed(name, fn)
        pair, group = _pair_route_counts(ck), _group_route_counts(ck)
        counts = {}
        for row in ROWS_1_4:
            c = (pair if "pair" in row else group)[0 if row.startswith("project") else 2:]
            counts[row] = {"tc": c[0], "split": c[1]}
        out["launches"][name] = counts
        print(f"[check] phase 21 {name} launches of rows 1-4 (bf16 tensor-core / split): "
              f"{counts}")
        check(all(c["tc"] > 0 and c["split"] > 0 for c in counts.values()),
              f"{name}: a kernel of rows 1-4 did not launch on both routes: {counts}")

    pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
    try:
        # the A/B needs nothing of the others: it runs beside them, its
        # children processes of their own (the in-process counts see none)
        ab_done = pool.submit(timed, "batch_frontier_ab", lambda: batch_frontier_ab.main(
            ["--arms", "b4,b32_base", "--samples", "64"]))
        timed("acceleration_sweep", lambda: acceleration_sweep.main(
            ["--presets", ",".join(SCRIPT_PRESETS), "--sparsities", "4", "--batch", "4",
             "--samples", "80"]))
        sweep = json.loads((art / "acceleration_sweep.json").read_text())["cells"]
        for c in sweep:
            print(f"[check] sweep cell {c['preset']}_s{c['sparsity']} ({c['steps']} steps, "
                  f"batch {c['batch']}): PSNR {c['psnr_mean']:.3f} dB, SSIM "
                  f"{c['ssim_mean']:.4f} over {c['n_slices']} slices, train "
                  f"{c['train_wall_sec']} s ({card})")
        check(sorted(c["preset"] for c in sweep) == sorted(SCRIPT_PRESETS)
              and all(c["steps"] == 20 and c["n_slices"] == 64
                      and math.isfinite(c["psnr_mean"]) and math.isfinite(c["ssim_mean"])
                      for c in sweep), f"the sweep's cells: {sweep}")

        timed("ood_eval", lambda: ood_eval.main(
            ["--presets", "pdunet_parallel", "--kinds", "shepp_logan,hu_volume",
             "--n-slices", str(SCRIPT_OOD_SLICES)]))
        ood = json.loads((art / "ood_eval.json").read_text())["cells"]
        print(f"[check] ood_eval cells: {[(c['kind'], round(c['psnr_mean'], 3)) for c in ood]}")
        check(len(ood) == 2 and all(c["n_slices"] == SCRIPT_OOD_SLICES
                                    and math.isfinite(c["psnr_mean"]) for c in ood),
              f"the ood_eval cells: {ood}")

        counted("ood_analysis", lambda: ood_analysis.main(
            ["--presets", ",".join(SCRIPT_PRESETS), "--kinds", "indist,shepp_logan,hu_volume",
             "--n-slices", str(SCRIPT_OOD_SLICES)]))
        yard = json.loads((REPO / "pdunet_tpu_torch" / "scripts"
                           / "ood_anchors_reference.json").read_text())["pairs"]
        anchors = {}
        for preset in SCRIPT_PRESETS:
            for kind in ("indist", "shepp_logan", "hu_volume"):
                path = art / "ood_analysis" / f"{preset}_{kind}.json"
                if kind == "hu_volume" and preset == "pdunet_radial":
                    check(not path.exists(), "ood_analysis scored an HU volume on MRI")
                    continue
                c = json.loads(path.read_text())
                check(c["n_slices"] == SCRIPT_OOD_SLICES and math.isfinite(c["psnr_mean"])
                      and len(c["worst_png"]) == 2, f"ood_analysis cell {c}")
                print(f"[check] ood_analysis {preset}/{kind}: model {c['psnr_mean']:.3f} dB, "
                      f"anchor {c['anchor_psnr_mean']:.3f} dB, resid model / anchor "
                      f"{c.get('resid_rel_model')} / {c.get('resid_rel_anchor')}")
                if kind == "indist":
                    continue  # this run's draws: no yardstick
                ref = yard[f"{preset}/{kind}"]
                ref_db = float(np.mean(ref["anchor_psnr"][:SCRIPT_OOD_SLICES]))
                tpu = json.loads((REPO / "artifacts" / "ood_analysis"
                                  / f"{preset}_{kind}.json").read_text())
                # the TPU artifact holds 32 slices: it is set beside the JAX
                # package's mean over the same 32, which this run matches on
                # its first slices
                jax32 = float(np.mean(ref["anchor_psnr"]))
                a = {"anchor_db": c["anchor_psnr_mean"], "jax_cpu_db": ref_db,
                     "diff_db": c["anchor_psnr_mean"] - ref_db, "jax_cpu_db_32": jax32,
                     "tpu_artifact_db_32": tpu["anchor_psnr_mean"],
                     "tpu_minus_jax_cpu_db_32": tpu["anchor_psnr_mean"] - jax32}
                if "resid_rel_anchor" in c:
                    ref_r = float(np.mean(ref["resid_rel_anchor"][:SCRIPT_OOD_SLICES]))
                    a.update(resid=c["resid_rel_anchor"], jax_cpu_resid=ref_r,
                             resid_rel_diff=c["resid_rel_anchor"] / ref_r - 1.0,
                             tpu_artifact_resid_32=tpu["resid_rel_anchor"])
                anchors[f"{preset}/{kind}"] = a
                print(f"[check] anchor {preset}/{kind} over {SCRIPT_OOD_SLICES} slices: "
                      f"{a['anchor_db']:.3f} dB here, {ref_db:.4f} dB the JAX package on the "
                      f"CPU (diff {a['diff_db']:+.4f}, bound {ANCHOR_DB}); resid_rel "
                      f"{a.get('resid')} against {a.get('jax_cpu_resid')} (rel diff "
                      f"{a.get('resid_rel_diff')}, bound {ANCHOR_RESID}); over all 32 slices "
                      f"the TPU artifact {a['tpu_artifact_db_32']:.3f} dB against the JAX "
                      f"package's {jax32:.4f} dB ({a['tpu_minus_jax_cpu_db_32']:+.4f} dB, no "
                      f"bound) ({card})")
                check(abs(a["diff_db"]) <= ANCHOR_DB,
                      f"anchor {preset}/{kind} is {a['diff_db']:+.4f} dB off the JAX package's")
                check("resid" not in a or abs(a["resid_rel_diff"]) <= ANCHOR_RESID,
                      f"resid_rel_anchor {preset}/{kind} is {a.get('resid_rel_diff')} off")
        out["anchors"] = anchors

        counted("classical_baselines", lambda: classical_baselines.main([]))
        ref_rows = {(c["preset"], c["sparsity"]): c for c in json.loads(
            (REPO / "artifacts" / "classical_baselines.json").read_text())["cells"]}
        rows = json.loads((art / "classical_baselines.json").read_text())["cells"]
        check(len(rows) == 9, f"classical_baselines wrote {len(rows)} rows, not 9")
        for c in rows:
            r = ref_rows[(c["preset"], c["sparsity"])]
            d = c["psnr_mean"] - r["psnr_mean"]
            print(f"[check] classical {c['preset']} s{c['sparsity']} ({c['method']}): "
                  f"{c['psnr_mean']:.3f} dB (per-slice std {c['psnr_std']:.3f}) / SSIM "
                  f"{c['ssim_mean']:.4f} over {c['n_slices']} slices; the reference's "
                  f"artifact {r['psnr_mean']:.3f} / {r['ssim_mean']:.4f} (diff {d:+.3f} dB, "
                  f"bound {CLASSICAL_DB}) ({card})")
            check(c["n_slices"] == 64 and abs(d) <= CLASSICAL_DB,
                  f"classical row {c['preset']} s{c['sparsity']} is {d:+.3f} dB off")
        out["classical"] = rows

        ab_done.result()
        ab = json.loads((art / "batch_ab.json").read_text())["arms"]
        print(f"[check] batch_frontier_ab arms: {ab}")
        check([a["tag"] for a in ab] == ["pdunet_parallel_b4", "pdunet_parallel_b32_base"]
              and all(math.isfinite(a["psnr"]) for a in ab), f"the A/B arms: {ab}")
        out["batch_ab"] = ab

        timed("results_tables", lambda: results_tables.main([]))
        sweep_md, ood_md = results_tables.sweep_table(), results_tables.ood_table()
        sweep_row = next(r for r in sweep_md.splitlines() if r.startswith("| pdunet_parallel |"))
        ood_row = next(r for r in ood_md.splitlines() if r.startswith("| pdunet_parallel |"))
        ood_cells = [x.strip() for x in ood_row.split("|")[2:-1]]  # in-dist, then the kinds
        check(sweep_row.split("|")[3].strip() != "—" and "*FBP (no learning)*" in sweep_md
              and "—" not in (ood_cells[0], ood_cells[1], ood_cells[5]),
              f"results_tables rendered: {sweep_row} / {ood_row}")
        out["sweep"], out["ood_eval"] = sweep, ood
    finally:
        pool.shutdown(wait=True)
        for m, root in saved_roots.items():
            m.ROOT = root
        results_tables.ART = saved_art
        shutil.rmtree(tmp, ignore_errors=True)
    return out


#: cuDNN's layout conversion kernels: they run around a convolution whose
#: operands are not in the layout of the kernel cuDNN picked
LAYOUT_KERNELS = ("nchwToNhwc", "nhwcToNchw")


#: the ConvNet counters per lpd_parallel recon: 10 iterations × 2 nets, each
#: padding its first convolution's inputs (7 or 6 channels) and its last
#: one's outputs (5)
CONVNET_COUNTS = {"convnet.channels_last": 20, "convnet.padded_convs": 40}


def layout_phase(dev, card, batch=8):
    """Phase 22: cuDNN's NCHW <-> NHWC conversion kernels per bf16 recon of
    pdunet_parallel, pdunet_radial and lpd_parallel at batch ``batch``
    (torch.profiler over one recon after a warm one), beside the
    convolution kernels. The UNets and ConvNets run channels_last, so none
    may remain: where any do, the op that launched each (the convolution
    they surround) and its input shapes are printed, then the check fails.
    LPD's ConvNet counters per ``recon`` root, read by ``portbench/spans.py``
    from a recording of one more recon, must read ``CONVNET_COUNTS``."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import spans
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.training.tasks import build_task
    from pdunet_tpu_torch.utils import trace

    def layout(name):
        return any(k.lower() in name.lower() for k in LAYOUT_KERNELS)

    out = {}
    for name in ("pdunet_parallel", "pdunet_radial", "lpd_parallel"):
        config = get_preset(name).override({"train.batch_size": batch})
        task = build_task(config, device=dev)
        task.init_params(torch.Generator().manual_seed(0))
        task.model.eval()
        with torch.inference_mode():
            b = task.make_batch(torch.Generator(device=dev).manual_seed(22))
            task.recon_fn(task.model, b)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                         record_shapes=True) as prof:
                task.recon_fn(task.model, b)
                torch.cuda.synchronize()
        events = prof.events()
        kernels = [e.name for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
        n_layout = sum(layout(k) for k in kernels)
        n_conv = sum(("fprop" in k or "dgrad" in k or "conv" in k.lower()) and not layout(k)
                     for k in kernels)
        print(f"[chip_smoke] {name} bf16 recon at batch {batch}: {n_layout} cuDNN layout "
              f"conversion kernels ({', '.join(LAYOUT_KERNELS)}) beside {n_conv} convolution "
              f"kernels, of {len(kernels)} kernels ({card})")
        around = {}
        for e in events:
            for k in e.kernels:
                if layout(k.name):
                    key = f"{e.name} {e.input_shapes}"
                    around[key] = around.get(key, 0) + 1
        for key, n in sorted(around.items(), key=lambda kv: -kv[1]):
            print(f"[chip_smoke]   {n} x around {key}")
        out[name] = {"batch": batch, "layout_kernels": n_layout, "conv_kernels": n_conv,
                     "kernels": len(kernels), "around": around}
        with torch.inference_mode(), trace.recording(dev) as rec:
            task.recon_fn(task.model, b)
        run = types.SimpleNamespace(spans=rec.spans(), window_ns=0, elapsed=math.inf)
        counts = {k: v for k, v in spans.launches(run).get("recon", {}).items()
                  if k.startswith("convnet.")}
        print(f"[chip_smoke] {name} ConvNet counters per recon: {counts}")
        out[name]["convnet_counts"] = counts
        del task
        torch.cuda.empty_cache()
    for name, r in out.items():
        check(r["layout_kernels"] == 0,
              f"{name}: {r['layout_kernels']} cuDNN layout conversions per recon; "
              f"around {sorted(r['around'])}")
        want = CONVNET_COUNTS if name == "lpd_parallel" else {}
        check(r["convnet_counts"] == want,
              f"{name}: ConvNet counters {r['convnet_counts']} per recon, not {want}")
    return out


def _mesh_sets():
    return [a for k, v in MESH_OVERRIDES.items() for a in ("--set", f"{k}={v}")]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a card",
              file=sys.stderr)
        return 2
    if not (REPO / "pdunet_tpu_torch").is_dir():
        print(f"chip_smoke: no pdunet_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 3
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    t_start = last = time.perf_counter()
    phase_s = {}

    def elapsed(label):
        nonlocal last
        now = time.perf_counter()
        phase_s[label] = now - last
        last = now
        print(f"[chip_smoke] {label}: {phase_s[label]:.1f} s ({now - t_start:.1f} s in all)")

    print(f"[chip_smoke] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # -- 1. build ----------------------------------------------------------
    from pdunet_tpu_torch.ops.radon import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    build_s = time.perf_counter() - t0
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {name}: {line.strip()}")
    print(f"[chip_smoke] built {sorted(logs)} in {build_s:.2f} s")
    hgmma = {**hgmma_counts(_build.build("radon_pair_tc"), TC_KERNELS),
             **hgmma_counts(_build.build("radon_pair_split"), SPLIT_KERNELS),
             **hgmma_counts(_build.build("radon_group_tc"), GROUP_TC_KERNELS),
             **hgmma_counts(_build.build("radon_group_split"), GROUP_SPLIT_KERNELS),
             **hgmma_counts(_build.build("radon_proto_tc"), PROTO_TC_KERNELS),
             **hgmma_counts(_build.build("radon_pair_proto_tc"), PAIR_PROTO_TC_KERNELS)}
    print(f"[chip_smoke] HGMMA instructions per kernel of radon_pair_tc.cu, "
          f"radon_pair_split.cu, radon_group_tc.cu, radon_group_split.cu, "
          f"radon_proto_tc.cu and radon_pair_proto_tc.cu: {hgmma}")
    proto_products = PROTO_TC_KERNELS[:6] + PAIR_PROTO_TC_KERNELS[:4]
    for name in ("pair_tc_fwd", "pair_tc_adj", "pair_split_fwd", "pair_split_adj",
                 "group_tc_fwd", "group_tc_adj", "group_tc_fwd_stage3", "group_tc_adj_stage3t",
                 "group_split_fwd", "group_split_adj", *proto_products, "proto_tc_fwd_stage3",
                 "proto_tc_adj_stage3t"):
        check(hgmma[name] > 0, f"{name} (a tensor-core product) has no HGMMA instruction")
    # the split products: three wgmmas (hi·hi, hi·lo, lo·hi) per 16-deep
    # step, four steps per 64-deep chunk
    for name in ("pair_split_fwd", "pair_split_adj", "group_split_fwd", "group_split_adj",
                 *(n for n in proto_products if "split" in n)):
        check(hgmma[name] % 12 == 0, f"{name}: {hgmma[name]} HGMMA, not 3 per 16-deep step")

    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.data.synth import random_phantom_batch
    from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan
    from pdunet_tpu_torch.ops.metrics import psnr, ssim
    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck
    from pdunet_tpu_torch.ops.radon.parallel import (
        make_parallel_ops,
        parallel_backproject,
        parallel_project,
    )
    from pdunet_tpu_torch.training.tasks import build_geometries, build_task, estimate_opnorm

    # -- 2. kernels against their plain versions at the serving shapes ------
    config = get_preset("pdunet_parallel")
    B = config.train.batch_size
    _, sparse = build_geometries(config.geometry)
    ops32 = make_parallel_ops(sparse, dtype=torch.float32, device=dev)
    plan = ops32.plan
    m = plan.meta
    N, S, K, L = m["N"], m["S"], m["K"], m["S_ext"]
    P = m["P_x"]
    print(f"[chip_smoke] serving plan: B={B} N={N} S={S} K={K} L={L} "
          f"P_x={m['P_x']} P_y={m['P_y']} use_pairs={m['use_pairs']}")
    gen = torch.Generator(device=dev).manual_seed(0)
    f = torch.randn(B, N, N, generator=gen, device=dev)
    p = {g: torch.randn(B, 2 * m[f"P_{g}"], S, generator=gen, device=dev) for g in "xy"}

    # the card's trig tables (both tensor-core routes') against the plain builders
    tabs = pair_tables(ck, plan)

    fwd, adj = pair_calls(ck, plan, tabs, f, p)
    kernels = {
        "project_pair_group": (fwd, ck.project_pair_group, ck._project_pair_group),
        "backproject_pair_group": (adj, ck.backproject_pair_group,
                                   ck._backproject_pair_group),
    }
    errs = {}
    check_kernels(kernels, errs)
    # the tensor-core kernels against the plain versions of their own tiling
    # and arithmetic, which read the same (card-built) tables: bf16, and the
    # float32 split route (hi/lo operands, three products)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split_rel = {}
    for cdt, cols in ((torch.bfloat16, ck._TC_ADJ_COLS), (torch.float32, ck._SPLIT_ADJ_COLS)):
        tname = str(cdt).split(".")[1]
        for g in "xy":
            r = pair_rows(plan, g)
            rf = rel(fwd(g, cdt, ck.project_pair_group),
                     ck._pair_forward_tc(f, tabs[cdt][g], r[3], plan.Wc, plan.Ws, g == "x", cdt))
            G = ck.pair_adjoint_splits(B, N, m[f"P_{g}"], n_sms, cols)
            ra = rel(adj(g, cdt, ck.backproject_pair_group),
                     ck._pair_adjoint_tc(p[g], tabs[cdt][g], r[3], r[4], plan.Wc, plan.Ws,
                                         g == "x", N, G, cdt))
            if cdt == torch.float32:
                split_rel[g] = (rf, ra)
            print(f"[check] tensor-core pair ({tname} route) vs its tiled plain version, group "
                  f"{g}: fwd rel {rf:.3e}, adj rel {ra:.3e} (G = {G} slices; tol "
                  f"{TOL[tname]:.0e})")
            check(rf <= TOL[tname] and ra <= TOL[tname], "tiled plain version")
    # other batch sizes, and a size whose rows do not fill a 128-row tile
    ragged = build_parallel_plan(ParallelGeometry(image_size=96, n_angles=96).subsample(4),
                                 device=dev)
    for label, pl, B_ in (("B=1", plan, 1), ("B=32", plan, 32), ("96² 24 angles", ragged, 4)):
        N_, S_ = pl.meta["N"], pl.meta["S"]
        tabs_ = tabs if pl is plan else pair_tables(ck, pl)
        f_ = torch.randn(B_, N_, N_, generator=gen, device=dev)
        p_ = {g: torch.randn(B_, 2 * pl.meta[f"P_{g}"], S_, generator=gen, device=dev)
              for g in "xy"}
        fwd_, adj_ = pair_calls(ck, pl, tabs_, f_, p_)
        check_kernels({f"project_pair_group {label}": (fwd_, ck.project_pair_group,
                                                       ck._project_pair_group),
                       f"backproject_pair_group {label}": (adj_, ck.backproject_pair_group,
                                                           ck._backproject_pair_group)}, {})

    # -- 3. adjoint dot tests ------------------------------------------------------
    # float32, the split route: y = A x plus a random sinogram of the same
    # norm keeps <Ax, y> near ‖Ax‖², so the mismatch reads the pair's error
    # (a few 1e-6 per operator) and not a ratio of near-zero random products
    n_split = ck.project_pair_group.launches_split, ck.backproject_pair_group.launches_split
    x = torch.randn(B, N, N, generator=gen, device=dev)
    ax = parallel_project(plan, x)
    y = torch.randn(ax.shape, generator=gen, device=dev)
    y = ax + y * (ax.norm() / y.norm())
    lhs = torch.vdot(ax.double().flatten(), y.double().flatten())
    rhs = torch.vdot(x.double().flatten(), parallel_backproject(plan, y).double().flatten())
    adj_rel = float(abs(lhs - rhs) / abs(lhs))
    print(f"[check] float32 adjoint <Ax,y> vs <x,A^T y> (split-bf16 route): rel {adj_rel:.3e} "
          f"(tol 1e-5)")
    check(adj_rel < 1e-5, f"adjoint test failed: {adj_rel}")
    check(ck.project_pair_group.launches_split == n_split[0] + 2
          and ck.backproject_pair_group.launches_split == n_split[1] + 2,
          "the float32 dot test did not run the split route")
    # bf16: A and A† round different operands, so the pair is not an exact
    # transpose; the kernel pair must do no worse than the plain pair
    dot_bf16 = {}
    for g in "xy":
        yg = torch.randn(B, 2 * m[f"P_{g}"], S, generator=gen, device=dev)
        yg[:, 1::2] *= pair_rows(plan, g)[4][None, :, None]  # unpaired member-b rows
        fwd_g, adj_g = pair_calls(ck, plan, tabs, x, {g: yg})

        def mismatch(impl_f, impl_a):
            a = fwd_g(g, torch.bfloat16, impl_f)
            b = adj_g(g, torch.bfloat16, impl_a)
            lhs = torch.vdot(a.double().flatten(), yg.double().flatten())
            rhs = torch.vdot(x.double().flatten(), b.double().flatten())
            return float(abs(lhs - rhs) / abs(lhs))

        mk = mismatch(ck.project_pair_group, ck.backproject_pair_group)
        mp = mismatch(ck._project_pair_group, ck._backproject_pair_group)
        dot_bf16[g] = (mk, mp)
        print(f"[check] bf16 adjoint dot test, group {g}: tensor-core pair {mk:.3e}, plain "
              f"pair {mp:.3e} (tol 2 x plain + 1e-4)")
        check(mk <= 2 * mp + 1e-4, f"bf16 dot test group {g}: {mk} vs plain {mp}")

    # -- 4. the serving path at full width ------------------------------------
    # counts from 0 before build_task: its power iteration runs the bf16
    # operators and builds the tables
    ck.reset_launch_counts()
    t0 = time.perf_counter()
    task = build_task(config, device=dev)
    torch.cuda.synchronize()
    print(f"[chip_smoke] build_task({config.name}) on {dev}: "
          f"{time.perf_counter() - t0:.2f} s, sigma {task.sigma:.6g}")
    at_build = pair_counts(ck)
    task.init_params(torch.Generator().manual_seed(0))
    task.model.eval()
    n_batches = 3
    data_gen = torch.Generator(device=dev).manual_seed(1234)
    results = []
    with torch.inference_mode():
        for _ in range(n_batches):
            clean = task.make_batch(data_gen)
            batch = task.batch_from_images(clean["image"])
            recon = task.recon_fn(task.model, batch)
            results.append((batch, recon, psnr(recon, batch["image"]),
                            ssim(recon, batch["image"])))
    torch.cuda.synchronize()
    counts = pair_counts(ck)
    launches = {name: counts[name][0] for name in ("project_pair_group",
                                                   "backproject_pair_group",
                                                   "build_pair_tables",
                                                   "build_pair_split_tables")}
    check(ck.project_group.launches == ck.backproject_group.launches == 0,
          "a per-angle kernel ran on the pdunet_parallel path")
    # build_task: the power iteration's (n + 1) bf16 A†A, 2 groups each, and
    # one bf16 table build per group. Per batch: make_batch and
    # batch_from_images each run A + FBP (one A†) in f32 on the split route
    # (its tables built once per group, at the first batch), recon_fn
    # n_iters bf16 A and A†.
    n_iters = config.model.n_iters
    n_power = inspect.signature(estimate_opnorm).parameters["n_iters"].default
    print(f"[chip_smoke] main-path launches (total, bf16 tensor-core, split): after "
          f"build_task {at_build}, after {n_batches} batches {counts}")
    check(at_build["build_pair_tables"][0] == 2 and counts["build_pair_tables"][0] == 2,
          "the bf16 trig tables were not built exactly once per group")
    check(at_build["build_pair_split_tables"][0] == 0
          and counts["build_pair_split_tables"][0] == 2,
          "the split trig tables were not built exactly once per group, at the first batch")
    for name in ("project_pair_group", "backproject_pair_group"):
        tc_build = 2 * (n_power + 1)
        check(at_build[name] == (tc_build, tc_build, 0),
              f"{name}: {at_build[name]} in build_task, expected {tc_build} on the tensor cores")
        n, n_tc, n_split = (c - b for c, b in zip(counts[name], at_build[name]))
        check(n_tc == n_batches * 2 * n_iters,
              f"{name}: {n_tc} tensor-core launches in {n_batches} batches, expected "
              f"{n_batches * 2 * n_iters} (recon_fn)")
        check(n_split == n - n_tc == n_batches * 2 * 2,
              f"{name}: {n_split} split-route launches of {n - n_tc} float32 ones in "
              f"{n_batches} batches, expected {n_batches * 2 * 2} (synthesis, FBP)")
    for i, (batch, recon, ps, ss) in enumerate(results):
        check(recon.shape == (B, N, N), f"recon shape {tuple(recon.shape)}")
        check(bool(torch.isfinite(recon).all()), "non-finite reconstruction")
        check(bool(torch.isfinite(ps).all() and torch.isfinite(ss).all()),
              "non-finite metrics")
        f0_ps = psnr(batch["f0"], batch["image"])
        print(f"[recon] batch {i}: PSNR {ps.tolist()} SSIM {ss.tolist()} "
              f"(f0 PSNR {[round(v, 2) for v in f0_ps.tolist()]})")
    # the card's synthesis + FBP against the plain path on the CPU
    batch = results[0][0]
    ops_cpu = make_parallel_ops(sparse, dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        img_cpu = batch["image"].cpu()
        sino_cpu = ops_cpu.A(img_cpu)
        f0_cpu = ops_cpu.fbp(sino_cpu)
    sino_rel = rel(batch["sino"].cpu(), sino_cpu)
    f0_rel = rel(batch["f0"].cpu(), f0_cpu)
    print(f"[check] card vs CPU plain path at full size: sino rel {sino_rel:.3e}, "
          f"f0 rel {f0_rel:.3e} (tol 1e-4: the ramp filter lifts the kernels' "
          f"1e-6-level differences)")
    check(sino_rel < 1e-5 and f0_rel < 1e-4, "card synthesis disagrees with the CPU")
    # a cut-down float32 task: the whole recon on the card vs on the CPU
    small = config.override({
        "geometry.image_size": 32, "geometry.n_angles": 96,
        "model.base_features": 8, "model.n_iters": 2, "model.use_bfloat16": False,
        "train.batch_size": 2})
    recons = []
    for d in (dev, torch.device("cpu")):
        t_small = build_task(small, device=d)
        img = torch.Generator().manual_seed(7)
        with torch.inference_mode():
            im = random_phantom_batch(img, 2, 32, device="cpu").to(d)
            recons.append(t_small.recon_fn(t_small.model, t_small.batch_from_images(im)).cpu())
    small_rel = rel(recons[0], recons[1])
    print(f"[check] small f32 task recon, card vs CPU: rel {small_rel:.3e} (tol 1e-4)")
    check(small_rel < 1e-4, "small recon on the card disagrees with the CPU")
    # again with torch's default (cuDNN may run f32 convolutions in TF32):
    # the UNet's f32 convolutions pin full f32 themselves
    torch.backends.cudnn.allow_tf32 = True
    try:
        t_small = build_task(small, device=dev)
        with torch.inference_mode():
            im = random_phantom_batch(torch.Generator().manual_seed(7), 2, 32,
                                      device="cpu").to(dev)
            tf32_default = t_small.recon_fn(t_small.model, t_small.batch_from_images(im)).cpu()
    finally:
        torch.backends.cudnn.allow_tf32 = False
    tf32_rel = rel(tf32_default, recons[1])
    print(f"[check] small f32 task recon with cudnn.allow_tf32 = True (torch's default), "
          f"card vs CPU: rel {tf32_rel:.3e} (tol 1e-4)")
    check(tf32_rel < 1e-4, "the f32 task on torch's TF32 default disagrees with the CPU")

    # -- 5. timings -------------------------------------------------------------
    fl, nb = pair_cost(B, N, P, K, S)
    Tm = torch.randn(P, N, 2 * K, generator=gen, device=dev).to(torch.bfloat16)
    Fm = f.to(torch.bfloat16).reshape(1, B * N, N).expand(P, B * N, N).contiguous()
    mm_ms = cuda_ms(lambda: torch.matmul(Fm, Tm))
    print(f"[time] yardstick: bf16 torch.matmul of stage 1's shape "
          f"({P} x [{B * N}x{N}] @ [{N}x{2 * K}]): {mm_ms:.4f} ms")
    replaces = {
        "project_pair_group": "pdunet_tpu/ops/radon/pallas_kernels.py:350",
        "backproject_pair_group": "pdunet_tpu/ops/radon/pallas_kernels.py:381",
    }
    split_bound = split_bound_ms(pair_cost(B, N, P, K, S), 4 * B * P * N * N * K)
    fp32_bound = bound_ms(fl, nb, "float32")
    print(f"[time] bounds per group call at B={B}: split-bf16 route {split_bound[0]:.4f} ms "
          f"({split_bound[1]}: stage 1 as 3 bf16 products at 989 TFLOP/s, stages 2-3 at "
          f"67), FP32 CUDA cores {fp32_bound[0]:.4f} ms ({card})")
    entries = time_kernels(kernels, errs, launches, (fl, nb),
                           "pdunet_tpu_torch/ops/radon/csrc/radon_pair_tc.cu", replaces,
                           mm_ms, card, bound_f32=split_bound)

    def pair_inputs(B_):
        fwd_, adj_ = pair_calls(
            ck, plan, tabs, torch.randn(B_, N, N, generator=gen, device=dev),
            {g: torch.randn(B_, 2 * m[f"P_{g}"], S, generator=gen, device=dev) for g in "xy"})
        return {"project_pair_group": fwd_, "backproject_pair_group": adj_}

    pair_ops = {"project_pair_group": ck.project_pair_group,
                "backproject_pair_group": ck.backproject_pair_group}
    ab = route_times(pair_ops, pair_inputs, lambda B_: pair_cost(B_, N, P, K, S),
                     lambda B_: (P, B_ * N, N, 2 * K), card, (B, 256), dev, gen)
    # float32: the split-bf16 route, beside a full-f32 torch.matmul of stage
    # 1's shape (TF32 off) as the yardstick
    ab32 = route_times(pair_ops, pair_inputs, lambda B_: pair_cost(B_, N, P, K, S),
                       lambda B_: (P, B_ * N, N, 2 * K), card, (B, 256), dev, gen,
                       cdt=torch.float32,
                       bound=lambda B_: split_bound_ms(pair_cost(B_, N, P, K, S),
                                                       4 * B_ * P * N * N * K),
                       key="split")
    # the adjoints' slice counts at B = 4 (pair_adjoint_splits picks
    # ⌊n_sms / tiles⌋, capped at P): bf16 (128 x 256 tiles), split (128 x 128)
    pair_sweep = split_sweep(
        ck, "pair_adjoint_splits", lambda g: adj(g, torch.bfloat16, ck.backproject_pair_group),
        B * -(-N // 128) * -(-N // 256), (8, 16, 17, 23), f"backproject_pair_group bf16 B={B}",
        card)
    split_sweep_b4 = split_sweep(
        ck, "pair_adjoint_splits", lambda g: adj(g, torch.float32, ck.backproject_pair_group),
        B * -(-N // 128) * -(-N // 128), (4, 8, 9, 16, 23),
        f"backproject_pair_group float32 (split) B={B}", card)
    # each split-route call by kernel: products, stages 3 / 3ᵀ, prep, reduce
    split_shares = {}
    for B_ in (B, 256):
        calls = pair_inputs(B_)
        for op, impl in (("project_pair_group", ck.project_pair_group),
                         ("backproject_pair_group", ck.backproject_pair_group)):
            split_shares[f"{op}_b{B_}"] = call_profile(
                lambda call=calls[op], impl=impl: call("x", torch.float32, impl),
                f"{op} float32 (split) B={B_} group x", card)
        del calls
    for e in entries:
        op = e["name"]
        # "ms" / "ms_f32" are the device times of the routes the main path
        # takes; the back-to-back host-clocked times stay as ms_eager*
        e["ms_eager"], e["ms_eager_f32"] = e["ms"], e["ms_f32"]
        e.update(ab[op])
        e.update(ab32[op])
        e["ms"] = ab[op]["ms_tc_b4"]
        e["ms_f32"] = ab32[op]["ms_split_f32_b4"]
        e["bound_ms_f32_fp32"], e["bound_by_f32_fp32"] = fp32_bound
        e["launches_tc"], e["launches_split"] = counts[op][1], counts[op][2]
        e["source_f32"] = "pdunet_tpu_torch/ops/radon/csrc/radon_pair_split.cu"
        fwd_op = op == "project_pair_group"
        e["hgmma"] = hgmma["pair_tc_fwd" if fwd_op else "pair_tc_adj"]
        e["hgmma_f32"] = hgmma["pair_split_fwd" if fwd_op else "pair_split_adj"]
        e["rel_err_f32_vs_tiled_split"] = max(v[0 if fwd_op else 1] for v in split_rel.values())
        e["operand_dtype"] = ("bfloat16 on tensor cores; f32 keys *_f32: split-bf16 route on "
                              "tensor cores, bound_ms_f32 its bound, bound_ms_f32_fp32 the FP32 "
                              "CUDA-core bound")
    entries.append(table_entry(
        ck.build_pair_tables, ck._pair_tables, (*pair_rows(plan, "x")[:3], plan.spec, L),
        launches["build_pair_tables"], "pdunet_tpu/ops/radon/pallas_kernels.py:167",
        "once per plan and angle group (pdunet_parallel: in build_task)", card))
    entries.append(table_entry(
        ck.build_pair_split_tables, ck._pair_split_tables,
        (*pair_rows(plan, "x")[:3], plan.spec, L), launches["build_pair_split_tables"],
        "pdunet_tpu/ops/radon/pallas_kernels.py:167",
        "once per f32 plan and angle group (pdunet_parallel: at the first synthesis)", card))

    def one_recon():
        with torch.inference_mode():
            task.recon_fn(task.model, batch)

    recon_s = recon_rate(one_recon, B, card, config.name)
    # the synthesis (f32 A + FBP) at batch 4 and 256 on the split route
    big = random_phantom_batch(torch.Generator(device=dev).manual_seed(5), 256, N, device=dev)
    synth = {}
    for B_, img in ((B, batch["image"]), (256, big)):
        synth[f"split_b{B_}"] = cuda_ms(lambda: task.batch_from_images(img),
                                        iters=10 if B_ == B else 3)
        print(f"[time] batch_from_images (f32 A + FBP) at batch {B_}: split route "
              f"{synth[f'split_b{B_}']:.4f} ms ({card})")
    del big
    profile_recon(one_recon, card)

    elapsed("phases 1-5 (build, pair kernels, pdunet_parallel)")
    radial_entries, radial_stats = radial_phases(dev, card, gen)
    for e in radial_entries:
        if e["name"] in ("project_group", "backproject_group"):
            fwd_op = e["name"] == "project_group"
            e["hgmma"] = hgmma["group_tc_fwd" if fwd_op else "group_tc_adj"]
            e["hgmma_f32"] = hgmma["group_split_fwd" if fwd_op else "group_split_adj"]
    elapsed("phases 6-8 (radial)")
    probe_entries = probe_phases(dev, card, gen)
    for e in probe_entries:
        if e["name"] in ("project_group_packed", "backproject_group_packed"):
            op = "fwd" if e["name"] == "project_group_packed" else "adj"
            e["hgmma"] = {f"proto_tc_{op}{d}": hgmma[f"proto_tc_{op}{d}"] for d in ("", "_dbl")}
            e["hgmma_f32"] = hgmma[f"proto_split_{op}"]
        else:
            body = "dbl" if e["name"] == "project_pair_group_doubling" else "notrig"
            e["hgmma"] = hgmma[f"pair_proto_tc_fwd_{body}"]
            e["hgmma_f32"] = hgmma[f"pair_proto_split_fwd_{body}"]
    elapsed("phases 9-11 (probes)")
    bench_row = bench_phase(card)
    elapsed("phase 12 (bench headline)")
    train_stats = train_phases(dev, card)
    elapsed("phase 13 (training)")
    dense = dense_plan_phase(dev, card, gen)
    elapsed("phase 14a (dense plan)")
    slice_b = slice_b_phases(dev, card)
    elapsed("phases 14b-f (slice B presets)")
    slice_c = slice_c_phases(dev, card, gen)
    elapsed("phases 15-16 (pdunet_fan, sino_unet_radial)")
    data_paths = data_path_phases(dev, card)
    elapsed("phases 17-17b (file-backed pdunet_parallel and pdunet_radial)")
    gridding = gridding_phase(dev, card, gen)
    elapsed("phase 18 (gridding NUFFT)")
    mesh = mesh_phases(dev, card, gen)
    elapsed("phases 19-20 (angle-sharded operators, sharded training and serving)")
    scripts = scripts_phase(card)
    elapsed("phase 21 (scripts)")
    layouts = layout_phase(dev, card)
    elapsed("phase 22 (cuDNN layout conversions per recon)")
    for e in entries + radial_entries:
        preset = {"project_pair_group": "pdunet_parallel", "backproject_pair_group":
                  "pdunet_parallel", "project_group": "pdunet_radial",
                  "backproject_group": "pdunet_radial"}.get(e["name"])
        if preset:
            op = "fwd" if e["name"].startswith("project") else "adj"
            e["launches_per_train_step"] = {
                "preset": preset, **train_stats[preset]["launches_per_step"][op]}
            # the file-backed paths (phases 17 / 17b), each counted from 0:
            # train() or train --data, one step after a warm one, and infer
            i = 0 if op == "fwd" else 2
            fb = data_paths[preset]
            e["launches_file_backed"] = {
                "preset": preset, "train_tc": fb["launches"][i],
                "train_split": fb["launches"][i + 1],
                "train_step_tc": fb["launches_per_step"][f"{op}_tc"],
                "train_step_split": fb["launches_per_step"][f"{op}_split"],
                "infer_tc": fb["infer_launches"][i], "infer_split": fb["infer_launches"][i + 1]}
            if preset == "pdunet_radial":
                # the gridding path (phase 18): served and trained with none
                e["launches_gridding_path"] = gridding["trained_launches"][i] + \
                    gridding["trained_launches"][i + 1]
        if e["name"] in ("project_pair_group", "backproject_pair_group"):
            # the slice-B paths, each counted from 0 (phase 14): serving
            # (build_task + 2 batches) and one train step; the split route
            # on the dense 360-angle plan (phase 14a)
            i = 0 if e["name"].startswith("project") else 2
            e["launches_slice_b"] = {
                name: {"serve_tc": st["serve_launches"][i],
                       "serve_split": st["serve_launches"][i + 1],
                       "train_step_tc": st["launches_per_step"]["fwd_tc" if i == 0 else "adj_tc"],
                       "train_step_split": st["launches_per_step"][
                           "fwd_split" if i == 0 else "adj_split"]}
                for name, st in slice_b.items()}
            e["dense_plan_split"] = {k: v for k, v in dense.items()
                                     if k.startswith(e["name"])}
            # pdunet_fan (phase 15): its path's counts from 0, and both
            # routes on its sparse and dense backing plans (phase 15a)
            st = slice_c["pdunet_fan"]
            e["launches_pdunet_fan"] = {
                "serve_tc": st["serve_launches"][i], "serve_split": st["serve_launches"][i + 1],
                "train_step_tc": st["launches_per_step"]["fwd_tc" if i == 0 else "adj_tc"],
                "train_step_split": st["launches_per_step"][
                    "fwd_split" if i == 0 else "adj_split"]}
            e["fan_plans"] = {plan: {k: v for k, v in fp.items() if k.startswith(e["name"])}
                              for plan, fp in slice_c["fan_plans"].items()}
        if e["name"] in ("project_group", "backproject_group"):
            # sino_unet_radial (phase 16): its path's counts from 0, and the
            # split route on its dense 512-spoke plan (phase 16a)
            i = 0 if e["name"].startswith("project") else 2
            st = slice_c["sino_unet_radial"]
            e["launches_sino_unet_radial"] = {
                "serve_split": st["serve_launches"][i + 1],
                "train_step_split": st["launches_per_step"][
                    "fwd_split" if i == 0 else "adj_split"]}
            e["dense_radial_split"] = {k: v for k, v in slice_c["radial_dense_plan"].items()
                                       if k.startswith(e["name"])}
        if e["name"] in ROWS_1_4:
            # phases 19-20: this kernel's launches in each rank of one sharded
            # step per mesh, its sharded operators' per-rank times, and its
            # worst error against the plain version over the shards
            e["launches_per_rank_sharded_step"] = {
                name: [r[e["name"]] for r in st["launches_per_rank"]]
                for name, st in mesh["steps"].items()}
            e["sharded_ops"] = {name: [r["ms"] for r in st["per_rank"]]
                                for name, st in mesh["sharded_ops"].items()
                                if e["name"] in st["per_rank"][0]["launches"]}
            e["shard_plain_err"] = {k: v for k, v in mesh["shard_kernels"]["errs"].items()
                                    if k.startswith(e["name"] + "/")}
            # phase 21: its launches by route in the in-process script runs
            e["launches_scripts"] = {name: counts[e["name"]]
                                     for name, counts in scripts["launches"].items()}

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    print(json.dumps({"kernels": entries + radial_entries + probe_entries,
                      "recon_slices_per_s": B / recon_s,
                      "recon_ms_per_batch": recon_s * 1e3, "batch": B,
                      "radial": radial_stats, "bench_headline_b32": bench_row,
                      "bf16_dot_test": dot_bf16, "hgmma": hgmma,
                      "pair_adjoint_split_sweep_b4": pair_sweep,
                      "pair_split_adjoint_split_sweep_b4": split_sweep_b4,
                      "pair_split_call_profile_ms": split_shares,
                      "batch_from_images_ms": synth,
                      "adjoint_dot_rel_f32": adj_rel, "tf32_default_small_rel_cpu": tf32_rel,
                      "train": train_stats, "dense_plan": dense, "slice_b": slice_b,
                      "slice_c": slice_c, "data_path": data_paths, "gridding": gridding,
                      "mesh": mesh, "scripts": scripts, "layout_conversions": layouts,
                      "build_s": build_s, "phase_s": phase_s, "card": card}))
    print(card_line())
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
