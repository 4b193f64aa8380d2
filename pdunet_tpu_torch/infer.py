"""Reconstruction / evaluation entry point of the PyTorch port (port of
``infer.py``).

Runs the task's reconstruction over a test set and reports per-slice
PSNR/SSIM mean ± std, with the weights of a checkpoint written by
``python -m pdunet_tpu_torch.train`` (``--ckpt-dir``; ``--ckpt latest``,
``best`` or a step), or random weights from seed 0 without one. The test
set is noiseless ellipse phantoms synthesised on the device
(``--n-slices``), or the ``--split`` of a slice store (``--data``: an npy
directory, or an ``.h5`` file where h5py is installed). ``--corrupt``
scores under the preset's training noise; ``--hu-window C W`` scores in a
clinical HU display window; ``--export-png`` writes the first
reconstructions and their ground truth as 8-bit greyscale PNGs.

Usage:
  python -m pdunet_tpu_torch.infer --preset pdunet_parallel --n-slices 32
  python -m pdunet_tpu_torch.infer --preset pdunet_radial --n-slices 32
  python -m pdunet_tpu_torch.infer --config run.json --ckpt-dir runs/pd --ckpt best
  python -m pdunet_tpu_torch.infer --preset pdunet_fan --corrupt --n-slices 32
  python -m pdunet_tpu_torch.infer --preset pdunet_parallel --ckpt-dir runs/pd \\
      --data store --split test --hu-window 40 400 --export-png out/
  python -m pdunet_tpu_torch.infer --preset pdunet_parallel --device cpu \\
      --set geometry.image_size=32 --json-out metrics.json
  python -m pdunet_tpu_torch.infer --preset pdunet_parallel --devices 2 --n-slices 32

``--devices N`` reconstructs on N ranks (processes, as ``train --devices``
starts them): each reconstructs its B/N rows of every batch with the same
weights, and the per-slice PSNR/SSIM are gathered to rank 0 in the
batch's order, so the table is the single-device one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import pathlib
import sys

import numpy as np
import torch

from pdunet_tpu_torch.data.pipeline import MU_WATER, mu_to_hu, normalize_ct_window
from pdunet_tpu_torch.ops.metrics import psnr, ssim
from pdunet_tpu_torch.parallel.launch import add_dist_args, run_ranks
from pdunet_tpu_torch.parallel.sharding import gather_batch, make_mesh, replicate, shard_batch
from pdunet_tpu_torch.training.checkpoint import CheckpointManager
from pdunet_tpu_torch.training.loop import build_state, derive_seed
from pdunet_tpu_torch.training.tasks import build_task
from pdunet_tpu_torch.utils import watchdog

#: presets the port runs: all seven
PORTED = ("pdunet_parallel", "pdunet_radial", "fbp_unet_parallel", "sino_unet_parallel",
          "lpd_parallel", "pdunet_fan", "sino_unet_radial")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", help=f"ported: {', '.join(PORTED)}")
    p.add_argument("--config", help="path to an ExperimentConfig JSON")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--ckpt-dir", default=None, help="checkpoint to evaluate")
    p.add_argument("--ckpt", default="latest",
                   help="latest | best | <step> (with --ckpt-dir)")
    p.add_argument("--data", default=None,
                   help="slice store (npy directory, or .h5 with h5py); else synthetic")
    p.add_argument("--split", default="test", help="dataset split for --data")
    p.add_argument("--n-slices", type=int, default=64,
                   help="synthetic test-set size (ignored with --data)")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--corrupt", action="store_true",
                   help="score under the preset's training noise (e.g. low-dose) "
                        "instead of noiseless synthesis")
    p.add_argument("--hu-window", nargs=2, type=float, default=None,
                   metavar=("CENTER", "WIDTH"),
                   help="score PSNR/SSIM in a HU display window (e.g. 40 400 for soft "
                        "tissue): recon and ground truth go relative attenuation → HU → "
                        "window clipped to [0, 1], scored with data range 1")
    p.add_argument("--export-png", default=None, help="directory for PNG dumps")
    p.add_argument("--export-count", type=int, default=4)
    p.add_argument("--json-out", default=None, help="write metrics JSON here")
    p.add_argument("--device", default="cuda")
    p.add_argument("--devices", type=int, default=None,
                   help="data-parallel eval: shard each batch over N ranks")
    add_dist_args(p)
    p.add_argument("--watchdog-secs", type=float,
                   default=float(os.environ.get("PDUNET_WATCHDOG_SECS", 0)),
                   help="abort (exit 87) if no eval batch completes for this many "
                        "seconds. 0 disables (default; env PDUNET_WATCHDOG_SECS)")
    return p.parse_args(argv)


def resolve_config(args):
    """``train.resolve_config`` (preset or ``--config``, then ``--set``),
    then ``--batch``."""
    from pdunet_tpu_torch.train import resolve_config as train_resolve

    config = train_resolve(args)
    if args.batch:
        config = dataclasses.replace(
            config, train=dataclasses.replace(config.train, batch_size=args.batch))
    return config


def _export_png(path, image: torch.Tensor) -> None:
    """Min-max normalise one slice to uint8 and write it as a greyscale PNG."""
    from pdunet_tpu_torch.utils.png import write_gray_png

    a = image.detach().float().cpu().numpy()
    a = (a - a.min()) / max(a.max() - a.min(), 1e-9)
    write_gray_png(path, (a * 255).astype(np.uint8))


def main(argv=None):
    args = parse_args(argv)
    config = resolve_config(args)
    B = config.train.batch_size
    n_dev = args.devices or 1
    if B % n_dev:
        raise SystemExit(f"--devices {args.devices} must divide batch size {B}")
    reported_device = args.device
    if run_ranks("pdunet_tpu_torch.infer", args, argv, n_dev) == 0:
        return 0
    mesh = make_mesh(n_dev) if n_dev > 1 else None
    primary = mesh is None or mesh.rank == 0
    try:
        return _run(args, config, mesh, primary, reported_device)
    finally:
        if mesh is not None:
            torch.distributed.destroy_process_group()


def _run(args, config, mesh, primary, reported_device):
    if args.watchdog_secs > 0:
        # armed before any device work: build_task runs the power iteration
        watchdog.start(args.watchdog_secs, label="infer")
    device = torch.device(args.device)
    task = build_task(config, device=device)
    B = config.train.batch_size
    ckpt_step = None
    if args.ckpt_dir:
        ckpt_dir, step = args.ckpt_dir, None
        if args.ckpt == "best":
            # the best validation weights live in their own single-slot directory
            ckpt_dir = os.path.join(args.ckpt_dir, "best")
        elif args.ckpt != "latest":
            step = int(args.ckpt)
        restored = CheckpointManager(ckpt_dir).restore(build_state(task), step=step)
        if restored is None:
            raise SystemExit(f"no {args.ckpt} checkpoint found in {ckpt_dir}")
        ckpt_step = restored.step
        if primary:
            print(f"[infer] restored step {ckpt_step} ({args.ckpt}) from {ckpt_dir}")
    elif primary:
        print("[infer] WARNING: no --ckpt-dir; evaluating randomly-initialized params")
    if mesh is not None:
        replicate(task.model, mesh)

    if args.hu_window:
        center, width = args.hu_window

        def metrics(r, t):
            # slices are relative attenuation μ/μ_water; the window maps to
            # [0, 1] by construction, so score against that fixed range (a
            # slice with nothing inside the window has peak-to-peak 0)
            def windowed(x):
                return normalize_ct_window(mu_to_hu(x * MU_WATER), center, width)

            return (psnr(windowed(r), windowed(t), data_range=1.0),
                    ssim(windowed(r), windowed(t), data_range=1.0))
    else:
        def metrics(r, t):
            return psnr(r, t), ssim(r, t)

    all_psnr, all_ssim = [], []
    exported = 0
    export_dir = pathlib.Path(args.export_png) if args.export_png else None
    if export_dir:
        export_dir.mkdir(parents=True, exist_ok=True)
    task.model.eval()

    def eval_batch(batch, tag):
        nonlocal exported
        image = batch["image"]
        if mesh is not None:  # this rank's rows; the results in the batch's order
            batch = shard_batch(batch, mesh)
        recon = task.recon_fn(task.model, batch)
        ps, ss = metrics(recon, batch["image"])
        if mesh is not None:
            ps, ss = gather_batch(ps, mesh), gather_batch(ss, mesh)
            recon = gather_batch(recon, mesh) if export_dir else recon
        all_psnr.extend(ps.cpu().tolist())
        all_ssim.extend(ss.cpu().tolist())
        watchdog.beat()  # the fetch above waited for the device: one whole batch done
        if export_dir and primary:
            for i in range(min(args.export_count - exported, recon.shape[0])):
                _export_png(export_dir / f"{tag}_{exported:03d}_recon.png", recon[i])
                _export_png(export_dir / f"{tag}_{exported:03d}_gt.png", image[i])
                exported += 1

    with torch.inference_mode():
        if args.data:
            from pdunet_tpu_torch.data.datasets import SliceDataset, iterate_batches

            ds = SliceDataset(args.data, split=args.split)
            try:
                if len(ds) < B:
                    raise SystemExit(f"{args.split!r} split has {len(ds)} slices < batch "
                                     f"{B}; pass a smaller --batch")
                for bi, images in enumerate(iterate_batches(ds, B, shuffle=False, epochs=1)):
                    # --corrupt: the training noise, from one generator per batch
                    gen = (torch.Generator(device=device).manual_seed(
                        derive_seed(args.seed + 1, bi)) if args.corrupt else None)
                    eval_batch(task.batch_from_images(torch.as_tensor(images, device=device),
                                                      gen), f"b{bi}")
            finally:
                ds.close()
        else:
            gen = torch.Generator(device=device).manual_seed(args.seed)
            for bi in range(max(1, args.n_slices // B)):
                if args.corrupt:
                    batch = task.make_batch(gen)  # with the training noise
                else:
                    clean = task.make_batch(gen)
                    # the complex ground truth where the task has one:
                    # re-synthesising from the magnitude alone would score
                    # an easier zero-phase set
                    batch = task.batch_from_images(clean.get("image_c", clean["image"]))
                eval_batch(batch, f"b{bi}")

    table = {
        "n_slices": len(all_psnr),
        "psnr_mean": float(np.mean(all_psnr)),
        "psnr_std": float(np.std(all_psnr)),
        "ssim_mean": float(np.mean(all_ssim)),
        "ssim_std": float(np.std(all_ssim)),
        "device": reported_device,
        "ckpt_step": ckpt_step,
    }
    if not primary:
        return 0
    print(f"[infer] {config.name}: "
          f"PSNR {table['psnr_mean']:.2f} ± {table['psnr_std']:.2f} dB  "
          f"SSIM {table['ssim_mean']:.4f} ± {table['ssim_std']:.4f}  "
          f"({table['n_slices']} slices)")
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(table, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
