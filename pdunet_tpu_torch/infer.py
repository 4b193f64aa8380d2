"""Reconstruction / evaluation entry point of the PyTorch port (port of the
synthetic-data path of ``infer.py``).

Synthesises noiseless ellipse-phantom test batches on the device, runs the
task's reconstruction and reports per-slice PSNR/SSIM mean ± std, with the
weights of a checkpoint written by ``python -m pdunet_tpu_torch.train``
(``--ckpt-dir``; ``--ckpt latest``, ``best`` or a step), or random weights
from seed 0 without one.

Usage:
  python -m pdunet_tpu_torch.infer --preset pdunet_parallel --n-slices 32
  python -m pdunet_tpu_torch.infer --preset pdunet_radial --n-slices 32
  python -m pdunet_tpu_torch.infer --preset lpd_parallel --n-slices 32
  python -m pdunet_tpu_torch.infer --preset pdunet_fan --n-slices 32
  python -m pdunet_tpu_torch.infer --preset sino_unet_radial --n-slices 32
  python -m pdunet_tpu_torch.infer --preset pdunet_parallel --ckpt-dir runs/pd --ckpt best
  python -m pdunet_tpu_torch.infer --preset pdunet_parallel --device cpu \\
      --set geometry.image_size=32 --json-out metrics.json
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

from pdunet_tpu_torch.configs import ExperimentConfig, get_preset
from pdunet_tpu_torch.ops.metrics import psnr, ssim
from pdunet_tpu_torch.training.checkpoint import CheckpointManager
from pdunet_tpu_torch.training.loop import build_state
from pdunet_tpu_torch.training.tasks import build_task


#: presets the port runs: all seven
PORTED = ("pdunet_parallel", "pdunet_radial", "fbp_unet_parallel", "sino_unet_parallel",
          "lpd_parallel", "pdunet_fan", "sino_unet_radial")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", required=True, help=f"ported: {', '.join(PORTED)}")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE")
    p.add_argument("--ckpt-dir", default=None, help="checkpoint to evaluate")
    p.add_argument("--ckpt", default="latest",
                   help="latest | best | <step> (with --ckpt-dir)")
    p.add_argument("--n-slices", type=int, default=64, help="synthetic test-set size")
    p.add_argument("--batch", type=int, default=None)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda")
    p.add_argument("--json-out", default=None, help="write metrics JSON here")
    return p.parse_args(argv)


def resolve_config(args) -> ExperimentConfig:
    config = get_preset(args.preset)
    overrides = dict(item.partition("=")[::2] for item in args.set)
    if overrides:
        config = config.override(overrides)
    if args.batch:
        config = dataclasses.replace(
            config, train=dataclasses.replace(config.train, batch_size=args.batch))
    return config


def main(argv=None):
    args = parse_args(argv)
    config = resolve_config(args)
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
        print(f"[infer] restored step {ckpt_step} ({args.ckpt}) from {ckpt_dir}")
    else:
        print("[infer] WARNING: no --ckpt-dir; evaluating randomly-initialized params")

    all_psnr, all_ssim = [], []
    gen = torch.Generator(device=device).manual_seed(args.seed)
    task.model.eval()
    with torch.inference_mode():
        for _ in range(max(1, args.n_slices // B)):
            clean = task.make_batch(gen)
            # the complex ground truth where the task has one: re-synthesising
            # from the magnitude alone would score an easier zero-phase set
            batch = task.batch_from_images(clean.get("image_c", clean["image"]))
            recon = task.recon_fn(task.model, batch)
            all_psnr.extend(psnr(recon, batch["image"]).cpu().tolist())
            all_ssim.extend(ssim(recon, batch["image"]).cpu().tolist())

    table = {
        "n_slices": len(all_psnr),
        "psnr_mean": float(np.mean(all_psnr)),
        "psnr_std": float(np.std(all_psnr)),
        "ssim_mean": float(np.mean(all_ssim)),
        "ssim_std": float(np.std(all_ssim)),
        "device": str(device),
        "ckpt_step": ckpt_step,
    }
    print(f"[infer] {config.name}: "
          f"PSNR {table['psnr_mean']:.2f} ± {table['psnr_std']:.2f} dB  "
          f"SSIM {table['ssim_mean']:.4f} ± {table['ssim_std']:.4f}  "
          f"({table['n_slices']} slices)")
    if args.json_out:
        pathlib.Path(args.json_out).write_text(json.dumps(table, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
