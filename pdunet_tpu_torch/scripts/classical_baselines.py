"""Classical (non-learned) reconstruction baselines per acceleration factor
(counterpart of ``scripts/classical_baselines.py``).

The quality-vs-acceleration table needs the method-free anchor: what
sparse-view FBP (CT) or the DCF-adjoint NUFFT (radial MRI) alone scores at
each undersampling factor. The training tasks compute exactly that
classical recon as the network's input (``batch["f0"]``), so this scores it
on the synthetic held-out distribution ``infer`` uses, per (geometry,
sparsity): 64 slices in batches of 8, each batch drawn from a generator
seeded with ``derive_seed(--seed, batch)``. ``pdunet_fan`` draws its
training noise with them, as its preset trains.

Writes ``artifacts/torch/classical_baselines.json``.

    python -m pdunet_tpu_torch.scripts.classical_baselines
    python -m pdunet_tpu_torch.scripts.classical_baselines --device cpu --tiny
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys

import numpy as np
import torch

from pdunet_tpu_torch.ops.metrics import psnr, ssim

REPO = pathlib.Path(__file__).resolve().parents[2]
#: the directory that holds ``artifacts/torch/``
ROOT = REPO

PRESETS = ("pdunet_parallel", "pdunet_fan", "pdunet_radial")
BATCH = 8


def score(batch: dict):
    """Per-slice (PSNR, SSIM) of the direct recon ``f0`` against the ground
    truth ``image``, both as magnitudes where ``f0`` is complex."""
    f0, img = batch["f0"], batch["image"]
    if f0.is_complex():
        f0, img = f0.abs(), img.abs()
    return psnr(f0, img), ssim(f0, img)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--sparsities", default="2,4,8")
    p.add_argument("--n-slices", type=int, default=64)
    p.add_argument("--seed", type=int, default=1234)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="32² dev geometry")
    args = p.parse_args(argv)

    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.training.loop import derive_seed
    from pdunet_tpu_torch.training.tasks import build_task
    from pdunet_tpu_torch.utils import watchdog

    watchdog.start(float(os.environ.get("PDUNET_WATCHDOG_SECS", 0)),
                   label="classical_baselines")
    device = torch.device(args.device)
    rows = []
    for preset in PRESETS:
        for k in (int(s) for s in args.sparsities.split(",")):
            over = {"geometry.sparsity": k, "train.batch_size": BATCH}
            if args.tiny:
                over.update({"geometry.image_size": 32, "geometry.n_angles": 40})
                if preset.endswith("radial"):
                    over["geometry.samples_per_spoke"] = 48
            config = get_preset(preset).override(over)
            task = build_task(config, device=device)
            all_ps, all_ss = [], []
            with torch.inference_mode():
                for bi in range(-(-args.n_slices // BATCH)):
                    gen = torch.Generator(device=device).manual_seed(
                        derive_seed(args.seed, bi))
                    ps, ss = score(task.make_batch(gen))
                    all_ps.extend(ps.cpu().ravel().tolist())
                    all_ss.extend(ss.cpu().ravel().tolist())
                    watchdog.beat()  # one batch round-tripped the device
            row = {
                "geometry": config.geometry.kind,
                "preset": preset,
                "sparsity": k,
                "method": "dcf_adjoint" if config.geometry.kind == "radial" else "fbp",
                "n_slices": len(all_ps),
                "psnr_mean": round(float(np.mean(all_ps)), 3),
                "ssim_mean": round(float(np.mean(all_ss)), 4),
                "psnr_std": round(float(np.std(all_ps)), 3),
            }
            rows.append(row)
            print(json.dumps(row), flush=True)

    out = ROOT / "artifacts" / "torch" / "classical_baselines.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"cells": rows}, indent=2) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
