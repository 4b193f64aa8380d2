"""Quality-vs-acceleration sweep (counterpart of
``scripts/acceleration_sweep.py``).

Trains each method at several undersampling factors under a matched SAMPLE
budget and scores each best-val checkpoint on held-out slices: one JSON per
cell (``artifacts/torch/sweep/<preset>_s<k>.json``) and a combined table
(``artifacts/torch/acceleration_sweep.json``). A cell's overrides are the
reference's (``cell_sets``), so a cell here is the reference's cell.

Cells run one after another as ``python -m pdunet_tpu_torch.train`` /
``python -m pdunet_tpu_torch.infer`` children (checkpoints under
``runs/torch/sweep/<cell>``), so an interrupted sweep resumes from its
checkpoints. Cells whose JSON exists are skipped (``--force`` redoes them).

    python -m pdunet_tpu_torch.scripts.acceleration_sweep          # the full sweep
    python -m pdunet_tpu_torch.scripts.acceleration_sweep --presets pdunet_parallel \\
        --sparsities 2 --tiny --device cpu                         # smoke run
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[2]
#: the directory that holds ``artifacts/torch/`` and ``runs/torch/``
ROOT = REPO

# CT parallel: the paper's three methods on one geometry; radial MRI: its
# two methods. Fan rides along at sparsity 4 only via the shipped preset.
DEFAULT_PRESETS = (
    "pdunet_parallel", "fbp_unet_parallel", "sino_unet_parallel",
    "lpd_parallel", "pdunet_radial", "sino_unet_radial",
)


def run(cmd: list) -> float:
    """Run a child from the repository root; its wall time in seconds."""
    print("+", " ".join(cmd), flush=True)
    t0 = time.monotonic()
    proc = subprocess.run(cmd, cwd=REPO)
    if proc.returncode == 87:
        # the child's watchdog fired (utils/watchdog.py): training resumes
        # from its last checkpoint, so one retry in place recovers the cell
        print(f"[wedge] child exit 87, retrying once: {' '.join(cmd)}", flush=True)
        proc = subprocess.run(cmd, cwd=REPO)
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, cmd)
    return time.monotonic() - t0


def cell_sets(preset: str, sparsity: int, *, batch: int, lr: float, steps: int,
              tiny: bool = False, extra=()) -> list:
    """The dotted config overrides of one sweep cell (train and infer)."""
    # about ten eval and checkpoint points per run
    every = min(max(steps // 10, 100), 1000, steps)
    sets = [f"geometry.sparsity={sparsity}",
            f"train.batch_size={batch}",
            f"train.learning_rate={lr}",
            "train.warmup_steps=150",
            f"train.eval_every={every}",
            f"train.ckpt_every={every}"]
    # remat on the 10-iteration LPD unroll at large batches, and on the
    # radial unroll at 2x (256 spokes) at large batches: kept so that a cell
    # here is the reference's cell. remat changes no number, only memory
    # and step time.
    if preset.startswith("lpd") and batch >= 16:
        sets += ["model.remat=true"]
    if preset == "pdunet_radial" and sparsity <= 2 and batch >= 16:
        sets += ["model.remat=true"]
    if tiny:
        sets += ["geometry.image_size=32", "geometry.n_angles=40", "train.val_slices=8"]
        if preset.endswith("radial"):
            sets += ["geometry.samples_per_spoke=48"]
    return sets + list(extra)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--presets", default=",".join(DEFAULT_PRESETS))
    p.add_argument("--sparsities", default="2,4,8")
    p.add_argument("--samples", type=int, default=96_000, help="matched sample budget per cell")
    p.add_argument("--batch", type=int, default=32, help="training batch")
    p.add_argument("--lr", type=float, default=1e-3,
                   help="learning rate at --batch (the unscaled base rate, as the "
                        "reference's sweep)")
    p.add_argument("--n-slices", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device of every child")
    p.add_argument("--tiny", action="store_true", help="32² dev geometry")
    p.add_argument("--force", action="store_true", help="redo existing cells")
    p.add_argument("--extra-set", action="append", default=[],
                   help="extra dotted config override forwarded to every cell's train "
                        "and infer (repeatable)")
    p.add_argument("--table-only", action="store_true",
                   help="rebuild artifacts/torch/acceleration_sweep.json from the "
                        "existing cells; never train")
    args = p.parse_args(argv)

    art = ROOT / "artifacts" / "torch"
    out_dir = art / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    dev = ["--device", args.device]

    rows = []
    for preset in args.presets.split(","):
        for k in (int(s) for s in args.sparsities.split(",")):
            cell = f"{preset}_s{k}"
            out = out_dir / f"{cell}.json"
            steps = max(args.samples // args.batch, 1)
            sets = cell_sets(preset, k, batch=args.batch, lr=args.lr, steps=steps,
                             tiny=args.tiny, extra=args.extra_set)
            common = [f"--set={s}" for s in sets]
            if out.exists() and not args.force:
                rows.append(json.loads(out.read_text()))
                print(f"[skip] {cell} (artifact exists)", flush=True)
                continue
            if args.table_only:
                print(f"[missing] {cell} (table-only: not training)", flush=True)
                continue
            ckpt = ROOT / "runs" / "torch" / "sweep" / cell
            t_train = run([sys.executable, "-m", "pdunet_tpu_torch.train", "--preset", preset,
                           "--steps", str(steps), *common, *dev,
                           "--ckpt-dir", str(ckpt), "--metrics", str(ckpt / "metrics.jsonl")])
            run([sys.executable, "-m", "pdunet_tpu_torch.infer", "--preset", preset, *common,
                 *dev, "--ckpt-dir", str(ckpt), "--ckpt", "best",
                 "--n-slices", str(args.n_slices), "--json-out", str(out)])
            q = json.loads(out.read_text())
            q.update(preset=preset, sparsity=k, steps=steps, batch=args.batch,
                     samples=args.samples, train_wall_sec=round(t_train, 1))
            out.write_text(json.dumps(q, indent=2) + "\n")
            rows.append(q)
            print(json.dumps(q), flush=True)

    # the combined table is rebuilt from every cell file there, not only
    # this invocation's: a partial invocation must not shrink it
    all_cells = sorted((json.loads(f.read_text()) for f in out_dir.glob("*.json")),
                       key=lambda c: (c.get("preset", ""), c.get("sparsity", 0)))
    table = art / "acceleration_sweep.json"
    table.write_text(json.dumps({"samples": args.samples, "batch": args.batch, "lr": args.lr,
                                 "cells": all_cells}, indent=2) + "\n")
    print(f"wrote {table} ({len(all_cells)} cells, {len(rows)} touched this invocation)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
