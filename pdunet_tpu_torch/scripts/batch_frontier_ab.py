"""Matched-sample-budget batch-size A/B of the training frontier
(counterpart of ``scripts/batch_frontier_ab.py``).

Does a large batch with a scaled learning rate match the quality of the
shipped batch 4 at the same sample budget? This trains the flagship preset
at the reference's (batch, lr, remat) arms (``ARMS``) with one number of
SAMPLES each, then scores each best-val checkpoint on the same held-out
slices, with the median step time from the run's metrics.

Each arm runs ``python -m pdunet_tpu_torch.train`` / ``python -m
pdunet_tpu_torch.infer`` children (checkpoints under ``runs/torch/ab/``,
cells under ``artifacts/torch/ab/``), so an interrupted arm resumes. Results
land in ``artifacts/torch/batch_ab.json``, merged with the arms of earlier
invocations.

    python -m pdunet_tpu_torch.scripts.batch_frontier_ab [--preset pdunet_parallel]
    python -m pdunet_tpu_torch.scripts.batch_frontier_ab --device cpu --tiny --samples 8
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

# lr scaled from the shipped batch-4 base (1e-3): sqrt and linear in the
# batch ratio; the two recovery arms probe a tighter clip and the unscaled
# base rate at batch 32
ARMS = {
    "b4": dict(batch=4, lr=1e-3, remat=False, warmup=200, eval_every=1000),
    "b32_sqrt": dict(batch=32, lr=2.83e-3, remat=False, warmup=150, eval_every=150),
    "b32_lin": dict(batch=32, lr=8e-3, remat=False, warmup=150, eval_every=150),
    "b128_sqrt": dict(batch=128, lr=5.66e-3, remat=True, warmup=50, eval_every=50),
    "b128_lin": dict(batch=128, lr=3.2e-2, remat=True, warmup=50, eval_every=50),
    "b32_sqrt_clip05": dict(batch=32, lr=2.83e-3, remat=False, warmup=150,
                            eval_every=150, clip=0.5),
    "b32_base": dict(batch=32, lr=1e-3, remat=False, warmup=150, eval_every=150),
}

TINY_SETS = ["geometry.image_size=32", "geometry.n_angles=40", "train.val_slices=8",
             "model.base_features=8", "model.n_iters=2", "model.use_bfloat16=false"]


def run(cmd: list) -> float:
    """Run a child from the repository root; its wall time in seconds."""
    print("+", " ".join(cmd), flush=True)
    t0 = time.monotonic()
    subprocess.run(cmd, check=True, cwd=REPO)
    return time.monotonic() - t0


def arm_sets(arm: dict, steps: int) -> list:
    """The dotted overrides of one arm trained for ``steps`` steps."""
    every = min(arm["eval_every"], steps)  # short smoke runs still evaluate
    sets = [f"train.batch_size={arm['batch']}",
            f"train.learning_rate={arm['lr']}",
            f"train.warmup_steps={arm['warmup']}",
            f"train.eval_every={every}",
            f"train.ckpt_every={every}",
            f"model.remat={'true' if arm['remat'] else 'false'}"]
    if "clip" in arm:
        sets.append(f"train.grad_clip={arm['clip']}")
    return sets


def median_step_sec(metrics_jsonl: pathlib.Path):
    """Steady-state seconds per step: the median of the wall-clock deltas per
    step between consecutive logged train rows (the first interval, which
    holds the warm-up, drops out of the median); None with fewer than two."""
    if not metrics_jsonl.exists():
        return None
    rows = [json.loads(line) for line in metrics_jsonl.read_text().splitlines() if line]
    pts = [(r["step"], r["wall_s"]) for r in rows if "wall_s" in r and "loss" in r]
    deltas = [(w1 - w0) / (s1 - s0) for (s0, w0), (s1, w1) in zip(pts, pts[1:]) if s1 > s0]
    return round(sorted(deltas)[len(deltas) // 2], 4) if deltas else None


def train_and_eval(preset: str, tag: str, sets: list, steps: int, n_slices: int,
                   device: str, extra_geo: list) -> dict:
    ckpt = ROOT / "runs" / "torch" / "ab" / tag
    common = [f"--set={s}" for s in sets + extra_geo]
    dev = ["--device", device]
    t_train = run([sys.executable, "-m", "pdunet_tpu_torch.train", "--preset", preset,
                   "--steps", str(steps), *common, *dev,
                   "--ckpt-dir", str(ckpt), "--metrics", str(ckpt / "metrics.jsonl")])
    out = ROOT / "artifacts" / "torch" / "ab" / f"{tag}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    run([sys.executable, "-m", "pdunet_tpu_torch.infer", "--preset", preset, *common, *dev,
         "--ckpt-dir", str(ckpt), "--ckpt", "best", "--n-slices", str(n_slices),
         "--json-out", str(out)])
    metrics = json.loads(out.read_text())
    return {"tag": tag, "steps": steps, "overrides": sets,
            "train_wall_sec": round(t_train, 1),
            "median_step_sec": median_step_sec(ckpt / "metrics.jsonl"),
            "psnr": metrics.get("psnr_mean"), "ssim": metrics.get("ssim_mean")}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--preset", default="pdunet_parallel")
    p.add_argument("--samples", type=int, default=96_000, help="matched sample budget per arm")
    p.add_argument("--n-slices", type=int, default=64)
    p.add_argument("--device", default="cuda", help="torch device of every child")
    p.add_argument("--tiny", action="store_true", help="32² / 40-angle dev geometry")
    p.add_argument("--arms", default=None, help="comma list of arm tags to (re)run; default all")
    args = p.parse_args(argv)

    extra_geo = TINY_SETS if args.tiny else []
    arms = ARMS
    if args.arms:
        keep = args.arms.split(",")
        unknown = sorted(set(keep) - ARMS.keys())
        if unknown:
            raise SystemExit(f"unknown arms {unknown}; options: {list(ARMS)}")
        arms = {k: v for k, v in ARMS.items() if k in keep}

    results = []
    for tag, a in arms.items():
        steps = max(args.samples // a["batch"], 1)
        results.append(train_and_eval(args.preset, f"{args.preset}_{tag}",
                                      arm_sets(a, steps), steps, args.n_slices,
                                      args.device, extra_geo))
        print(json.dumps(results[-1]), flush=True)

    out = ROOT / "artifacts" / "torch" / "batch_ab.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    # merged with earlier invocations: running more --arms keeps their rows
    merged = {}
    if out.exists():
        merged = {r["tag"]: r for r in json.loads(out.read_text()).get("arms", [])}
    merged.update((r["tag"], r) for r in results)
    out.write_text(json.dumps({"preset": args.preset, "samples": args.samples,
                               "arms": list(merged.values())}, indent=2) + "\n")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
