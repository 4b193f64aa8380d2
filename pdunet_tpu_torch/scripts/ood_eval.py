"""Out-of-distribution evaluation of trained checkpoints (counterpart of
``scripts/ood_eval.py``).

Every quality number of the sweep is scored on held-out draws of the
random-ellipse generator the models trained on. This scores trained best-val
checkpoints on phantom families that distribution cannot produce
(``data/phantoms.py`` ``OOD_KINDS``):

  * shepp_logan — the 10-ellipse head phantom (denser and finer structure
    than the 8-ellipse training draw)
  * rectangles  — sharp corners
  * smooth      — low-frequency fields, nothing piecewise-constant
  * textured    — band-limited texture inside the support
  * hu_volume   — a textured volume stored in Hounsfield units, read back
    through ``SliceDataset``'s HU → μ conversion and scored in the C40/W400
    soft-tissue window (``infer --hu-window 40 400``)

Each (preset, kind) runs ``python -m pdunet_tpu_torch.infer --data STORE
--split test --ckpt best`` on a generated npy store and writes
``artifacts/torch/ood/<preset>_<kind>.json``; the combined table lands in
``artifacts/torch/ood_eval.json``. The stores are the reference's draws
(seed 99), slice for slice; complex (radial) presets get nonnegative
magnitudes and a smooth polynomial phase, as ``write_phantom_dataset``.

    python -m pdunet_tpu_torch.scripts.ood_eval --presets pdunet_parallel
    python -m pdunet_tpu_torch.scripts.ood_eval --device cpu --presets pdunet_parallel \\
        --n-slices 4 --set geometry.image_size=32 --set geometry.n_angles=40 \\
        --set model.base_features=8   # a 32² sweep cell's checkpoint, on the CPU
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
#: the directory that holds ``artifacts/torch/`` and ``runs/torch/``
ROOT = REPO

DEFAULT_PRESETS = (
    "pdunet_parallel", "fbp_unet_parallel", "sino_unet_parallel",
    "lpd_parallel", "pdunet_fan", "pdunet_radial", "sino_unet_radial",
)


def store_path(out_dir: pathlib.Path, kind: str, image_size: int,
               is_complex: bool) -> pathlib.Path:
    """The npy store of one OOD family at one size."""
    return out_dir / f"ood_{kind}_{image_size}{'_cplx' if is_complex else ''}"


def write_ood_store(path, kind: str, n: int, image_size: int, complex_phase: bool,
                    seed: int = 99) -> None:
    """``n`` slices of the OOD family ``kind`` (all in the test split), drawn
    as the reference's ``write_ood_h5`` draws them: one generator, each
    slice then (complex) its phase's four coefficients."""
    from pdunet_tpu_torch.data.datasets import write_store
    from pdunet_tpu_torch.data.phantoms import ood_phantom

    rng = np.random.default_rng(seed)
    shape = (n, image_size, image_size)
    slices = np.empty(shape, np.float32)
    phase = np.empty(shape, np.float32) if complex_phase else None
    for i in range(n):
        slices[i] = ood_phantom(kind, rng, image_size, nonneg=complex_phase)
        if phase is not None:
            ax = np.linspace(-1, 1, image_size)
            X, Y = np.meshgrid(ax, ax)
            c = rng.uniform(-np.pi, np.pi, 4)
            phase[i] = c[0] * X + c[1] * Y + c[2] * X * Y + c[3] * (X ** 2 - Y ** 2)
    write_store(str(path), slices, phase)


def write_hu_volume(path, n: int, image_size: int, seed: int = 99) -> None:
    """Textured phantoms rescaled to a plausible CT HU range (soft tissue
    ±300 HU around water inside the body support, air = −1000 HU outside),
    stored with ``convert_volume(domain="hu")``.

    The read converts HU → μ/μ_water = 1 + HU/1000, so air maps to 0, the
    background the models trained with, and tissue lands around 1.0
    (water), as in clinical CT; a water background would hand every model a
    global offset no real scan has."""
    from pdunet_tpu_torch.data.datasets import convert_volume
    from pdunet_tpu_torch.data.phantoms import ood_phantom

    rng = np.random.default_rng(seed)
    vol = np.stack([ood_phantom("textured", rng, image_size) for _ in range(n)])
    support = np.abs(vol) > 1e-6
    hu = 300.0 * vol / max(np.abs(vol).max(), 1e-6)
    hu = np.where(support, hu, -1000.0).astype(np.float32)
    convert_volume(hu, str(path), domain="hu", train_frac=0.0, val_frac=0.0)


def ensure_store(out_dir: pathlib.Path, kind: str, n: int, image_size: int,
                 is_complex: bool, force: bool = False) -> pathlib.Path:
    """The store of ``kind`` under ``out_dir``, written when missing (or
    ``force``)."""
    path = store_path(out_dir, kind, image_size, is_complex)
    if not path.exists() or force:
        if kind == "hu_volume":
            write_hu_volume(path, n, image_size)
        else:
            write_ood_store(path, kind, n, image_size, is_complex)
    return path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--presets", default=",".join(DEFAULT_PRESETS))
    p.add_argument("--kinds", default="shepp_logan,rectangles,smooth,textured,hu_volume")
    p.add_argument("--ckpt-root", default="runs/torch/sweep",
                   help="directory holding <preset><suffix>/ checkpoint dirs (a relative "
                        "path is under the root that holds artifacts/torch/)")
    p.add_argument("--suffix", default="_s4", help="checkpoint dir suffix under --ckpt-root")
    p.add_argument("--n-slices", type=int, default=32)
    p.add_argument("--sparsity", type=int, default=4,
                   help="geometry.sparsity the checkpoints were trained at")
    p.add_argument("--device", default="cuda", help="torch device of every child")
    p.add_argument("--set", action="append", default=[],
                   help="extra config overrides forwarded to infer (must match the "
                        "checkpoint's training config)")
    p.add_argument("--out-dir", default=None,
                   help="cell directory (default artifacts/torch/ood; point a smoke "
                        "run elsewhere so it cannot shadow the real 256² cells)")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)

    from pdunet_tpu_torch.configs import get_preset

    canonical = ROOT / "artifacts" / "torch" / "ood"
    out_dir = pathlib.Path(args.out_dir) if args.out_dir else canonical
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = []
    for preset in args.presets.split(","):
        # the forwarded overrides, so the stores match the geometry infer
        # evaluates at (a tiny CPU smoke run, or another image size)
        overrides = dict(s.split("=", 1) for s in args.set)
        config = get_preset(preset).override(
            {"geometry.sparsity": str(args.sparsity), **overrides})
        is_complex = config.geometry.kind == "radial"
        image_size = config.geometry.image_size
        ckpt = ROOT / args.ckpt_root / f"{preset}{args.suffix}"
        if not (ckpt / "best").exists():
            print(f"[skip] {preset}: no checkpoint at {ckpt}", flush=True)
            continue
        for kind in args.kinds.split(","):
            if kind == "hu_volume" and is_complex:
                continue  # HU is a CT concept
            out = out_dir / f"{preset}_{kind}.json"
            if out.exists() and not args.force:
                rows.append(json.loads(out.read_text()))
                continue
            store = ensure_store(out_dir, kind, args.n_slices, image_size, is_complex,
                                 args.force)
            cmd = [sys.executable, "-m", "pdunet_tpu_torch.infer", "--preset", preset,
                   f"--set=geometry.sparsity={args.sparsity}",
                   *[f"--set={s}" for s in args.set], "--device", args.device,
                   "--ckpt-dir", str(ckpt), "--ckpt", "best",
                   "--data", str(store), "--split", "test",
                   "--n-slices", str(args.n_slices),
                   # the whole store in as few batches as fit
                   "--batch", str(min(args.n_slices, 32)),
                   "--json-out", str(out)]
            if kind == "hu_volume":
                # soft-tissue display window CENTER 40 / WIDTH 400, i.e.
                # [-160, 240] HU, which holds write_hu_volume's 0-300 HU
                # content (infer takes center and width, not lo and hi)
                cmd += ["--hu-window", "40", "400"]
            print("+", " ".join(cmd), flush=True)
            subprocess.run(cmd, check=True, cwd=REPO)
            q = json.loads(out.read_text())
            q.update(preset=preset, kind=kind)
            out.write_text(json.dumps(q, indent=2) + "\n")
            rows.append(q)
            print(json.dumps(q), flush=True)

    # the combined table beside the cells' canonical directory; a smoke run
    # pointed elsewhere writes its table there instead
    table = (ROOT / "artifacts" / "torch" / "ood_eval.json" if out_dir == canonical
             else out_dir / "ood_eval.json")
    table.write_text(json.dumps({"cells": rows}, indent=2) + "\n")
    print(f"wrote {table} ({len(rows)} cells)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
