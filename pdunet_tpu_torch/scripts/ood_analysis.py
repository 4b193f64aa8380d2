"""Root-cause analysis of the OOD generalization gaps (counterpart of
``scripts/ood_analysis.py``).

The OOD table (``ood_eval``) shows drops without saying why. Per (preset,
kind) cell this reports, beside the model's PSNR:

  * anchor_psnr — the classical FBP / DCF-adjoint recon of the same sparse
    measurement. If the anchor drops as much as the model, the family is
    intrinsically harder; if the anchor holds while the model drops, the
    learned prior is the problem.
  * resid_rel — CT only: the relative measurement residual ‖A(x̂) − y‖/‖y‖,
    of the model and of the anchor. A residual at in-distribution levels
    while PSNR collapses puts the error in A's null space (the prior
    hallucinates what the measurement cannot contradict); a blown-up one
    means the network corrupts measured components too.
  * psnr_raw — HU volume only: PSNR in raw attenuation units beside the
    windowed score, separating the display window's convention from the
    loss of quality.
  * amplitude probe (``--amplitudes``) — the cell again at scaled
    intensities α·x: training fixes the intensity regime, so a gap that
    closes when α pulls the family into it is amplitude statistics, not
    structure.
  * worst-case PNG triptychs (gt | classical anchor | model) of the
    lowest-PSNR slices, ``artifacts/torch/ood_analysis/<preset>_<kind>_worst*.png``.

The OOD slices are ``ood_eval``'s draws (seed 99), so the analysis scores
the slices the OOD table scored; the ``indist`` row draws as ``infer``'s
synthetic evaluation does (seed 1234). Cells land in
``artifacts/torch/ood_analysis/<preset>_<kind>.json``.

    python -m pdunet_tpu_torch.scripts.ood_analysis --presets pdunet_parallel
    python -m pdunet_tpu_torch.scripts.ood_analysis --tiny --device cpu   # smoke run
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

from pdunet_tpu_torch.data.datasets import SliceDataset
from pdunet_tpu_torch.data.pipeline import MU_WATER, mu_to_hu, normalize_ct_window
from pdunet_tpu_torch.ops.metrics import psnr
from pdunet_tpu_torch.scripts.ood_eval import ensure_store

REPO = pathlib.Path(__file__).resolve().parents[2]
#: the directory that holds ``artifacts/torch/`` and ``runs/torch/``
ROOT = REPO

DEFAULT_PRESETS = (
    "pdunet_parallel", "fbp_unet_parallel", "sino_unet_parallel",
    "lpd_parallel", "pdunet_fan", "pdunet_radial", "sino_unet_radial",
)
KINDS = ("indist", "shepp_logan", "rectangles", "smooth", "textured", "hu_volume")


def build_eval_ops(config, device="cuda"):
    """The task's sparse physics at float32: the geometry and operand type of
    ``build_task``'s synthesis operators, rebuilt because a Task does not
    expose its operators."""
    from pdunet_tpu_torch.training.tasks import build_geometries

    _, sparse = build_geometries(config.geometry)
    if config.geometry.kind == "fan":
        from pdunet_tpu_torch.ops.radon.fan import make_fan_ops

        return make_fan_ops(sparse, dtype=torch.float32, device=device)
    if config.geometry.kind == "radial":
        from pdunet_tpu_torch.ops.nufft import make_radial_ops

        return make_radial_ops(sparse, dtype=torch.float32, device=device)
    from pdunet_tpu_torch.ops.radon.parallel import make_parallel_ops

    return make_parallel_ops(sparse, dtype=torch.float32, device=device)


def classical(ops, img: torch.Tensor) -> torch.Tensor:
    """The classical recon of ``img``'s sparse measurement, FBP (CT) or the
    DCF adjoint (radial), as a magnitude where it is complex."""
    recon = ops.fbp(ops.A(img))
    return recon.abs() if recon.is_complex() else recon


def hu_window(x: torch.Tensor) -> torch.Tensor:
    """Relative attenuation in the C40/W400 soft-tissue window, in [0, 1]:
    ``ood_eval``'s scoring convention for the HU volume."""
    return normalize_ct_window(mu_to_hu(x * MU_WATER), 40.0, 400.0)


def psnr_windowed(recon: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return psnr(hu_window(recon), hu_window(target), data_range=1.0)


def resid_rel(ops, recon: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per slice ‖A(recon) − y‖ / ‖y‖ (CT: ``recon`` the real estimate, ``y``
    the sparse measurement)."""
    Ar = ops.A(recon.float())
    return (torch.sqrt(torch.sum((Ar - y) ** 2, dim=(-2, -1)))
            / torch.sqrt(torch.sum(y ** 2, dim=(-2, -1))))


def complex_images(mag: np.ndarray, phase: np.ndarray, device) -> torch.Tensor:
    """m·cos φ + i·m·sin φ, each part formed in float32 numpy (the
    reference's construction, not e^{iφ})."""
    return torch.complex(torch.as_tensor(mag * np.cos(phase), device=device),
                         torch.as_tensor(mag * np.sin(phase), device=device))


def load_slices(kind, config, n, out_dir, force=False):
    """(magnitudes, phases or None) float32 ground-truth slices of ``kind``
    from ``ood_eval``'s store (written here when missing), HU stores in
    relative attenuation; (None, None) for ``indist``."""
    if kind == "indist":
        return None, None
    is_complex = config.geometry.kind == "radial"
    store = ensure_store(pathlib.Path(out_dir), kind, n, config.geometry.image_size,
                         is_complex, force)
    ds = SliceDataset(str(store), split="test")
    try:
        # the dataset converts an HU store to μ/μ_water on read, once
        return ds.parts(range(min(n, len(ds))))
    finally:
        ds.close()


def _export_worst(worst, out_dir, preset, kind, count):
    """The ``count`` lowest-PSNR slices as triptychs (gt | anchor | model),
    each scaled by its 1-99 percentile range; returns the file names."""
    from pdunet_tpu_torch.utils.png import write_gray_png

    names = []
    for j, (_, g, a, r) in enumerate(sorted(worst, key=lambda w: w[0])[:count]):
        trip = np.concatenate([g, a, r], axis=1)
        lo, hi = np.percentile(trip, [1, 99])
        trip = np.clip((trip - lo) / max(hi - lo, 1e-9), 0, 1)
        path = out_dir / f"{preset}_{kind}_worst{j}.png"
        write_gray_png(path, (trip * 255).astype(np.uint8))
        names.append(path.name)
    return names


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--presets", default=",".join(DEFAULT_PRESETS))
    p.add_argument("--kinds", default=",".join(KINDS))
    p.add_argument("--ckpt-root", default="runs/torch/sweep",
                   help="directory holding <preset><suffix>/ checkpoint dirs (a relative "
                        "path is under the root that holds artifacts/torch/)")
    p.add_argument("--suffix", default="_s4")
    p.add_argument("--sparsity", type=int, default=4)
    p.add_argument("--n-slices", type=int, default=32)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--amplitudes", default="",
                   help="comma-separated α grid for the intensity-regime probe "
                        "(e.g. 0.25,0.5,1.0); empty disables")
    p.add_argument("--export-worst", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--tiny", action="store_true", help="32² dev geometry")
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--out-dir", default=None,
                   help="cell directory (default artifacts/torch/ood_analysis)")
    p.add_argument("--force", action="store_true")
    args = p.parse_args(argv)

    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.training.checkpoint import CheckpointManager
    from pdunet_tpu_torch.training.loop import build_state
    from pdunet_tpu_torch.training.tasks import build_task
    from pdunet_tpu_torch.utils import watchdog

    watchdog.start(float(os.environ.get("PDUNET_WATCHDOG_SECS", 0)), label="ood_analysis")
    device = torch.device(args.device)
    out_dir = (pathlib.Path(args.out_dir) if args.out_dir
               else ROOT / "artifacts" / "torch" / "ood_analysis")
    out_dir.mkdir(parents=True, exist_ok=True)
    amps = [float(a) for a in args.amplitudes.split(",") if a]

    for preset in args.presets.split(","):
        overrides = {"geometry.sparsity": str(args.sparsity)}
        overrides.update(s.split("=", 1) for s in args.set)
        if args.tiny:
            overrides.update({"geometry.image_size": "32", "geometry.n_angles": "40"})
            if preset.endswith("radial"):
                overrides["geometry.samples_per_spoke"] = "48"
        config = get_preset(preset).override(overrides)
        config = dataclasses.replace(
            config, train=dataclasses.replace(config.train, batch_size=args.batch))
        is_complex = config.geometry.kind == "radial"
        is_ct = not is_complex
        ckpt = ROOT / args.ckpt_root / f"{preset}{args.suffix}"
        if not (ckpt / "best").exists():
            print(f"[skip] {preset}: no checkpoint at {ckpt}", flush=True)
            continue
        task = build_task(config, device=device)
        if CheckpointManager(str(ckpt / "best")).restore(build_state(task)) is None:
            print(f"[skip] {preset}: empty best slot at {ckpt}", flush=True)
            continue
        model = task.model.eval()
        ops = build_eval_ops(config, device)

        for kind in args.kinds.split(","):
            if kind == "hu_volume" and not is_ct:
                continue
            out = out_dir / f"{preset}_{kind}.json"
            if out.exists() and not args.force:
                print(f"[skip] {preset}/{kind} (artifact exists)", flush=True)
                continue
            mag, phase = load_slices(kind, config, args.n_slices, out_dir, args.force)
            rows = {"psnr": [], "anchor_psnr": [], "resid_model": [],
                    "resid_anchor": [], "psnr_raw": []}
            amp_psnr = {a: [] for a in amps}
            worst = []  # (psnr, gt, anchor, recon) candidates
            B = args.batch
            n = args.n_slices if mag is None else min(args.n_slices, len(mag))
            gen = torch.Generator(device=device).manual_seed(1234)  # infer's synthetic eval

            with torch.inference_mode():
                for bi in range(max(1, n // B)):
                    if mag is None:  # the in-distribution reference row
                        clean = task.make_batch(gen)
                        img = clean.get("image_c", clean["image"])
                    else:
                        m = mag[bi * B:(bi + 1) * B]
                        if len(m) < B:
                            break
                        img = (complex_images(m, phase[bi * B:(bi + 1) * B], device)
                               if is_complex else torch.as_tensor(m, device=device))
                    batch = task.batch_from_images(img)
                    gt = batch["image"]
                    recon = task.recon_fn(model, batch)
                    anchor = classical(ops, img)
                    if kind == "hu_volume":
                        # both conventions: the OOD table's windowed number
                        # and the raw attenuation-domain one
                        rows["psnr_raw"].extend(psnr(recon, gt).tolist())
                        ps, pa = psnr_windowed(recon, gt), psnr_windowed(anchor, gt)
                    else:
                        ps, pa = psnr(recon, gt), psnr(anchor, gt)
                    rows["psnr"].extend(ps.tolist())
                    rows["anchor_psnr"].extend(pa.tolist())
                    if is_ct:
                        y = batch["sino"] if "sino" in batch else ops.A(gt)
                        rows["resid_model"].extend(resid_rel(ops, recon, y).tolist())
                        rows["resid_anchor"].extend(resid_rel(ops, anchor, y).tolist())
                    for a in amps:
                        ab = task.batch_from_images(img * a)
                        amp_psnr[a].extend(psnr(task.recon_fn(model, ab), ab["image"]).tolist())
                    ps_np = ps.float().cpu().numpy()
                    for i in np.argsort(ps_np)[:args.export_worst]:
                        worst.append((float(ps_np[i]), gt[i].float().cpu().numpy(),
                                      anchor[i].float().cpu().numpy(),
                                      recon[i].float().cpu().numpy()))
                    watchdog.beat()  # one batch round-tripped the device

            cell = {"preset": preset, "kind": kind, "n_slices": len(rows["psnr"]),
                    "psnr_mean": round(float(np.mean(rows["psnr"])), 3),
                    "anchor_psnr_mean": round(float(np.mean(rows["anchor_psnr"])), 3),
                    "worst_png": _export_worst(worst, out_dir, preset, kind,
                                               args.export_worst)}
            if rows["psnr_raw"]:
                cell["psnr_raw_mean"] = round(float(np.mean(rows["psnr_raw"])), 3)
            if rows["resid_model"]:
                cell["resid_rel_model"] = round(float(np.mean(rows["resid_model"])), 5)
                cell["resid_rel_anchor"] = round(float(np.mean(rows["resid_anchor"])), 5)
            if amps:
                cell["amplitude_psnr"] = {str(a): round(float(np.mean(v)), 3)
                                          for a, v in amp_psnr.items()}
            out.write_text(json.dumps(cell, indent=2) + "\n")
            print(json.dumps(cell), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
