"""Render the port's experiment outputs as README-ready markdown (a copy of
``scripts/results_tables.py`` over the port's root).

Reads whatever exists of
  artifacts/torch/sweep/<preset>_s<k>.json      (acceleration_sweep cells)
  artifacts/torch/classical_baselines.json      (classical_baselines)
  artifacts/torch/ood/<preset>_<kind>.json      (ood_eval cells)
  artifacts/torch/ood_analysis/<preset>_<kind>.json   (ood_analysis cells)
  artifacts/torch/noisy_radial_*.json           (the k-space noise arms)
and prints the quality-vs-acceleration matrix with the classical anchors,
the OOD table and the noise table as markdown; cells that have not landed
print as "—". Standard library only: safe to run anywhere.
``--update-readme`` rewrites the README's ``torch-sweep``, ``torch-ood``,
``torch-oodanalysis`` and ``torch-noise`` blocks and nothing else.

    python -m pdunet_tpu_torch.scripts.results_tables [--update-readme]
"""

from __future__ import annotations

import json
import pathlib

REPO = pathlib.Path(__file__).resolve().parents[2]
#: the directory the tables are read from
ART = REPO / "artifacts" / "torch"

SWEEP_PRESETS = (
    "pdunet_parallel", "lpd_parallel", "fbp_unet_parallel",
    "sino_unet_parallel", "pdunet_radial", "sino_unet_radial",
)
# OOD rows also cover the fan geometry: its s4 cell exists as an OOD
# checkpoint, not as part of the acceleration matrix
OOD_PRESETS = SWEEP_PRESETS[:4] + ("pdunet_fan",) + SWEEP_PRESETS[4:]
SPARSITIES = (2, 4, 8)
OOD_KINDS = ("shepp_logan", "rectangles", "smooth", "textured", "hu_volume")
#: the README blocks this renderer owns
BLOCKS = ("torch-sweep", "torch-ood", "torch-oodanalysis", "torch-noise")


def load(path: pathlib.Path):
    return json.loads(path.read_text()) if path.exists() else None


def cell_str(q, with_ssim: bool = True) -> str:
    if q is None:
        return "—"
    s = f"{q['psnr_mean']:.2f}"
    if with_ssim:
        s += f" / {q['ssim_mean']:.4f}"
    if "interim" in q.get("note", ""):
        # a cell trained below the matched budget must never render like one at it
        s += " †"
    return s


def sweep_table() -> str:
    lines = ["| preset | 2× | 4× | 8× |", "|---|---|---|---|"]
    interim = False
    for preset in SWEEP_PRESETS:
        row = [preset]
        for k in SPARSITIES:
            q = load(ART / "sweep" / f"{preset}_s{k}.json")
            if q:
                interim |= "interim" in q.get("note", "")
            row.append(cell_str(q))
        lines.append("| " + " | ".join(row) + " |")
    cb = load(ART / "classical_baselines.json")
    if cb:
        anchors = {(c["preset"], c["sparsity"]): c for c in cb["cells"]}
        for preset, label in (("pdunet_parallel", "FBP (no learning)"),
                              ("pdunet_radial", "DCF-adjoint (no learning)")):
            row = [f"*{label}*"]
            for k in SPARSITIES:
                row.append(cell_str(anchors.get((preset, k))))
            lines.append("| " + " | ".join(row) + " |")
    if interim:
        lines += ["", "† interim cell trained below the matched sample "
                      "budget; not comparable until retrained."]
    tp = throughput_line()
    if tp:
        lines += ["", tp]
    return "\n".join(lines)


def throughput_line():
    """Flagship recon throughput per factor (slices/s/chip), from
    ``bench_sparsity_rows.jsonl`` rows (2x / 8x) and the newest
    ``bench_matrix_r*.jsonl`` (4x) beside the tables, where they exist."""
    per_k = {}
    rows_file = ART / "bench_sparsity_rows.jsonl"
    if rows_file.exists():
        for line in rows_file.read_text().splitlines():
            if not line.strip():
                continue
            try:
                r = json.loads(line)
            except ValueError:
                continue  # a truncated row of a killed bench run
            if (r.get("preset") == "pdunet_parallel" and "sparsity" in r
                    and "recon_slices_per_sec" in r):
                per_k[int(r["sparsity"])] = r["recon_slices_per_sec"]
    matrices = sorted(ART.glob("bench_matrix_r*.jsonl"), reverse=True)
    if 4 not in per_k and matrices:
        for line in matrices[0].read_text().splitlines():
            if not line.strip():
                continue
            r = json.loads(line)
            if r.get("preset") == "pdunet_parallel" and "recon_slices_per_sec" in r:
                per_k[4] = r["recon_slices_per_sec"]
                break
    if not per_k:
        return None
    cells = ", ".join(f"{k}× — {per_k[k]:.0f}" for k in sorted(per_k))
    return (f"Flagship (`pdunet_parallel`) recon throughput by factor, "
            f"slices/s/chip: {cells}.")


def ood_table() -> str:
    header = "| preset (4×) | in-dist | " + " | ".join(OOD_KINDS) + " |"
    lines = [header, "|---|" + "---|" * (len(OOD_KINDS) + 1)]
    for preset in OOD_PRESETS:
        indist = load(ART / "sweep" / f"{preset}_s4.json")
        row = [preset, cell_str(indist, with_ssim=False)]
        for kind in OOD_KINDS:
            row.append(cell_str(load(ART / "ood" / f"{preset}_{kind}.json"), with_ssim=False))
        lines.append("| " + " | ".join(row) + " |")
    return "\n".join(lines)


def analysis_table() -> str:
    """OOD gap attribution (``ood_analysis`` cells): the model beside the
    classical anchor on the same sparse measurement, and the CT measurement
    residual that separates null-space hallucination from data corruption."""
    cells = []
    adir = ART / "ood_analysis"
    if adir.exists():
        for f in sorted(adir.glob("*.json")):
            try:
                cells.append(json.loads(f.read_text()))
            except ValueError:
                continue
    if not cells:
        return ("*(no analysis cells yet — run `python -m "
                "pdunet_tpu_torch.scripts.ood_analysis`)*")
    lines = ["| preset | family | model dB | classical anchor dB | "
             "resid ‖Ax̂−y‖/‖y‖ (model / anchor) |",
             "|---|---|---|---|---|"]
    for c in cells:
        resid = ("—" if "resid_rel_model" not in c else
                 f"{c['resid_rel_model']:.4f} / {c['resid_rel_anchor']:.4f}")
        lines.append(f"| {c['preset']} | {c['kind']} | {c['psnr_mean']:.2f} | "
                     f"{c['anchor_psnr_mean']:.2f} | {resid} |")
    return "\n".join(lines)


def noisy_table() -> str:
    rows = [
        ("trained @ SNR 30 dB", "clean eval", load(ART / "noisy_radial_snr30_clean.json")),
        ("trained @ SNR 30 dB", "SNR-30 eval", load(ART / "noisy_radial_snr30_noisy.json")),
        ("trained clean (s4 sweep)", "SNR-30 eval",
         load(ART / "noisy_radial_cleantrained_noisy.json")),
        ("trained clean (s4 sweep)", "clean eval", load(ART / "sweep" / "pdunet_radial_s4.json")),
    ]
    lines = ["| pdunet_radial arm | eval data | PSNR / SSIM |", "|---|---|---|"]
    for arm, ev, q in rows:
        lines.append(f"| {arm} | {ev} | {cell_str(q)} |")
    return "\n".join(lines)


def tables() -> dict:
    """Each README block this renderer owns → its body."""
    return dict(zip(BLOCKS, (sweep_table(), ood_table(), analysis_table(), noisy_table())))


def patch_readme(readme: pathlib.Path = REPO / "README.md") -> None:
    """Rewrite the port's generated blocks between their README markers."""
    text = readme.read_text()
    for name, body in tables().items():
        begin = f"<!-- BEGIN {name} table (generated) -->"
        end = f"<!-- END {name} table -->"
        i, j = text.index(begin), text.index(end)
        text = text[: i + len(begin)] + "\n" + body + "\n" + text[j:]
    readme.write_text(text)
    print(f"patched {readme}")


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--update-readme", action="store_true",
                   help="rewrite README.md's torch-* table blocks in place")
    args = p.parse_args(argv)
    print("## Quality vs acceleration (PSNR dB / SSIM, 64 held-out slices)\n")
    print(sweep_table())
    print("\n## Out-of-distribution evaluation (PSNR dB, 32 slices)\n")
    print(ood_table())
    print("\n## OOD analysis (model against the classical anchor)\n")
    print(analysis_table())
    print("\n## k-space noise robustness (radial MRI)\n")
    print(noisy_table())
    if args.update_readme:
        patch_readme()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
