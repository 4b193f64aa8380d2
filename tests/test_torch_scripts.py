"""The port's scripts (pdunet_tpu_torch/scripts/{ood_eval,ood_analysis,
classical_baselines,acceleration_sweep,batch_frontier_ab,results_tables}.py)
against the reference scripts of ``scripts/`` and the JAX package, on the CPU.

* The OOD stores are the reference's draws bit for bit: at 32² for every
  family, real and complex, and the HU volume; and the first slices of each
  committed 256² store in ``artifacts/ood_analysis/``.
* ``cell_sets`` and the A/B arms are the reference's, so a cell or an arm of
  the port is the reference's.
* The classical anchor (FBP / DCF adjoint of the sparse measurement), its
  measurement residual and the windowed HU PSNR match the JAX package's
  ``build_eval_ops`` at 32² (≤ 1e-5 relative, PSNR ≤ 1e-4 dB), and at full
  width the committed yardstick ``ood_anchors_reference.json`` (the JAX
  package's per-slice anchors on the CPU over the committed stores, which
  ``chip_smoke.py`` holds the card's anchors to) to 1e-4 dB.
* ood_eval, ood_analysis, classical_baselines, acceleration_sweep and
  batch_frontier_ab run end to end at 32² on the CPU in a temporary root,
  and results_tables renders the reference's committed artifacts byte for
  byte as the reference renderer does.

Regenerate the yardstick (the JAX package on the CPU, about a minute):
``JAX_PLATFORMS=cpu python tests/test_torch_scripts.py``.
"""

import json
import pathlib
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import scripts.acceleration_sweep as ref_sweep
import scripts.batch_frontier_ab as ref_ab
import scripts.ood_analysis as ref_analysis
import scripts.ood_eval as ref_ood_eval
import scripts.results_tables as ref_tables
from pdunet_tpu.configs import get_preset as jax_get_preset
from pdunet_tpu.data.pipeline import MU_WATER as JAX_MU_WATER
from pdunet_tpu.data.pipeline import mu_to_hu as jax_mu_to_hu
from pdunet_tpu.data.pipeline import normalize_ct_window as jax_window
from pdunet_tpu.ops.metrics import psnr as jax_psnr
from pdunet_tpu.ops.metrics import ssim as jax_ssim
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.data.datasets import SliceDataset
from pdunet_tpu_torch.ops.metrics import psnr
from pdunet_tpu_torch.scripts import (
    acceleration_sweep,
    batch_frontier_ab,
    classical_baselines,
    ood_analysis,
    ood_eval,
    results_tables,
)
from pdunet_tpu_torch.training.checkpoint import CheckpointManager
from pdunet_tpu_torch.training.loop import build_state, derive_seed
from pdunet_tpu_torch.training.tasks import build_task

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = REPO / "artifacts" / "ood_analysis"
ANCHORS = REPO / "pdunet_tpu_torch" / "scripts" / "ood_anchors_reference.json"
PRESETS = ("pdunet_parallel", "fbp_unet_parallel", "sino_unet_parallel", "lpd_parallel",
           "pdunet_fan", "pdunet_radial", "sino_unet_radial")
OOD_KINDS = ("shepp_logan", "rectangles", "smooth", "textured")
#: the geometries of the anchor yardstick: preset → its kinds (HU is CT only)
ANCHOR_PAIRS = [(p, k) for p in ("pdunet_parallel", "pdunet_fan", "pdunet_radial")
                for k in OOD_KINDS + (("hu_volume",) if p != "pdunet_radial" else ())]
TINY = {"geometry.image_size": "32", "geometry.n_angles": "40"}
SMALL_NETS = ["model.base_features=8", "model.n_iters=2"]


def _store(path):
    """(slices, phase or None, splits, domain) of an npy store, as written."""
    root = pathlib.Path(path)
    ds = SliceDataset(str(root), split="test")
    ds.close()
    phase = root / "phase.npy"
    return (np.load(root / "slices.npy"), np.load(phase) if phase.exists() else None,
            tuple(json.loads((root / "attrs.json").read_text())["splits"]), ds.domain)


def _h5(path, n=None):
    with h5py.File(path, "r") as f:
        phase = f["phase"][:n] if "phase" in f else None
        return (f["slices"][:n], phase, tuple(int(c) for c in f.attrs["splits"]),
                str(f.attrs.get("domain", "density")))


# -- the stores --------------------------------------------------------------

@pytest.mark.parametrize("complex_phase", [False, True])
@pytest.mark.parametrize("kind", OOD_KINDS)
def test_ood_store_is_the_reference_draw(tmp_path, kind, complex_phase):
    ref_ood_eval.write_ood_h5(tmp_path / "ref.h5", kind, 4, 32, complex_phase)
    ood_eval.write_ood_store(tmp_path / "port", kind, 4, 32, complex_phase)
    ref, port = _h5(tmp_path / "ref.h5"), _store(tmp_path / "port")
    np.testing.assert_array_equal(port[0], ref[0])
    if complex_phase:
        np.testing.assert_array_equal(port[1], ref[1])
    else:
        assert port[1] is None and ref[1] is None
    assert port[2] == ref[2] == (0, 0, 4) and port[3] == ref[3] == "density"


def test_hu_volume_is_the_reference_volume(tmp_path):
    ref_ood_eval.write_hu_volume(tmp_path / "ref.h5", 4, 32)
    ood_eval.write_hu_volume(tmp_path / "port", 4, 32)
    ref, port = _h5(tmp_path / "ref.h5"), _store(tmp_path / "port")
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[1] is None and port[2] == ref[2] == (0, 0, 4)
    assert port[3] == ref[3] == "hu"


@pytest.mark.parametrize("name", sorted(p.name for p in COMMITTED.glob("ood_*_256*.h5")))
def test_committed_256_stores_are_reproduced(tmp_path, name):
    """The first 2 slices of each committed store (the draws are prefix-stable);
    the HU volume whole, since its scale comes from all of its slices."""
    kind = name[len("ood_"):].split("_256")[0]
    cplx = name.endswith("_cplx.h5")
    n = 32 if kind == "hu_volume" else 2
    ood_eval.ensure_store(tmp_path, kind, n, 256, cplx)
    ref, port = _h5(COMMITTED / name, n), _store(ood_eval.store_path(tmp_path, kind, 256, cplx))
    np.testing.assert_array_equal(port[0], ref[0])
    if cplx:
        np.testing.assert_array_equal(port[1], ref[1])


@pytest.mark.parametrize("preset,kind", [("pdunet_parallel", "shepp_logan"),
                                         ("pdunet_parallel", "hu_volume"),
                                         ("pdunet_radial", "shepp_logan")])
def test_load_slices_is_the_references(tmp_path, preset, kind):
    """The port reads its npy store as the reference reads its HDF5 one: the
    HU volume in relative attenuation (converted once), phases as stored."""
    (tmp_path / "ref").mkdir()
    ref = ref_analysis.load_slices(kind, jax_get_preset(preset).override(TINY), 4,
                                   tmp_path / "ref")
    port = ood_analysis.load_slices(kind, get_preset(preset).override(TINY), 4,
                                    tmp_path / "port")
    for r, p in zip(ref, port):
        if r is None:
            assert p is None
        else:
            assert p.dtype == np.float32
            np.testing.assert_array_equal(p, r)


# -- the sweep's cells and the A/B arms are the reference's --------------------

@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("batch", [4, 32])
@pytest.mark.parametrize("sparsity", [2, 4, 8])
@pytest.mark.parametrize("preset", PRESETS)
def test_cell_sets_are_the_references(preset, sparsity, batch, tiny):
    kw = dict(batch=batch, lr=1e-3, steps=96_000 // batch, tiny=tiny,
              extra=["train.kspace_snr_db=30"])
    assert (acceleration_sweep.cell_sets(preset, sparsity, **kw)
            == ref_sweep.cell_sets(preset, sparsity, **kw))


@pytest.mark.parametrize("tiny", [False, True])
def test_arms_are_the_references(tmp_path, monkeypatch, tiny):
    """What each main hands its train_and_eval: tag, overrides, steps and the
    tiny geometry, for every arm."""
    ref_calls, port_calls = [], []

    def capture(calls):
        def fake(preset, tag, sets, steps, n_slices, device_or_platform, extra_geo):
            calls.append((preset, tag, sets, steps, n_slices, extra_geo))
            return {"tag": tag}
        return fake

    (tmp_path / "ref" / "artifacts").mkdir(parents=True)
    monkeypatch.setattr(ref_ab, "REPO", tmp_path / "ref")
    monkeypatch.setattr(ref_ab, "train_and_eval", capture(ref_calls))
    monkeypatch.setattr(sys, "argv", ["batch_frontier_ab.py"] + (["--tiny"] if tiny else []))
    ref_ab.main()
    monkeypatch.setattr(batch_frontier_ab, "ROOT", tmp_path / "port")
    monkeypatch.setattr(batch_frontier_ab, "train_and_eval", capture(port_calls))
    batch_frontier_ab.main(["--tiny"] if tiny else [])
    assert port_calls == ref_calls and len(port_calls) == len(batch_frontier_ab.ARMS) == 7
    # both merge the arms of earlier invocations
    saved = json.loads((tmp_path / "port" / "artifacts" / "torch" / "batch_ab.json").read_text())
    assert [a["tag"] for a in saved["arms"]] == [c[1] for c in port_calls]


def test_median_step_sec_reads_the_train_rows(tmp_path):
    rows = [{"step": 100, "loss": 1.0, "wall_s": 10.0}, {"step": 100, "psnr": 30.0},
            {"step": 200, "loss": 0.9, "wall_s": 12.0}, {"step": 300, "loss": 0.8, "wall_s": 15.0},
            {"step": 400, "loss": 0.7, "wall_s": 17.5}]
    path = tmp_path / "m.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    assert batch_frontier_ab.median_step_sec(path) == 0.025  # of 0.02, 0.03, 0.025
    assert batch_frontier_ab.median_step_sec(tmp_path / "none.jsonl") is None


def test_unknown_arm_is_refused(tmp_path, monkeypatch):
    monkeypatch.setattr(batch_frontier_ab, "ROOT", tmp_path)
    with pytest.raises(SystemExit, match="unknown arms"):
        batch_frontier_ab.main(["--arms", "b4,b64"])


def test_sweep_run_retries_watchdog_exit_87_once(tmp_path):
    marker = tmp_path / "wedged_once"
    acceleration_sweep.run(
        ["sh", "-c", f"if [ -f {marker} ]; then exit 0; else touch {marker}; exit 87; fi"])
    assert marker.exists()
    with pytest.raises(subprocess.CalledProcessError) as e:
        acceleration_sweep.run(["sh", "-c", "exit 87"])
    assert e.value.returncode == 87


def test_sweep_table_only_rebuilds_from_every_cell(tmp_path, monkeypatch):
    monkeypatch.setattr(acceleration_sweep, "ROOT", tmp_path)
    sweep = tmp_path / "artifacts" / "torch" / "sweep"
    sweep.mkdir(parents=True)
    for preset, k in (("pdunet_parallel", 4), ("pdunet_radial", 8), ("lpd_parallel", 4)):
        (sweep / f"{preset}_s{k}.json").write_text(json.dumps(
            {"preset": preset, "sparsity": k, "psnr_mean": 40.0, "ssim_mean": 0.99}))
    acceleration_sweep.main(["--table-only", "--presets", "pdunet_radial", "--sparsities", "8"])
    table = json.loads((tmp_path / "artifacts" / "torch" / "acceleration_sweep.json").read_text())
    assert {(c["preset"], c["sparsity"]) for c in table["cells"]} == {
        ("pdunet_parallel", 4), ("pdunet_radial", 8), ("lpd_parallel", 4)}


# -- the anchors against the JAX package ---------------------------------------

def _jax_anchor(ops, mag, phase, hu):
    """The reference's anchor metrics (scripts/ood_analysis.py): per slice the
    anchor PSNR (windowed for HU) and, for CT, the anchor's resid_rel against
    the sparse measurement of the ground truth."""
    if phase is not None:
        img = jax.lax.complex(jnp.asarray(mag * np.cos(phase)), jnp.asarray(mag * np.sin(phase)))
    else:
        img = jnp.asarray(mag)
    gt = jnp.abs(img) if phase is not None else img
    anchor = ops.fbp(ops.A(img))
    anchor = jnp.abs(anchor) if phase is not None else anchor
    if hu:
        def win(x):
            return jax_window(jax_mu_to_hu(x * JAX_MU_WATER), 40.0, 400.0)

        ps = jax_psnr(win(anchor), win(gt), data_range=1.0)
    else:
        ps = jax_psnr(anchor, gt)
    resid = None
    if phase is None:
        y = ops.A(gt)
        resid = np.asarray(jnp.sqrt(jnp.sum((ops.A(anchor) - y) ** 2, axis=(-2, -1)))
                           / jnp.sqrt(jnp.sum(y ** 2, axis=(-2, -1))))
    return np.asarray(anchor), np.asarray(ps), resid


def _port_anchor(ops, mag, phase, hu):
    img = (ood_analysis.complex_images(mag, phase, "cpu") if phase is not None
           else torch.as_tensor(mag))
    gt = img.abs() if phase is not None else img
    with torch.inference_mode():
        anchor = ood_analysis.classical(ops, img)
        ps = ood_analysis.psnr_windowed(anchor, gt) if hu else psnr(anchor, gt)
        resid = None if phase is not None else ood_analysis.resid_rel(ops, anchor, ops.A(gt))
    return anchor.numpy(), ps.numpy(), None if resid is None else resid.numpy()


def _committed_slices(preset, kind, lo, hi):
    """(magnitudes, phases or None) of slices [lo, hi) of a committed store,
    the HU volume converted to relative attenuation as the reference does."""
    cplx = preset == "pdunet_radial"
    with h5py.File(COMMITTED / f"ood_{kind}_256{'_cplx' if cplx else ''}.h5", "r") as f:
        mag = np.asarray(f["slices"][lo:hi], np.float32)
        phase = np.asarray(f["phase"][lo:hi], np.float32) if cplx else None
        if f.attrs.get("domain", "mu") == "hu":
            mag = 1.0 + mag / 1000.0
    return mag, phase


@pytest.mark.parametrize("preset,hu", [("pdunet_parallel", False), ("pdunet_parallel", True),
                                       ("pdunet_fan", False), ("pdunet_fan", True),
                                       ("pdunet_radial", False)])
def test_anchor_matches_jax_build_eval_ops(preset, hu):
    """At 32²: the anchor image ≤ 1e-5 relative, its PSNR ≤ 1e-4 dB (raw, or
    windowed on a HU-like input; HU is CT only) and resid_rel ≤ 1e-5 relative."""
    over = dict(TINY, **({"geometry.samples_per_spoke": "48"} if preset == "pdunet_radial"
                         else {}))
    jops = ref_analysis.build_eval_ops(jax_get_preset(preset).override(over))
    tops = ood_analysis.build_eval_ops(get_preset(preset).override(over), "cpu")
    rng = np.random.default_rng(5)
    mag = (rng.uniform(0.0, 1.0, (3, 32, 32)) * (rng.uniform(size=(3, 32, 32)) > 0.3)
           ).astype(np.float32)
    if hu:  # relative attenuation of air and soft tissue: the window sees it
        mag = np.where(mag > 0, 0.8 + 0.4 * mag, 0.0).astype(np.float32)
    phase = (rng.uniform(-np.pi, np.pi, (3, 32, 32)).astype(np.float32)
             if preset == "pdunet_radial" else None)
    ja, jp, jr = _jax_anchor(jops, mag, phase, hu)
    ta, tp, tr = _port_anchor(tops, mag, phase, hu)
    assert np.linalg.norm(ta - ja) <= 1e-5 * np.linalg.norm(ja)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-4)
    if phase is None:
        np.testing.assert_allclose(tr, jr, rtol=1e-5)
    else:
        assert tr is None and jr is None


@pytest.fixture(scope="module")
def anchor_reference():
    return json.loads(ANCHORS.read_text())


@pytest.fixture(scope="module")
def full_width_ops():
    """Each preset's 256² sparse f32 operators, JAX's and the port's (CPU)."""
    cache = {}

    def get(preset):
        if preset not in cache:
            over = {"geometry.sparsity": "4"}
            cache[preset] = (
                ref_analysis.build_eval_ops(jax_get_preset(preset).override(over)),
                ood_analysis.build_eval_ops(get_preset(preset).override(over), "cpu"))
        return cache[preset]
    return get


@pytest.mark.parametrize("preset,kind", ANCHOR_PAIRS)
def test_full_width_anchors_match_the_yardstick(anchor_reference, full_width_ops, preset,
                                                kind):
    """Slices 0-1 of each committed store: the JAX package on the CPU and the
    port's plain versions both reproduce the committed per-slice anchors."""
    ref = anchor_reference["pairs"][f"{preset}/{kind}"]
    assert len(ref["anchor_psnr"]) == anchor_reference["n_slices"] == 32
    mag, phase = _committed_slices(preset, kind, 0, 2)
    jops, tops = full_width_ops(preset)
    hu = kind == "hu_volume"
    for name, (_, ps, resid) in (("jax", _jax_anchor(jops, mag, phase, hu)),
                                 ("port", _port_anchor(tops, mag, phase, hu))):
        np.testing.assert_allclose(ps, ref["anchor_psnr"][:2], rtol=0, atol=1e-4,
                                   err_msg=f"{name} anchor PSNR")
        if phase is None:
            np.testing.assert_allclose(resid, ref["resid_rel_anchor"][:2], rtol=1e-5,
                                       err_msg=f"{name} anchor resid_rel")
        else:
            assert "resid_rel_anchor" not in ref


def write_anchor_reference(path=ANCHORS, n=32, batch=8):
    """The yardstick: the JAX package's per-slice anchors on the CPU over the
    first ``n`` slices of each committed 256² store, for every (geometry,
    kind) pair, in batches of ``batch`` as the reference script runs them."""
    pairs = {}
    for preset, kind in ANCHOR_PAIRS:
        ops = ref_analysis.build_eval_ops(
            jax_get_preset(preset).override({"geometry.sparsity": "4"}))
        rows = {"anchor_psnr": [], "resid_rel_anchor": []}
        for lo in range(0, n, batch):
            mag, phase = _committed_slices(preset, kind, lo, lo + batch)
            _, ps, resid = _jax_anchor(ops, mag, phase, kind == "hu_volume")
            rows["anchor_psnr"] += [float(v) for v in ps]
            if resid is not None:
                rows["resid_rel_anchor"] += [float(v) for v in resid]
        if not rows["resid_rel_anchor"]:
            del rows["resid_rel_anchor"]
        pairs[f"{preset}/{kind}"] = rows
        print(f"{preset}/{kind}: anchor {np.mean(rows['anchor_psnr']):.4f} dB", flush=True)
    path.write_text(json.dumps({
        "what": "per-slice classical anchor PSNR (dB; hu_volume in the C40/W400 window) and, "
                "for CT, the anchor's resid_rel, computed by the JAX package on the CPU "
                "(scripts/ood_analysis.build_eval_ops, float32) over the committed stores "
                "artifacts/ood_analysis/ood_<kind>_256[_cplx].h5 at sparsity 4",
        "written_by": "tests/test_torch_scripts.py:write_anchor_reference",
        "jax": jax.__version__, "n_slices": n, "pairs": pairs}, indent=1) + "\n")


# -- the classical scoring -------------------------------------------------------

@pytest.mark.parametrize("is_complex", [False, True])
def test_classical_score_matches_jax(is_complex):
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 1, (3, 32, 32)).astype(np.float32)
    f0 = (img + 0.05 * rng.normal(size=img.shape)).astype(np.float32)
    if is_complex:
        ph = rng.uniform(-np.pi, np.pi, img.shape)
        img, f0 = (img * np.exp(1j * ph)).astype(np.complex64), (
            f0 * np.exp(1j * (ph + 0.1))).astype(np.complex64)
    ps, ss = classical_baselines.score({"f0": torch.as_tensor(f0),
                                        "image": torch.as_tensor(img)})
    jf0, jimg = (jnp.abs(jnp.asarray(f0)), jnp.abs(jnp.asarray(img))) if is_complex else (
        jnp.asarray(f0), jnp.asarray(img))
    np.testing.assert_allclose(ps.numpy(), np.asarray(jax_psnr(jf0, jimg)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(ss.numpy(), np.asarray(jax_ssim(jf0, jimg)), rtol=0, atol=1e-5)


def test_classical_baselines_end_to_end(tmp_path, monkeypatch):
    """Three geometries at 32²; each batch is drawn from derive_seed(seed, b)."""
    monkeypatch.setattr(classical_baselines, "ROOT", tmp_path)
    classical_baselines.main(["--tiny", "--device", "cpu", "--n-slices", "8",
                              "--sparsities", "4"])
    rows = json.loads((tmp_path / "artifacts" / "torch" / "classical_baselines.json")
                      .read_text())["cells"]
    assert [(r["preset"], r["method"]) for r in rows] == [
        ("pdunet_parallel", "fbp"), ("pdunet_fan", "fbp"), ("pdunet_radial", "dcf_adjoint")]
    task = build_task(get_preset("pdunet_parallel").override(
        {**TINY, "geometry.sparsity": 4, "train.batch_size": 8}), device="cpu")
    with torch.inference_mode():
        ps, ss = classical_baselines.score(task.make_batch(
            torch.Generator().manual_seed(derive_seed(1234, 0))))
    assert rows[0]["n_slices"] == 8 and rows[0]["psnr_mean"] == round(float(ps.mean()), 3)
    assert rows[0]["ssim_mean"] == round(float(ss.mean()), 4)


# -- end to end at 32² ------------------------------------------------------------

def _tiny_ckpt(root, preset):
    """A best/ slot of random tiny weights where ood_analysis looks for it."""
    config = get_preset(preset).override(
        {**TINY, "model.base_features": "8", "model.n_iters": "2", "train.batch_size": "2",
         **({"geometry.samples_per_spoke": "48"} if preset.endswith("radial") else {})})
    task = build_task(config, device="cpu")
    CheckpointManager(str(root / "runs" / "torch" / "sweep" / f"{preset}_s4" / "best"),
                      max_to_keep=1).save(0, build_state(task), config=config, force=True)


def test_ood_analysis_end_to_end(tmp_path, monkeypatch, capsys):
    from pdunet_tpu_torch.utils.png import read_gray_png

    monkeypatch.setattr(ood_analysis, "ROOT", tmp_path)
    for preset in ("pdunet_parallel", "pdunet_radial"):
        _tiny_ckpt(tmp_path, preset)
    ood_analysis.main(["--presets", "pdunet_parallel,pdunet_radial,pdunet_fan",
                       "--kinds", "indist,shepp_logan,hu_volume", "--tiny", "--device", "cpu",
                       "--n-slices", "4", "--batch", "2", "--amplitudes", "0.5,1.0",
                       "--set", SMALL_NETS[0], "--set", SMALL_NETS[1]])
    assert "[skip] pdunet_fan: no checkpoint" in capsys.readouterr().out
    out = tmp_path / "artifacts" / "torch" / "ood_analysis"
    cells = {f.stem: json.loads(f.read_text()) for f in out.glob("*.json")}
    assert sorted(cells) == ["pdunet_parallel_hu_volume", "pdunet_parallel_indist",
                             "pdunet_parallel_shepp_logan", "pdunet_radial_indist",
                             "pdunet_radial_shepp_logan"]
    for c in cells.values():
        assert c["n_slices"] == 4 and np.isfinite(c["psnr_mean"])
        assert set(c["amplitude_psnr"]) == {"0.5", "1.0"}
        assert ("resid_rel_model" in c) == (c["preset"] == "pdunet_parallel")
        for png in c["worst_png"]:
            assert read_gray_png(out / png).shape == (32, 96)
    assert "psnr_raw_mean" in cells["pdunet_parallel_hu_volume"]
    # the cell's anchor is the anchor of the store's slices
    config = get_preset("pdunet_parallel").override(TINY)
    mag, _ = ood_analysis.load_slices("shepp_logan", config, 4, out)
    _, ps, resid = _port_anchor(ood_analysis.build_eval_ops(config, "cpu"), mag, None, False)
    cell = cells["pdunet_parallel_shepp_logan"]
    assert cell["anchor_psnr_mean"] == round(float(np.mean(ps)), 3)
    assert cell["resid_rel_anchor"] == round(float(np.mean(resid)), 5)


def test_sweep_then_ood_eval_end_to_end(tmp_path, monkeypatch):
    """A 2-step cell through the port's train and infer children, then
    ood_eval on its best checkpoint (a windowed HU cell among them)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(acceleration_sweep, "ROOT", tmp_path)
    monkeypatch.setattr(ood_eval, "ROOT", tmp_path)
    acceleration_sweep.main(["--presets", "pdunet_parallel", "--sparsities", "4", "--batch",
                             "2", "--samples", "4", "--tiny", "--device", "cpu",
                             "--n-slices", "4", *[a for s in SMALL_NETS
                                                  for a in ("--extra-set", s)]])
    art = tmp_path / "artifacts" / "torch"
    table = json.loads((art / "acceleration_sweep.json").read_text())
    (cell,) = table["cells"]
    assert (cell["preset"], cell["sparsity"], cell["steps"], cell["batch"]) == (
        "pdunet_parallel", 4, 2, 2)
    assert cell["device"] == "cpu" and cell["ckpt_step"] == 2 and cell["n_slices"] == 4
    assert (tmp_path / "runs" / "torch" / "sweep" / "pdunet_parallel_s4" / "best").is_dir()
    sets = [*(f"{k}={v}" for k, v in TINY.items()), *SMALL_NETS]
    ood_eval.main(["--presets", "pdunet_parallel,pdunet_radial", "--kinds",
                   "shepp_logan,hu_volume", "--n-slices", "2", "--device", "cpu",
                   *[a for kv in sets for a in ("--set", kv)]])
    rows = json.loads((art / "ood_eval.json").read_text())["cells"]
    assert [(r["preset"], r["kind"], r["n_slices"]) for r in rows] == [
        ("pdunet_parallel", "shepp_logan", 2), ("pdunet_parallel", "hu_volume", 2)]
    assert all(np.isfinite(r["psnr_mean"]) and r["device"] == "cpu" for r in rows)
    assert (art / "ood" / "ood_hu_volume_32" / "slices.npy").exists()


def test_batch_frontier_ab_end_to_end(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setattr(batch_frontier_ab, "ROOT", tmp_path)
    batch_frontier_ab.main(["--tiny", "--device", "cpu", "--samples", "8", "--arms", "b4",
                            "--n-slices", "4"])
    batch_frontier_ab.main(["--tiny", "--device", "cpu", "--samples", "64", "--arms",
                            "b32_base", "--n-slices", "4"])
    saved = json.loads((tmp_path / "artifacts" / "torch" / "batch_ab.json").read_text())
    arms = {a["tag"]: a for a in saved["arms"]}
    assert list(arms) == ["pdunet_parallel_b4", "pdunet_parallel_b32_base"]  # merged
    assert arms["pdunet_parallel_b4"]["steps"] == 2
    assert arms["pdunet_parallel_b32_base"]["steps"] == 2
    assert all(np.isfinite(a["psnr"]) and np.isfinite(a["ssim"]) for a in arms.values())


# -- the tables ---------------------------------------------------------------------

def test_renders_the_references_committed_artifacts_byte_for_byte(monkeypatch):
    monkeypatch.setattr(results_tables, "ART", REPO / "artifacts")
    assert results_tables.sweep_table() == ref_tables.sweep_table()
    assert results_tables.ood_table() == ref_tables.ood_table()
    assert results_tables.analysis_table() == ref_tables.analysis_table()
    assert results_tables.noisy_table() == ref_tables.noisy_table()


def test_readme_torch_blocks_are_fresh():
    text = (REPO / "README.md").read_text()
    for name, body in results_tables.tables().items():
        begin, end = f"<!-- BEGIN {name} table (generated) -->", f"<!-- END {name} table -->"
        i, j = text.index(begin), text.index(end)
        assert text[i + len(begin):j].strip("\n") == body, (
            f"README {name} table is stale: run python -m "
            f"pdunet_tpu_torch.scripts.results_tables --update-readme")


def test_patch_readme_rewrites_only_the_torch_blocks(tmp_path):
    blocks = ["sweep", "ood", "oodanalysis", "noise", *results_tables.BLOCKS]
    readme = tmp_path / "README.md"
    readme.write_text("prose\n" + "".join(
        f"<!-- BEGIN {b} table (generated) -->\nOLD {b}\n<!-- END {b} table -->\nmid\n"
        for b in blocks))
    results_tables.patch_readme(readme)
    text = readme.read_text()
    for b in ("sweep", "ood", "oodanalysis", "noise"):
        assert f"OLD {b}\n" in text
    assert "OLD torch" not in text and text.startswith("prose\n")
    results_tables.patch_readme(readme)
    assert readme.read_text() == text


def test_scripts_import_no_jax():
    """Each script module, imported alone, pulls in neither jax nor pdunet_tpu."""
    names = ["ood_eval", "ood_analysis", "classical_baselines", "acceleration_sweep",
             "batch_frontier_ab", "results_tables"]
    code = ("import sys\n" + "".join(f"import pdunet_tpu_torch.scripts.{n}\n" for n in names)
            + "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'pdunet_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)


if __name__ == "__main__":
    write_anchor_reference()
