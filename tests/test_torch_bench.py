"""The port's benchmark entry point (pdunet_tpu_torch/bench.py) on the CPU at
a tiny size. The numbers mean nothing here; the plumbing is under test:
the timer, the row schemas, the headline line, the FLOP model against the
JAX harness's formula, and the refusals of what is not ported yet."""

import json
import math

import jax.numpy as jnp
import pytest
import torch

from pdunet_tpu.geometry import GOLDEN_ANGLE
from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.geometry import build_parallel_plan as jax_plan
from pdunet_tpu_torch import bench
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan

torch.set_num_threads(1)

_TINY = ["--device", "cpu", "--batch", "2", "--image-size", "32", "--n-iters", "2"]


def test_timeit_measures_and_threads_aux():
    dt = bench.timeit(lambda x, a: x * a, torch.ones(4, 4), iters=2,
                      aux=(torch.full((4, 4), 2.0),))
    assert dt > 0
    # a function that needs its aux argument fails loudly without it
    with pytest.raises(TypeError):
        bench.timeit(lambda x, a: x * a, torch.ones(4, 4), iters=2)


@pytest.mark.parametrize("preset", ["pdunet_parallel", "pdunet_radial"])
def test_preset_recon_rows(preset):
    row = bench.bench_preset_recon(preset, 2, image_size=32, n_angles=96, device="cpu")
    assert row["preset"] == preset and row["batch"] == 2 and row["device"] == "cpu"
    assert row["recon_slices_per_sec"] > 0 and row["sec_per_slice"] > 0
    assert row["image_size"] == 32 and row["n_angles"] == 96
    assert row["mpixels_per_sec"] >= 0
    # no quality keys: the JAX harness's come from TPU-trained checkpoints
    assert not {"test_psnr", "test_ssim", "quality_artifact"} & set(row)


def test_headline_line_on_cpu(capsys):
    assert bench.main(_TINY) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[0])
    assert line["metric"] == "pdunet_256_sparse_ct_recon_throughput"
    assert line["unit"] == "slices/sec/chip" and line["value"] > 0
    assert "vs_baseline" not in line and line["device"] == "cpu"


def test_all_rows_on_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    assert bench.main(_TINY + ["--all"]) == 0
    details = json.loads((tmp_path / "bench_details.json").read_text())
    for key in ("radon_fwd_slices_per_sec", "radon_adj_slices_per_sec", "fbp_slices_per_sec"):
        assert details[key] > 0
    roof = details["roofline"]
    assert roof["conv_flops_per_batch"] > 0 and roof["projector_tflops_per_slice_analytic"] > 0
    assert not any(k.startswith("mxu") for k in roof)
    # a CPU run states no utilisation of the card's peak
    assert roof["conv_util_vs_bf16_peak"] is None and roof["device_kind"] == "cpu"
    # the train rows at min(batch, 32), with the step's split into phases
    assert details["config"]["train_batch"] == 2
    assert details["train_step_sec"] > 0 and details["train_slices_per_sec"] > 0
    split = details["train_split"]
    assert {"synthesis_sec", "forward_sec", "backward_sec", "optimizer_sec"} <= set(split)
    assert all(split[k] > 0 for k in ("forward_sec", "backward_sec", "optimizer_sec"))
    assert details["train_peak_mem_gib"] is None and "train_scan" not in details


def test_cli_defaults_are_the_jax_harness_defaults_on_the_card():
    args = bench.parse_args([])
    assert (args.batch, args.n_iters, args.image_size, args.device) == (256, 4, 256, "cuda")


def _jax_formula(plan):
    """bench.py's analytic per-apply projector FLOPs on a JAX plan."""
    m = plan.meta
    A_tot, N_, K_ = (m["A_x"] + m["A_y"]), m["N"], plan.spec.shape[0]
    S_ = plan.Wc.shape[1]
    if m.get("use_pairs"):
        units1 = m["P_x"] + m["P_y"]
        rows23 = 2 * units1
    else:
        units1, rows23 = A_tot, A_tot
    return 2 * (2 * units1 * N_ * N_ * K_ + 4 * rows23 * N_ * K_ + 2 * rows23 * K_ * S_)


@pytest.mark.parametrize("kw", [
    dict(image_size=256, n_angles=360, subsample=4),
    dict(image_size=32, n_angles=21, subsample=1),
    dict(image_size=32, angles=tuple((k * GOLDEN_ANGLE) % math.pi for k in range(16)),
         subsample=1),
], ids=["flagship", "unpaired-leftover", "golden"])
def test_projector_flops_match_jax_formula(kw):
    kw = dict(kw)
    sub = kw.pop("subsample")
    jp = jax_plan(JaxGeometry(**kw).subsample(sub), dtype=jnp.float32)
    tp = build_parallel_plan(ParallelGeometry(**kw).subsample(sub), device="cpu")
    got = bench.projector_flops_per_apply(tp.meta, tp.spec.shape[0], tp.Wc.shape[1])
    assert got == _jax_formula(jp) > 0


def test_unported_presets_and_flags_raise():
    """Every preset has a matrix batch now; an odd spoke length falls back
    to the gridding NUFFT with a warning (item 14 is ported). Training's
    TensorBoard and angle-sharded operators, which raised here until they
    were ported, are tested in test_torch_tb.py and test_torch_sharding.py."""
    from pdunet_tpu_torch.configs.presets import PRESETS
    from pdunet_tpu_torch.geometry import RadialGeometry
    from pdunet_tpu_torch.ops.nufft import make_radial_ops

    assert set(bench.MATRIX_BATCH) == set(PRESETS)
    with pytest.warns(UserWarning, match="even samples_per_spoke"):
        ops = make_radial_ops(RadialGeometry(image_size=32, n_spokes=8, samples_per_spoke=63),
                              device="cpu")
    assert ops.sino_shape == (8, 63)


def test_unet_scan_on_cpu(tmp_path, monkeypatch, capsys):
    """--unet-scan at a tiny size: the four stem x upsample variants and the
    stem-2 parts, written to unet_scan.json in the working directory."""
    monkeypatch.chdir(tmp_path)
    assert bench.main(["--unet-scan", "--device", "cpu", "--batch", "1",
                       "--image-size", "16"]) == 0
    scan = json.loads((tmp_path / "unet_scan.json").read_text())
    assert json.loads(capsys.readouterr().out) == scan
    assert (scan["batch"], scan["image_size"], scan["base_features"], scan["depth"]) == (
        1, 16, 64, 3)
    assert [(v["stem"], v["upsample"]) for v in scan["variants"]] == [
        (1, "convtranspose"), (1, "shuffle"), (2, "convtranspose"), (2, "shuffle")]
    assert all(v["ms_per_batch"] > 0 for v in scan["variants"])
    parts = {p["part"]: p for p in scan["parts"]}
    assert list(parts) == ["enc0", "enc1", "enc2", "bottleneck",
                           "up2_convtranspose", "up2_shuffle", "dec2",
                           "up1_convtranspose", "up1_shuffle", "dec1",
                           "up0_convtranspose", "up0_shuffle", "dec0", "head_1x1"]
    # stem-2 level features 128, 256, 512, 512 (capped); NCHW shapes
    assert parts["enc0"]["shape"] == [1, 4, 8, 8] and parts["enc0"]["features"] == 128
    assert parts["bottleneck"]["shape"] == [1, 512, 1, 1]
    assert parts["up0_shuffle"]["shape"] == [1, 256, 4, 4]
    assert parts["head_1x1"]["shape"] == [1, 128, 8, 8]
    assert all(p["ms_per_batch"] > 0 for p in scan["parts"])
    assert not (tmp_path / "artifacts").exists()


@pytest.mark.parametrize("preset,carry", [("fbp_unet_parallel", "fbp"),
                                          ("sino_unet_parallel", "sino_in"),
                                          ("lpd_parallel", "f0")])
def test_slice_b_preset_recon_rows(preset, carry):
    """The three slice B presets bench through their carry (the JAX
    harness's _CARRY_KEY) at their matrix batches (as in JAX)."""
    assert bench._CARRY_KEY[get_preset(preset).model.kind] == carry
    assert bench.MATRIX_BATCH[preset] == {"fbp_unet_parallel": 256, "sino_unet_parallel": 128,
                                          "lpd_parallel": 256}[preset]
    row = bench.bench_preset_recon(preset, 1, image_size=32, n_angles=40, device="cpu")
    assert row["preset"] == preset and row["recon_slices_per_sec"] > 0


_TRAIN_SMALL = {"geometry.image_size": 32, "geometry.n_angles": 96,
                "model.base_features": 8, "model.n_iters": 2}


def test_train_scan_ladder_on_cpu():
    """The ladder: the train batch without remat, then 2x, 4x, 8x with it."""
    from pdunet_tpu_torch.configs import get_preset

    rows = bench.train_scan(get_preset("pdunet_parallel").override(_TRAIN_SMALL), 1,
                            device="cpu")
    assert [(r["batch"], r["remat"]) for r in rows] == [(1, False), (2, True), (4, True),
                                                         (8, True)]
    assert all(r["step_sec"] > 0 and r["slices_per_sec"] > 0 for r in rows)


def test_train_scan_stops_at_oom_and_raises_on_other_failures(monkeypatch):
    """Running out of card memory ends the ladder with an error row (as the
    JAX harness); any other failure propagates."""
    from pdunet_tpu_torch.configs import get_preset

    config = get_preset("pdunet_parallel").override(_TRAIN_SMALL)

    def oom_at_4(config, b, remat=False, device="cuda"):
        if b >= 4:
            raise torch.cuda.OutOfMemoryError("out of memory")
        return {"batch": b, "remat": remat, "step_sec": 1.0}

    monkeypatch.setattr(bench, "bench_train", oom_at_4)
    rows = bench.train_scan(config, 1, device="cpu")
    assert [r["batch"] for r in rows] == [1, 2, 4]
    assert rows[-1] == {"batch": 4, "remat": True, "error": "OutOfMemoryError"}

    def broken(config, b, remat=False, device="cuda"):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(bench, "bench_train", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        bench.train_scan(config, 1, device="cpu")
    with pytest.raises(RuntimeError, match="kernel failed"):
        bench.main(_TINY + ["--all"])
