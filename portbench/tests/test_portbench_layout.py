"""BENCHMARK.json against the shapes its format requires, every cell found
by name, and a cell, a configuration, a traffic kind, a reference geometry
and a model kind each added as files alone."""

import json
import re
import shutil

import pytest

from portbench import harness
from portbench.tests.tiny import SEED, cell as tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = harness.load_spec()


def test_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["portbench"] and 1 <= SPEC["run_seconds"] <= 51
    assert SPEC["command"] == ["python3", "portbench/run.py"]
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("portbench/")
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"]) and NAME.match(m["name"])
    assert len(json.dumps(SPEC)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_cell_resolves_to_its_files(cell):
    files = harness.cell_files(SPEC, cell)
    for key in ("config", "traffic", "kind", "counts", "limits"):
        assert files[key].is_file(), (cell, key)
    assert set(tiny(cell)) == {"config", "traffic", "read", "roots"}
    for trace in (False, True):
        for m in harness.cell_metrics(SPEC, cell, trace):
            assert (harness.HERE / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"] for m in harness.cell_metrics(SPEC, cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    moved = {m["moves"] for m in harness.cell_metrics(SPEC, cell, True)}
    assert moved and moved <= e2e


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_config_is_the_preset(name):
    """The file holds every field of the program's preset, unchanged."""
    import dataclasses

    from pdunet_tpu_torch.configs import get_preset

    cfg = json.loads((harness.ROOT / f"portbench/configs/{name}.json").read_text())
    preset = get_preset(cfg["preset"])
    for sec in ("geometry", "model", "train"):
        assert cfg[sec] == dataclasses.asdict(getattr(preset, sec))
    assert cfg["reduced"] == [] and cfg["source"]


def _copy(tmp_path):
    shutil.copytree(harness.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads(json.dumps(SPEC))


def _with_cell(spec, name, like):
    """``spec`` reporting every metric of the cell ``like`` in ``name`` too."""
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", []):
            m["workloads"].append(name)
    return spec


def test_a_cell_added_as_files_alone(tmp_path):
    """A new mix, cell and per-layer metric are a traffic file, a limits
    file, a reader and entries in BENCHMARK.json; the harness runs them
    without an edit."""
    spec = _copy(tmp_path)
    traffic = json.loads((harness.HERE / "traffic/volume_b256.json").read_text())
    traffic.update(batch=2, why="a mix added by a later change")
    (tmp_path / "portbench/traffic/volume_b2.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/limits/pdunet_parallel.small.json").write_text(
        (harness.HERE / "limits/pdunet_parallel.volume.json").read_text())
    spec["workloads"].append({"name": "pdunet_parallel.small", "config": "pdunet_parallel",
                              "traffic": "volume_b2", "chips": 1, "why": "added"})
    _with_cell(spec, "pdunet_parallel.small", "pdunet_parallel.volume")
    (tmp_path / "portbench/metrics/recon_requests.py").write_text(
        "def read(run):\n    return float(run.attempted)\n")
    spec["per_layer"].append({"name": "recon_requests", "unit": "requests", "better": "higher",
                              "source": "host_clock", "layer": "device",
                              "moves": "recon_slices_per_s",
                              "workloads": ["pdunet_parallel.small"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result = harness.run_cell("pdunet_parallel.small", SEED, 0.2, True, device="cpu",
                              config_overrides=tiny("pdunet_parallel.volume")["config"],
                              traffic_overrides={"pool": 2, "trace_requests": [1, 2]},
                              root=tmp_path)
    assert result["correct"] and result["metrics"]["recon_requests"]["value"] >= 2


#: a traffic kind a later change might add: the measurement synthesis and
#: direct reconstruction alone, checked against the reference's
SYNTH_KIND = '''
import pathlib, time
import torch
from portbench import modules

volume = modules.load(pathlib.Path(__file__).with_name("volume.py"), "traffic kind")


def loop(run, task, seed, seconds, trace):
    pool = volume.make_pool(run.cfg, run.traffic, seed, run.device)
    run.setup_end()
    t0, n, out = time.perf_counter(), 0, None
    while n == 0 or time.perf_counter() - t0 < seconds:
        with torch.inference_mode():
            out = task.batch_from_images(pool[n % len(pool)])
        n += 1
    run.elapsed, run.units, run.attempted = time.perf_counter() - t0, n * run.traffic["batch"], n
    return {"images": pool[(n - 1) % len(pool)], "sino": out["sino"], "f0": out["f0"]}


def compare(run, ref, prog, weights):
    sino, f0 = ref.synth(prog["images"])
    err = lambda a, r: float((a - r).abs().norm() / r.abs().norm())
    return {"sino_err": err(prog["sino"], sino), "f0_err": err(prog["f0"], f0)}


def controls(run, ref, prog, weights):
    return {}
'''


def test_a_configuration_and_a_kind_added_as_files_alone(tmp_path):
    """A new configuration (its file and frozen counts) and a new kind of
    traffic (its module, a mix of it, a limits file) are files and
    entries alone."""
    from portbench import counting

    spec = _copy(tmp_path)
    cfg = json.loads((harness.HERE / "configs/pdunet_parallel.json").read_text())
    cfg["geometry"]["sparsity"] = 2
    (tmp_path / "portbench/configs/pdunet_parallel_s2.json").write_text(json.dumps(cfg))
    (tmp_path / "portbench/counts/pdunet_parallel_s2.json").write_text(
        json.dumps(counting.counts(cfg)))
    spec["configs"].append({"name": "pdunet_parallel_s2", "source": "a later change",
                            "file": "portbench/configs/pdunet_parallel_s2.json",
                            "reduced": ["geometry"], "why": "added"})
    (tmp_path / "portbench/kinds/synth.py").write_text(SYNTH_KIND)
    (tmp_path / "portbench/traffic/synth_b4.json").write_text(
        json.dumps({"kind": "synth", "why": "added", "batch": 4, "pool": 2}))
    (tmp_path / "portbench/limits/pdunet_parallel_s2.synth.json").write_text(
        json.dumps({"sino_err": 1e-5, "f0_err": 1e-5}))
    spec["workloads"].append({"name": "pdunet_parallel_s2.synth", "config": "pdunet_parallel_s2",
                              "traffic": "synth_b4", "chips": 1, "why": "added"})
    for m in spec["end_to_end"]:
        if m["name"] == "recon_slices_per_s":
            m["workloads"].append("pdunet_parallel_s2.synth")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result = harness.run_cell("pdunet_parallel_s2.synth", SEED, 0.2, False, device="cpu",
                              config_overrides=tiny("pdunet_parallel.volume")["config"],
                              root=tmp_path)
    assert result["correct"] is True
    assert set(result["metrics"]) == {"recon_slices_per_s", "setup_s"}
    assert set(result["checks"]) == {"sino_err", "f0_err"}


def test_a_reference_geometry_found_by_name(tmp_path):
    """The reference's operators are the file named by the geometry's
    kind: a new geometry is a new file under reference/geometries/."""
    import torch

    from portbench.reference.tasks import RefTask

    _copy(tmp_path)
    src = harness.HERE / "reference/geometries/parallel.py"
    (tmp_path / "portbench/reference/geometries/parallel_copy.py").write_text(src.read_text())
    cfg = json.loads((harness.HERE / "configs/pdunet_parallel.json").read_text())
    cfg["geometry"].update(image_size=16, n_angles=24)
    img = torch.rand(2, 16, 16, generator=torch.Generator().manual_seed(3))
    want = RefTask(cfg, "cpu").synth(img)
    cfg["geometry"]["kind"] = "parallel_copy"
    got = RefTask(cfg, "cpu", root=tmp_path).synth(img)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    cfg["geometry"]["kind"] = "none_such"
    with pytest.raises(FileNotFoundError):
        RefTask(cfg, "cpu", root=tmp_path)


#: a model kind a later change might add: per iteration one 3x3 convolution
#: on [f, A†(A f − g)], real operators only
TOY_MODEL = '''
import torch
import torch.nn.functional as F


def shapes(cfg):
    return {f"iterations.{i}.net.{k}": s for i in range(cfg["model"]["n_iters"])
            for k, s in (("weight", (1, 2, 3, 3)), ("bias", (1,)))}


def unroll(m, P, g, f0, A, At, complex_ops, rnd):
    f = f0
    for i in range(m["n_iters"]):
        x = torch.stack([f, At(A(f) - g)], dim=1)
        w, b = P[f"iterations.{i}.net.weight"], P[f"iterations.{i}.net.bias"]
        f = f + F.conv2d(rnd(x), rnd(w), b, padding=1)[:, 0]
    return f
'''


def test_a_model_kind_added_as_files_alone(tmp_path):
    """A new model kind is one file, ``reference/models/<kind>.py``: the
    counts and the reference task find it by the configuration's
    ``model.kind``. Its count is the closed form: n convolutions of 2 → 1
    channels over N² pixels, 2·9·2·N² FLOP each, in the forward; in the
    backward every weight's gradient and every input's but the first
    iteration's, whose input needs none; 2n operator calls forward, and in
    the backward 2(n − 1), the first iteration's needing no vjp. A kind
    without a file names the path it looked for."""
    import torch

    from portbench import counting
    from portbench.reference.tasks import RefTask

    _copy(tmp_path)
    models = tmp_path / "portbench/reference/models"
    (models / "toy.py").write_text(TOY_MODEL)
    cfg = json.loads((harness.HERE / "configs/pdunet_parallel.json").read_text())
    cfg["geometry"].update(image_size=16, n_angles=24)
    cfg["model"].update(kind="toy", n_iters=3)
    n, N = 3, 16
    conv = 2 * 9 * 2 * N * N
    got = counting.counts(cfg, root=tmp_path)
    assert got["conv_flops_per_slice"] == {"recon": n * conv, "train": (3 * n - 1) * conv}
    assert got["applies_per_slice"] == {"recon": 2 + 2 * n, "train": 2 + 2 * n + 2 * (n - 1)}

    ref = RefTask(cfg, "cpu", root=tmp_path)
    P = {k: torch.full(s, 0.1) for k, s in ref.model_mod.shapes(cfg).items()}
    img = torch.rand(2, N, N, generator=torch.Generator().manual_seed(3))
    sino, f0 = ref.synth(img)
    assert ref.unroll(P, sino, f0, ref.sigma()).shape == (2, N, N)

    cfg["model"]["kind"] = "none_such"
    missing = str((models / "none_such.py").resolve())
    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        counting.counts(cfg, root=tmp_path)
    with pytest.raises(FileNotFoundError, match=re.escape(missing)):
        RefTask(cfg, "cpu", root=tmp_path)


@pytest.mark.parametrize("name", ["pdunet_parallel", "pdunet_radial"])
def test_pdunet_applies_are_counted(name):
    """Four PD-UNet iterations: A f and A† h in each, after the synthesis A
    and the direct reconstruction (2 + 8), and in training the vjp of each
    but the first iteration's A f₀ (+ 7)."""
    from portbench import counting

    cfg = json.loads((harness.HERE / "configs" / f"{name}.json").read_text())
    assert cfg["model"]["n_iters"] == 4
    assert counting.counts(cfg)["applies_per_slice"] == {"recon": 10, "train": 17}
