"""The port's checkpoints, train loop and CLIs on the CPU
(pdunet_tpu_torch/training/{checkpoint,loop}.py, train.py, infer.py):
keep-N and the save interval as orbax's default policy, the best slot and
best.json, a crashed run resumed to the bitwise-same parameters, the
refusals, and train → infer through a checkpoint. Small shapes: 32², 24
angles, base 8, depth 2, stem 2, 2 iterations, batch 2."""

import json
import os

import pytest
import torch

from pdunet_tpu_torch import infer
from pdunet_tpu_torch import train as train_cli
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.training import loop
from pdunet_tpu_torch.training.checkpoint import CheckpointManager
from pdunet_tpu_torch.training.tasks import build_task

torch.set_num_threads(1)

SMALL = {"geometry.image_size": 32, "geometry.n_angles": 96, "model.base_features": 8,
         "model.depth": 2, "model.stem": 2, "model.n_iters": 2, "train.batch_size": 2,
         "train.val_slices": 4, "train.warmup_steps": 3, "train.log_every": 5}
SMALL_FLAGS = [arg for k, v in SMALL.items() for arg in ("--set", f"{k}={v}")]
#: infer takes the geometry and model of the run (its batch is --batch)
INFER_FLAGS = [arg for k, v in SMALL.items() if not k.startswith("train.")
               for arg in ("--set", f"{k}={v}")]


def _config(preset="pdunet_parallel", **over):
    return get_preset(preset).override({**SMALL, **over})


def _state(**over):
    task = build_task(_config(**over), device="cpu")
    return loop.build_state(task, init_seed=0)


def test_keep_n_and_save_interval(tmp_path):
    """orbax's default policy: the first step always (no checkpoint yet),
    then multiples of the interval past the latest; the newest N stay;
    force writes off the interval; writes are whole files."""
    state = _state()
    mgr = CheckpointManager(tmp_path / "ck", max_to_keep=2, save_interval_steps=5)
    saved = [s for s in range(1, 13) if mgr.save(s, state)]
    assert saved == [1, 5, 10]
    assert mgr.all_steps() == [5, 10] and mgr.latest_step() == 10
    assert not mgr.save(10, state) and not mgr.save(7, state)  # not past the latest
    assert mgr.save(12, state, force=True)
    assert mgr.all_steps() == [10, 12]
    assert sorted(os.listdir(tmp_path / "ck")) == ["10.pt", "12.pt"]  # no temporaries


def test_restore_round_trips_and_refuses_a_mismatch(tmp_path):
    state = _state()
    state.step = 7
    mgr = CheckpointManager(tmp_path)
    assert mgr.restore(state) is None                      # nothing saved yet
    mgr.save(7, state, config=_config())
    fresh = _state()
    torch.manual_seed(1)
    for p in fresh.model.parameters():
        torch.nn.init.normal_(p)
    assert mgr.restore(fresh).step == 7
    assert all(torch.equal(a, b) for a, b in zip(fresh.model.parameters(),
                                                  state.model.parameters()))
    with pytest.raises(FileNotFoundError):
        mgr.restore(fresh, step=3)
    # another width: the saved tree does not match the model
    with pytest.raises(ValueError, match="does not match the model"):
        mgr.restore(_state(**{"model.base_features": 4}))
    # another unroll length: missing keys
    with pytest.raises(ValueError, match="missing"):
        mgr.restore(_state(**{"model.n_iters": 3}))


def test_checkpoint_restores_under_the_other_remat_setting(tmp_path):
    """Parameter names do not depend on remat (the reference needs
    _flip_remat_names for flax's renamed scan modules)."""
    state = _state()
    CheckpointManager(tmp_path).save(1, state)
    other = _state(**{"model.remat": True})
    assert other.model.remat
    assert CheckpointManager(tmp_path).restore(other).step == 0
    assert all(torch.equal(a, b) for a, b in zip(other.model.parameters(),
                                                  state.model.parameters()))


def test_best_slot_and_best_json(tmp_path):
    config = _config(**{"train.ckpt_dir": str(tmp_path), "train.eval_every": 2,
                        "train.ckpt_every": 3, "train.max_checkpoints": 2})
    metrics = tmp_path / "m.jsonl"
    result = loop.train(config, steps=6, metrics_path=str(metrics), verbose=False,
                        device="cpu")
    lines = [json.loads(x) for x in metrics.read_text().splitlines()]
    evals = [x for x in lines if "psnr" in x]
    logs = [x for x in lines if "loss" in x]
    assert [x["step"] for x in evals] == [2, 4, 6]
    assert [x["step"] for x in logs] == [5, 6]
    assert all(set(x) == {"loss", "grad_norm", "step", "wall_s"} for x in logs)
    best = max(evals, key=lambda x: x["psnr"])
    assert json.loads((tmp_path / "best.json").read_text()) == {"step": best["step"],
                                                                "psnr": best["psnr"]}
    assert CheckpointManager(tmp_path / "best").all_steps() == [best["step"]]
    assert CheckpointManager(tmp_path).all_steps() == [3, 6]
    assert result.final_eval["psnr"] == pytest.approx(evals[-1]["psnr"])
    assert result.state.step == 6 and len(result.history) == 2


def test_resumed_run_is_bitwise_equal_to_an_uninterrupted_one(tmp_path, monkeypatch, capsys):
    """A run that dies after step 10 of 15 (checkpoints every 5) and is
    restarted ends with the same parameters, bit for bit, as one that
    never stopped: the batches replay from (seed, step), Adam's moments
    and the schedule's position come back with the checkpoint."""
    over = {"train.ckpt_every": 5, "train.eval_every": 1000}
    whole = loop.train(_config(**over, **{"train.ckpt_dir": str(tmp_path / "a")}),
                       steps=15, verbose=False, device="cpu")

    config = _config(**over, **{"train.ckpt_dir": str(tmp_path / "b")})
    beats = []

    def crash_after_10():
        beats.append(1)
        if len(beats) == 11:
            raise RuntimeError("simulated crash in step 11")

    monkeypatch.setattr(loop.watchdog, "beat", crash_after_10)
    with pytest.raises(RuntimeError, match="simulated crash"):
        loop.train(config, steps=15, verbose=False, device="cpu")
    assert CheckpointManager(tmp_path / "b").latest_step() == 10
    monkeypatch.undo()
    resumed = loop.train(config, steps=15, verbose=True, device="cpu")
    assert "[train] resumed from step 10" in capsys.readouterr().out
    assert resumed.state.step == whole.state.step == 15
    for a, b in zip(resumed.state.model.parameters(), whole.state.model.parameters()):
        assert torch.equal(a, b)
    assert resumed.history[-1]["loss"] == whole.history[-1]["loss"]


def test_fixed_data_reuses_step_0s_batch():
    result = loop.train(_config(**{"train.learning_rate": 3e-3}), steps=12,
                        fixed_data=True, verbose=False, device="cpu")
    assert result.history[-1]["loss"] < result.history[0]["loss"]
    assert set(result.final_eval) == {"psnr", "ssim"}


def test_train_defaults_to_cuda():
    """No silent CPU fallback: without device= the loop asks for the card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works here")
    with pytest.raises((RuntimeError, AssertionError)):
        loop.train(_config(), steps=1, verbose=False)


def test_train_then_infer_through_the_cli(tmp_path, capsys):
    ck = tmp_path / "run"
    metrics = tmp_path / "m.jsonl"
    rc = train_cli.main(["--preset", "pdunet_parallel", "--device", "cpu", "--steps", "6",
                         "--ckpt-dir", str(ck), "--metrics", str(metrics),
                         "--set", "train.eval_every=3", *SMALL_FLAGS])
    assert rc == 0
    assert "[done] final eval" in capsys.readouterr().out
    best_step = json.loads((ck / "best.json").read_text())["step"]
    for which, step in (("best", best_step), ("latest", 6), ("6", 6)):
        out = tmp_path / f"{which}.json"
        rc = infer.main(["--preset", "pdunet_parallel", "--device", "cpu",
                         "--ckpt-dir", str(ck), "--ckpt", which, "--batch", "2",
                         "--n-slices", "4", "--json-out", str(out),
                         *INFER_FLAGS])
        assert rc == 0
        text = capsys.readouterr().out
        assert f"[infer] restored step {step} ({which})" in text and "WARNING" not in text
        assert json.loads(out.read_text())["ckpt_step"] == step
    # --resume none refuses the non-empty run directory
    with pytest.raises(SystemExit, match="non-empty"):
        train_cli.main(["--preset", "pdunet_parallel", "--device", "cpu", "--steps", "1",
                        "--ckpt-dir", str(ck), "--resume", "none", *SMALL_FLAGS])
    # a missing checkpoint is an error, not random weights
    with pytest.raises(SystemExit, match="no latest checkpoint"):
        infer.main(["--preset", "pdunet_parallel", "--device", "cpu",
                    "--ckpt-dir", str(tmp_path / "empty"), "--batch", "2", "--n-slices", "2",
                    *INFER_FLAGS])


def test_train_cli_dump_config_and_radial(tmp_path, capsys):
    rc = train_cli.main(["--preset", "pdunet_radial", "--dump-config", *SMALL_FLAGS])
    assert rc == 0
    dumped = json.loads(capsys.readouterr().out)
    assert dumped["name"] == "pdunet_radial" and dumped["geometry"]["image_size"] == 32
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps(dumped))
    assert train_cli.main(["--config", str(cfg), "--device", "cpu", "--steps", "2"]) == 0
    assert "[done] final eval" in capsys.readouterr().out


#: the flags of a run over ranks: bounded waits
DIST_FLAGS = ["--dist-timeout", "120"]


@pytest.mark.parametrize("flags,match", [
    (["--devices", "2", *DIST_FLAGS], None),
    (["--angle-devices", "2", *DIST_FLAGS], None),
    (["--tb-dir", "tb"], None),
    (["--checkify"], "XLA tool"),
    (["--dump-hlo", "hlo"], "XLA tool"),
], ids=["devices", "angle_devices", "tb_dir", "checkify", "dump_hlo"])
def test_unported_train_flags_raise(flags, match, tmp_path, monkeypatch, capfd):
    """The XLA tools raise; the mesh and TensorBoard flags, which raised
    until they were ported, run a step at the small size (two gloo ranks)."""
    monkeypatch.chdir(tmp_path)
    if match is not None:
        with pytest.raises(NotImplementedError, match=match):
            train_cli.main(["--preset", "pdunet_parallel", "--device", "cpu", *flags])
        return
    assert train_cli.main(["--preset", "pdunet_parallel", "--device", "cpu", "--steps", "1",
                           *SMALL_FLAGS, *flags]) == 0
    assert "[done] final eval" in capfd.readouterr().out
    if "--tb-dir" in flags:
        assert len(list((tmp_path / "tb").iterdir())) == 1


def test_profile_dir_writes_a_trace_of_steps_10_to_15(tmp_path):
    loop.train(_config(), steps=16, profile_dir=str(tmp_path / "prof"), verbose=False,
               device="cpu")
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("Optimizer.step" in n for n in names)


def test_train_cli_debug_nans_runs_under_anomaly_detection(capsys):
    assert train_cli.main(["--preset", "pdunet_parallel", "--device", "cpu", "--steps", "1",
                           "--debug-nans", *SMALL_FLAGS]) == 0
    assert "[done] final eval" in capsys.readouterr().out
    assert not torch.is_anomaly_enabled()
