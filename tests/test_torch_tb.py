"""The port's TensorBoard logging (``train(tb_dir=...)``, ``train --tb-dir``):
every logged scalar but ``step`` under its own tag and each validation
scalar as ``val_<name>``, the values of the JSONL metrics file, the tag set
of the JAX package's clu writer for the same config, and a clear error
when the tensorboard package is missing. Small shapes: sino_unet_parallel
(whose steps log the aux terms too) at 32², 40 angles, base 8, depth 1,
batch 2, 4 steps."""

import json
import sys

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

from pdunet_tpu.configs import get_preset as jax_get_preset
from pdunet_tpu.training import loop as jax_loop
from pdunet_tpu_torch import train as train_cli
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.training import loop

torch.set_num_threads(1)

SMALL = {"geometry.image_size": 32, "geometry.n_angles": 40, "model.base_features": 8,
         "model.depth": 1, "train.batch_size": 2, "train.val_slices": 2,
         "train.log_every": 1, "train.eval_every": 2}
STEPS = 4


def _scalars(tb_dir) -> dict:
    """{tag: {step: value}} of an event directory, whether the writer
    stored scalars (torch) or scalar tensors (clu, TF2 summaries)."""
    acc = EventAccumulator(str(tb_dir), size_guidance={"scalars": 0, "tensors": 0})
    acc.Reload()
    out = {}
    for tag in acc.Tags()["scalars"]:
        out[tag] = {e.step: e.value for e in acc.Scalars(tag)}
    for tag in acc.Tags().get("tensors", []):
        out[tag] = {e.step: float(np.asarray(e.tensor_proto.float_val or
                                             [np.frombuffer(e.tensor_proto.tensor_content,
                                                            np.float32)[0]])[0])
                    for e in acc.Tensors(tag)}
    return out


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    d = tmp_path_factory.mktemp("tb_port")
    loop.train(get_preset("sino_unet_parallel").override(SMALL), steps=STEPS,
               metrics_path=str(d / "m.jsonl"), verbose=False, device="cpu",
               tb_dir=str(d / "tb"))
    lines = [json.loads(s) for s in (d / "m.jsonl").read_text().splitlines()]
    return lines, _scalars(d / "tb")


def test_scalars_equal_the_jsonl_metrics(port_run):
    lines, scalars = port_run
    want = {}
    for m in lines:
        is_eval = "loss" not in m
        for k, v in m.items():
            if k != "step":
                want.setdefault(f"val_{k}" if is_eval else k, {})[m["step"]] = v
    assert scalars.keys() == want.keys()
    for tag, by_step in want.items():
        assert scalars[tag].keys() == by_step.keys(), tag
        for step, v in by_step.items():
            np.testing.assert_allclose(scalars[tag][step], v, rtol=1e-6, err_msg=tag)


def test_tags_are_clus_for_the_same_config(port_run, tmp_path):
    _, scalars = port_run
    jax_loop.train(jax_get_preset("sino_unet_parallel").override(SMALL), steps=STEPS,
                   verbose=False, tb_dir=str(tmp_path / "tb"))
    want = _scalars(tmp_path / "tb")
    assert {"loss", "grad_norm", "sino_loss", "img_loss", "val_psnr"} <= want.keys()
    assert scalars.keys() == want.keys()
    for tag in want:
        assert scalars[tag].keys() == want[tag].keys(), tag


def test_missing_tensorboard_names_the_flag(monkeypatch, tmp_path):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    with pytest.raises(ImportError, match="--tb-dir"):
        train_cli.main(["--preset", "sino_unet_parallel", "--device", "cpu", "--steps", "1",
                        "--tb-dir", str(tmp_path / "tb"),
                        *[a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]])
    assert not (tmp_path / "tb").exists()
