"""File-backed training in the port (``training.loop.train(data=...)`` and
``train --data``) against the JAX package's data path, on the CPU at small
sizes (32², base 8, depth 2, 2 iterations, batch 2).

The host batches are the JAX loader's: the images the first step receives
equal JAX's first ``iterate_batches`` batch of the same store and seed (bit
for bit). Validation reads the ``val`` split, noiselessly: the run's final
eval equals a fresh eval of its weights on those batches (1e-6, the same
computation). The HU-volume case mirrors tests/test_datasets.py's with the
port's train and infer.
"""

import json

import numpy as np
import pytest
import torch

from pdunet_tpu.data import datasets as jax_datasets
from pdunet_tpu.data.phantoms import random_ellipses, rasterize_ellipses
from pdunet_tpu_torch import infer
from pdunet_tpu_torch import train as train_cli
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.data import datasets
from pdunet_tpu_torch.training import loop

torch.set_num_threads(1)

N = 32
SMALL = {"geometry.image_size": 32, "geometry.n_angles": 96, "model.base_features": 8,
         "model.depth": 2, "model.stem": 2, "model.n_iters": 2, "train.batch_size": 2,
         "train.val_slices": 4, "train.warmup_steps": 1, "train.log_every": 1,
         "train.eval_every": 2}


def _config(preset="pdunet_parallel", **over):
    return get_preset(preset).override({**SMALL, **over})


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A 20-slice store written by the JAX package (16 / 2 / 2), and its
    npy copy."""
    d = tmp_path_factory.mktemp("store")
    h5 = jax_datasets.write_phantom_dataset(str(d / "s.h5"), 20, N, seed=1)
    return {"h5": h5, "npy": datasets.h5_to_npy(h5, str(d / "s"))}


def _recording(monkeypatch):
    """Record what each train step receives: (images, generator)."""
    seen = []
    real = loop.make_train_step

    def make(task, from_images=False):
        step = real(task, from_images=from_images)

        def wrapped(state, x, marks=None, generator=None):
            seen.append((x.clone() if torch.is_tensor(x) else x, generator))
            return step(state, x, marks, generator)

        return wrapped

    monkeypatch.setattr(loop, "make_train_step", make)
    return seen


@pytest.mark.parametrize("container", ["h5", "npy"])
def test_steps_see_the_jax_loader_batches(store, monkeypatch, container):
    seen = _recording(monkeypatch)
    config = _config(**{"train.seed": 7})
    loop.train(config, steps=3, verbose=False, device="cpu", data=store[container])
    ref = jax_datasets.iterate_batches(jax_datasets.SliceDataset(store["h5"]), 2, seed=7)
    for (images, gen), want in zip(seen, ref):
        assert images.dtype == torch.float32 and images.shape == (2, N, N)
        np.testing.assert_array_equal(images.numpy(), want)
        assert isinstance(gen, torch.Generator)  # the step's noise stream
    assert len(seen) == 3


def test_validation_reads_val_noiselessly(store, monkeypatch):
    reads = []
    real = loop.iterate_batches

    def recording(ds, batch_size, shuffle=True, seed=0, **kw):
        reads.append((ds.split, shuffle))
        return real(ds, batch_size, shuffle=shuffle, seed=seed, **kw)

    monkeypatch.setattr(loop, "iterate_batches", recording)
    config = _config(**{"train.photons_per_ray": 1e4})
    result = loop.train(config, steps=2, verbose=False, device="cpu", data=store["npy"])
    assert ("val", False) in reads and ("train", True) in reads
    assert ("train", False) not in reads  # val holds a whole batch: no fallback
    val = datasets.SliceDataset(store["npy"], "val")
    images = torch.from_numpy(val.batch(range(2)))
    evaluate = loop.make_eval_step(result.task)
    with torch.no_grad():
        ev = evaluate(result.state.model, result.task.batch_from_images(images))
    assert abs(float(ev["psnr"]) - result.final_eval["psnr"]) < 1e-6
    assert abs(float(ev["ssim"]) - result.final_eval["ssim"]) < 1e-6


def test_tiny_val_falls_back_to_the_first_train_batch(tmp_path, monkeypatch):
    path = datasets.write_phantom_dataset(str(tmp_path / "tiny"), 8, N, n_ellipses=3,
                                          splits=(0.75, 0.125, 0.125))
    reads = []
    real = loop.iterate_batches
    monkeypatch.setattr(loop, "iterate_batches", lambda ds, b, shuffle=True, **kw: (
        reads.append((ds.split, shuffle)) or real(ds, b, shuffle=shuffle, **kw)))
    result = loop.train(_config(), steps=1, verbose=False, device="cpu", data=path)
    assert ("train", False) in reads and np.isfinite(result.final_eval["psnr"])


def test_complex_store_trains_the_radial_task(tmp_path, monkeypatch):
    seen = _recording(monkeypatch)
    path = datasets.write_phantom_dataset(str(tmp_path / "c"), 10, N, seed=3,
                                          complex_phase=True)
    result = loop.train(_config("pdunet_radial"), steps=2, verbose=False, device="cpu",
                        data=path)
    assert seen[0][0].dtype == torch.complex64
    first = next(datasets.iterate_batches(datasets.SliceDataset(path), 2, seed=0))
    np.testing.assert_array_equal(seen[0][0].numpy(), first)
    assert all(np.isfinite(m["loss"]) for m in result.history)


def test_refusals(store, tmp_path):
    with pytest.raises(ValueError, match="mutually exclusive"):
        loop.train(_config(), steps=1, fixed_data=True, verbose=False, device="cpu",
                   data=store["npy"])
    with pytest.raises(ValueError, match="split has 2 slices < batch_size 4"):
        loop.train(_config(**{"train.batch_size": 4}), steps=1, verbose=False, device="cpu",
                   data=store["npy"], split="test")
    with pytest.raises(ValueError, match="config expects 48"):
        loop.train(_config(**{"geometry.image_size": 48}), steps=1, verbose=False,
                   device="cpu", data=store["npy"])


def test_val_read_error_propagates(store, monkeypatch):
    real = datasets.SliceDataset.__getitem__

    def failing(self, idx):
        if self.split == "val":
            raise OSError("unreadable val slice")
        return real(self, idx)

    monkeypatch.setattr(datasets.SliceDataset, "__getitem__", failing)
    with pytest.raises(OSError, match="unreadable val slice"):
        loop.train(_config(), steps=1, verbose=False, device="cpu", data=store["npy"])


def test_prefetcher_closes_when_a_step_fails(store, monkeypatch):
    closed = []
    real = loop.HostPrefetcher

    class Recording(real):
        def close(self):
            closed.append(True)
            super().close()

    monkeypatch.setattr(loop, "HostPrefetcher", Recording)
    calls = []
    real_step = loop.make_train_step

    def failing_step(task, from_images=False):
        step = real_step(task, from_images=from_images)

        def wrapped(state, x, marks=None, generator=None):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("step 2 failed")
            return step(state, x, marks, generator)

        return wrapped

    monkeypatch.setattr(loop, "make_train_step", failing_step)
    with pytest.raises(RuntimeError, match="step 2 failed"):
        loop.train(_config(), steps=4, verbose=False, device="cpu", data=store["npy"])
    assert closed == [True]


def test_train_cli_data_flags(store, tmp_path, capsys):
    flags = [a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]
    assert train_cli.main(["--preset", "pdunet_parallel", "--device", "cpu", *flags,
                           "--steps", "2", "--data", store["npy"], "--split", "train",
                           "--metrics", str(tmp_path / "m.jsonl")]) == 0
    rows = [json.loads(line) for line in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2]
    assert "[done] final eval" in capsys.readouterr().out
    args = train_cli.parse_args(["--preset", "pdunet_parallel"])
    assert args.data is None and args.split == "train"


def test_hu_volume_trains_and_evaluates_end_to_end(tmp_path):
    """A Hounsfield-unit volume ingested with convert_volume(domain="hu")
    trains file-backed and scores through infer's windowed-HU path with no
    manual normalisation (tests/test_datasets.py's case, on the port)."""
    rng = np.random.default_rng(3)
    slices = np.stack([rasterize_ellipses(random_ellipses(rng, 4, 0.45 * N, nonneg=True), N)
                       for _ in range(12)])
    hu = 1000.0 * (slices - 1.0)
    path = datasets.convert_volume(hu, str(tmp_path / "ct_hu"), domain="hu",
                                   train_frac=0.7, val_frac=0.15)
    over = {"geometry.n_angles": 40, "geometry.sparsity": 4, "model.use_bfloat16": False,
            "train.batch_size": 4, "train.steps": 5, "train.log_every": 5,
            "train.eval_every": 1000, "train.ckpt_dir": str(tmp_path / "ckpt")}
    result = loop.train(_config("fbp_unet_parallel", **over), verbose=False, device="cpu",
                        data=path)
    assert np.isfinite(result.final_eval["psnr"])
    out = tmp_path / "hu_eval.json"
    assert infer.main([
        "--preset", "fbp_unet_parallel", "--device", "cpu",
        "--set", "geometry.image_size=32", "--set", "geometry.n_angles=40",
        "--set", "model.base_features=8", "--set", "model.depth=2",
        "--set", "model.use_bfloat16=false", "--ckpt-dir", str(tmp_path / "ckpt"),
        "--data", path, "--batch", "2", "--split", "test", "--hu-window", "0", "2000",
        "--json-out", str(out)]) == 0
    table = json.loads(out.read_text())
    assert table["n_slices"] >= 1 and table["ckpt_step"] == 5
    assert np.isfinite(table["psnr_mean"]) and 0.0 <= table["ssim_mean"] <= 1.0
