"""The port's infer flags (pdunet_tpu_torch/infer.py) against the JAX
package's ``infer.main`` on the CPU: --config, --data / --split,
--hu-window, --corrupt, --export-png, --devices and --watchdog-secs.

Both sides score the same weights: the JAX run has no checkpoint (its
weights are ``init_params(PRNGKey(0))``), and the port loads those flax
weights, converted, from a checkpoint of its own. The task is
fbp_unet_parallel cut to 32², 10 of 40 angles, base 8, depth 2, float32,
batch 2, so PSNR agrees to 1e-3 dB and SSIM to 1e-5 (the f32 recon agrees
to ~1e-6 relative). --corrupt feeds JAX's normal draws (the key of batch
``bi`` is fold_in(PRNGKey(seed + 1), bi)) into the port's noise function
through its ``normal=`` hook. Exported PNGs: the ground truth is bit-equal,
a reconstruction within one grey level (the uint8 truncation of values
that differ by ~1e-6).
"""

import json

import jax
import numpy as np
import pytest
import torch

import infer as jax_infer
from pdunet_tpu.configs import get_preset as jax_get_preset
from pdunet_tpu.data import datasets as jax_datasets
from pdunet_tpu.data.phantoms import random_ellipses, rasterize_ellipses
from pdunet_tpu.training import tasks as jax_tasks
from pdunet_tpu_torch import infer
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.data import datasets
from pdunet_tpu_torch.models.convert import flax_to_torch
from pdunet_tpu_torch.training import loop, tasks
from pdunet_tpu_torch.training.checkpoint import CheckpointManager
from pdunet_tpu_torch.utils.png import read_gray_png

torch.set_num_threads(1)

N = 32
SMALL = {"geometry.image_size": 32, "geometry.n_angles": 40, "model.base_features": 8,
         "model.depth": 2, "model.use_bfloat16": False, "train.batch_size": 2}
FLAGS = ["--preset", "fbp_unet_parallel",
         *[a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]]
PSNR_TOL, SSIM_TOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    """A HU-domain CT volume (8 slices: 4 train, 2 val, 2 test) written by
    the JAX package, and its npy copy."""
    d = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(3)
    dens = np.stack([rasterize_ellipses(random_ellipses(rng, 4, 0.45 * N, nonneg=True), N)
                     for _ in range(8)])
    h5 = jax_datasets.convert_volume(1000.0 * (dens - 1.0), str(d / "ct.h5"), domain="hu",
                                     train_frac=0.5, val_frac=0.25)
    return {"h5": h5, "npy": datasets.h5_to_npy(h5, str(d / "ct"))}


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """A port checkpoint holding the JAX task's init_params(PRNGKey(0))."""
    d = tmp_path_factory.mktemp("ckpt")
    config = get_preset("fbp_unet_parallel").override(SMALL)
    task = tasks.build_task(config, device="cpu")
    jtask = jax_tasks.build_task(jax_get_preset("fbp_unet_parallel").override(SMALL))
    params = jtask.init_params(jax.random.PRNGKey(0))
    flax_to_torch(jax.tree_util.tree_map(np.asarray, params), task.model)
    CheckpointManager(str(d)).save(1, loop.build_state(task), config=config, force=True)
    return str(d)


def _port(tmp_path, ckpt, *flags):
    out = tmp_path / "port.json"
    assert infer.main([*FLAGS, "--device", "cpu", "--ckpt-dir", ckpt, "--json-out",
                       str(out), *flags]) == 0
    return json.loads(out.read_text())


def _jax(tmp_path, *flags):
    out = tmp_path / "jax.json"
    assert jax_infer.main([*FLAGS, "--json-out", str(out), *flags]) == 0
    return json.loads(out.read_text())


def _close(a, b):
    assert a["n_slices"] == b["n_slices"] > 0
    assert abs(a["psnr_mean"] - b["psnr_mean"]) < PSNR_TOL, (a, b)
    assert abs(a["psnr_std"] - b["psnr_std"]) < PSNR_TOL, (a, b)
    assert abs(a["ssim_mean"] - b["ssim_mean"]) < SSIM_TOL, (a, b)


@pytest.mark.parametrize("window", [None, ("40", "400"), ("0", "2000")],
                         ids=["plain", "soft_tissue", "wide"])
def test_data_split_and_hu_window_match_jax(store, ckpt, tmp_path, window):
    flags = ["--data", store["h5"], "--split", "test"]
    if window:
        flags += ["--hu-window", *window]
    _close(_port(tmp_path, ckpt, *flags), _jax(tmp_path, *flags))


def test_corrupt_matches_jax_on_its_draws(store, ckpt, tmp_path, monkeypatch):
    """Low-dose noise at 10⁴ photons per ray on the file path, each batch's
    normal draw JAX's."""
    seed, calls = 5, []
    real = tasks.lowdose_poisson_noise

    def jax_draws(gen, x, level):
        assert gen is not None  # --corrupt hands the task a generator
        key = jax.random.fold_in(jax.random.PRNGKey(seed + 1), len(calls))
        calls.append(tuple(x.shape))
        z = np.array(jax.random.normal(key, tuple(x.shape), dtype=jax.numpy.float32))
        return real(gen, x, level, normal=torch.from_numpy(z))

    monkeypatch.setattr(tasks, "lowdose_poisson_noise", jax_draws)
    flags = ["--set", "train.photons_per_ray=10000", "--data", store["h5"], "--split",
             "val", "--corrupt", "--seed", str(seed)]
    port = _port(tmp_path, ckpt, *flags)
    assert len(calls) == 1  # one batch of the 2-slice val split
    _close(port, _jax(tmp_path, *flags))
    clean = _port(tmp_path, ckpt, *flags[:-3])
    assert clean["psnr_mean"] != port["psnr_mean"]


def test_corrupt_synthetic_draws_the_training_noise(ckpt, tmp_path, monkeypatch):
    """Synthetic --corrupt is make_batch itself: phantoms, then the noise."""
    made = []
    real = tasks.build_task

    def recording(config, **kw):
        task = real(config, **kw)
        mb = task.make_batch

        def make_batch(gen):
            made.append(gen)
            return mb(gen)

        return task._replace(make_batch=make_batch)

    monkeypatch.setattr(infer, "build_task", recording)
    noisy = _port(tmp_path, ckpt, "--set", "train.photons_per_ray=10000", "--corrupt",
                  "--n-slices", "4")
    clean = _port(tmp_path, ckpt, "--set", "train.photons_per_ray=10000", "--n-slices", "4")
    assert len(made) == 4 and noisy["n_slices"] == clean["n_slices"] == 4
    assert noisy["psnr_mean"] < clean["psnr_mean"]


def test_npy_store_scores_like_hdf5_and_ignores_n_slices(store, ckpt, tmp_path):
    a = _port(tmp_path, ckpt, "--data", store["h5"], "--split", "train")
    b = _port(tmp_path, ckpt, "--data", store["npy"], "--split", "train", "--n-slices", "64")
    assert a == b and a["n_slices"] == 4
    with pytest.raises(SystemExit, match="smaller --batch"):
        _port(tmp_path, ckpt, "--data", store["npy"], "--split", "test", "--batch", "4")


def test_config_file(ckpt, tmp_path):
    """--config reads the JSON a run was configured with; --set and --batch
    still apply on top."""
    cfg = tmp_path / "run.json"
    cfg.write_text(get_preset("fbp_unet_parallel").override(SMALL).to_json())
    out = tmp_path / "c.json"
    assert infer.main(["--config", str(cfg), "--device", "cpu", "--ckpt-dir", ckpt,
                       "--n-slices", "2", "--json-out", str(out)]) == 0
    via_config = json.loads(out.read_text())
    assert via_config == _port(tmp_path, ckpt, "--n-slices", "2")
    args = infer.parse_args(["--config", str(cfg), "--set", "model.depth=1", "--batch", "3"])
    config = infer.resolve_config(args)
    assert config.model.depth == 1 and config.train.batch_size == 3
    assert config.model.base_features == 8
    with pytest.raises(SystemExit, match="need --preset or --config"):
        infer.resolve_config(infer.parse_args([]))


def test_export_png_matches_jax_dump(store, ckpt, tmp_path):
    from PIL import Image

    flags = ["--data", store["h5"], "--split", "train", "--export-count", "3"]
    _port(tmp_path, ckpt, *flags, "--export-png", str(tmp_path / "port"))
    _jax(tmp_path, *flags, "--export-png", str(tmp_path / "jax"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == sorted(f"b{b}_{i:03d}_{k}.png" for b, i in ((0, 0), (0, 1), (1, 2))
                           for k in ("recon", "gt"))
    for name in names:
        ours = np.asarray(Image.open(tmp_path / "port" / name))
        ref = np.asarray(Image.open(tmp_path / "jax" / name))
        assert ours.dtype == ref.dtype == np.uint8 and ours.shape == ref.shape == (N, N)
        np.testing.assert_array_equal(ours, read_gray_png(tmp_path / "port" / name))
        if name.endswith("_gt.png"):
            np.testing.assert_array_equal(ours, ref)
        else:
            assert np.abs(ours.astype(int) - ref).max() <= 1


def test_devices_above_one_raise(ckpt, store, tmp_path):
    """``--devices 2`` (which raised until the mesh was ported) runs two
    gloo ranks: its table equals ``--devices 1`` (PSNR rtol 1e-5, SSIM
    1e-4, as tests/test_sharding.py asks of JAX's) and JAX's ``--devices
    2`` on the same weights and slices; a count that does not divide the
    batch is refused."""
    flags = ["--data", store["h5"], "--split", "train"]
    one = _port(tmp_path, ckpt, *flags, "--devices", "1")
    two = _port(tmp_path, ckpt, *flags, "--devices", "2", "--dist-timeout", "120")
    assert one["n_slices"] == two["n_slices"] == 4
    np.testing.assert_allclose(two["psnr_mean"], one["psnr_mean"], rtol=1e-5)
    np.testing.assert_allclose(two["ssim_mean"], one["ssim_mean"], rtol=1e-4)
    _close(two, _jax(tmp_path, *flags, "--devices", "2"))
    with pytest.raises(SystemExit, match="must divide"):
        infer.main([*FLAGS, "--device", "cpu", "--devices", "3"])
    assert _port(tmp_path, ckpt, "--devices", "1", "--n-slices", "2")["n_slices"] == 2


def test_watchdog_is_armed_before_build_task(ckpt, tmp_path, monkeypatch):
    order = []
    monkeypatch.setattr(infer.watchdog, "start",
                        lambda secs, label="": order.append(("start", secs, label)))
    real_beat, real_build = infer.watchdog.beat, infer.build_task
    monkeypatch.setattr(infer.watchdog, "beat", lambda: order.append("beat") or real_beat())
    monkeypatch.setattr(infer, "build_task",
                        lambda *a, **kw: order.append("build") or real_build(*a, **kw))
    _port(tmp_path, ckpt, "--watchdog-secs", "600", "--n-slices", "4")
    assert order == [("start", 600.0, "infer"), "build", "beat", "beat"]
