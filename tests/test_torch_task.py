"""The port's serving path as a whole against the JAX package: phantom
rasterisation, PSNR/SSIM, the pdunet task's batch synthesis and recon_fn
with the same weights, batch and power-iteration start vector; plus the
port's own contracts (explicit device, no JAX imports)."""

import ast
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.configs import get_preset as jax_get_preset
from pdunet_tpu.data.synth import rasterize_jnp, sample_ellipse_params
from pdunet_tpu.ops import metrics as jax_metrics
from pdunet_tpu.ops.radon.parallel import make_parallel_ops as jax_ops
from pdunet_tpu.training import tasks as jax_tasks
from pdunet_tpu_torch import infer
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.data.synth import random_phantom_batch, rasterize
from pdunet_tpu_torch.models.convert import flax_to_torch
from pdunet_tpu_torch.ops import metrics
from pdunet_tpu_torch.training.tasks import build_task

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _small(config):
    """pdunet_parallel cut to test size: 32², 96 angles kept 4× sparse (24),
    base 8, depth 2, stem 2, 2 iterations, batch 2."""
    return config.override({
        "geometry.image_size": 32, "geometry.n_angles": 96,
        "model.base_features": 8, "model.depth": 2, "model.stem": 2,
        "model.n_iters": 2, "train.batch_size": 2,
    })


@pytest.mark.parametrize("N", [32, 64])
def test_rasterize_matches_jax(N):
    """Same float32 arithmetic in the same order: equal pixel for pixel."""
    prm = np.stack([
        np.asarray(sample_ellipse_params(jax.random.PRNGKey(i), 8, 0.45 * N))
        for i in range(3)
    ]).astype(np.float32)
    ref = np.stack([np.asarray(rasterize_jnp(jnp.asarray(p), N)) for p in prm])
    out = rasterize(torch.from_numpy(prm), N)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), ref)


def test_random_phantom_batch_is_seeded_and_bounded():
    a = random_phantom_batch(torch.Generator().manual_seed(3), 2, 32, device="cpu")
    b = random_phantom_batch(torch.Generator().manual_seed(3), 2, 32, device="cpu")
    assert a.shape == (2, 32, 32) and torch.equal(a, b)
    assert a.abs().max() <= 8.0 and a.abs().max() > 0


def test_psnr_ssim_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 40, 40)).astype(np.float32)
    y = (x + 0.1 * rng.standard_normal(x.shape)).astype(np.float32)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    np.testing.assert_allclose(metrics.psnr(ty, tx).numpy(),
                               np.asarray(jax_metrics.psnr(jy, jx)), rtol=1e-5)
    np.testing.assert_allclose(metrics.ssim(ty, tx).numpy(),
                               np.asarray(jax_metrics.ssim(jy, jx)), atol=2e-6)
    np.testing.assert_allclose(metrics.psnr(ty, tx, data_range=1.0).numpy(),
                               np.asarray(jax_metrics.psnr(jy, jx, data_range=1.0)),
                               rtol=1e-5)
    np.testing.assert_allclose(metrics.ssim(ty, tx, data_range=1.0).numpy(),
                               np.asarray(jax_metrics.ssim(jy, jx, data_range=1.0)),
                               atol=2e-6)
    # far-off-scale prediction: the moment clamps keep SSIM bounded and
    # near zero in both (the cancellation residue differs, hence atol)
    far = metrics.ssim(ty + 1000.0, tx).numpy()
    np.testing.assert_allclose(far, np.asarray(jax_metrics.ssim(jy + 1000.0, jx)),
                               atol=2e-5)
    assert np.all(np.abs(far) <= 1.0)
    assert metrics.mse(ty, tx).shape == (3,)


@pytest.fixture(scope="module")
def x0_jax():
    """The JAX power iteration's start vector, handed to the port."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (32, 32)))


@pytest.mark.parametrize("bf16,tol", [(False, 1e-4), (True, 5e-3)], ids=["f32", "bf16"])
def test_recon_fn_matches_jax(x0_jax, bf16, tol):
    """make_batch-style synthesis (f32 A + FBP), σ from the unroll's sparse
    operators, and the PD-UNet unroll, with the flax init carried across.
    bf16 differs more: JAX on the CPU runs the per-angle einsum operator and
    the port the pair operator, so bf16 operands round at different points
    (~5e-4 measured; 5e-3 is the projector's bf16 tolerance)."""
    over = {"model.use_bfloat16": bf16}
    jcfg = _small(jax_get_preset("pdunet_parallel")).override(over)
    tcfg = _small(get_preset("pdunet_parallel")).override(over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)

    jtask = jax_tasks.build_task(jcfg)
    ttask = build_task(tcfg, device="cpu", opnorm_x0=x0_jax)

    _, sparse = jax_tasks.build_geometries(jcfg.geometry)
    jo = jax_ops(sparse, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    sigma_j = jax_tasks.estimate_opnorm(jo.A, jo.At, (32, 32))
    assert abs(ttask.sigma - sigma_j) / sigma_j < (1e-3 if bf16 else 1e-5)

    img = random_phantom_batch(torch.Generator().manual_seed(11), 2, 32, device="cpu")
    jbatch = jtask.batch_from_images(jnp.asarray(img.numpy()))
    tbatch = ttask.batch_from_images(img)
    assert rel(tbatch["sino"], jbatch["sino"]) < 2e-5
    assert rel(tbatch["f0"], jbatch["f0"]) < 2e-5

    params = jtask.init_params(jax.random.PRNGKey(0))
    ref = np.asarray(jtask.recon_fn(params, jbatch))
    flax_to_torch(jax.tree_util.tree_map(np.asarray, params), ttask.model)
    with torch.no_grad():
        out = ttask.recon_fn(ttask.model, tbatch)
    assert out.shape == ref.shape == (2, 32, 32)
    assert rel(out, ref) < tol


def test_task_batch_and_init_are_seeded():
    task = build_task(_small(get_preset("pdunet_parallel")), device="cpu")
    batch = task.make_batch(torch.Generator().manual_seed(1))
    assert batch["image"].shape == (2, 32, 32)
    assert batch["sino"].shape == (2, 24, 32) and batch["f0"].shape == (2, 32, 32)
    first = [p.detach().clone() for p in task.model.parameters()]
    task.init_params(torch.Generator().manual_seed(5))
    assert not torch.equal(first[0], next(task.model.parameters()))
    task.init_params(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(first, task.model.parameters()))


def test_build_task_defaults_to_cuda():
    """No silent CPU fallback: without device= the task asks for the card,
    which this CPU-only build of PyTorch cannot give."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device works here")
    with pytest.raises((RuntimeError, AssertionError)):
        build_task(_small(get_preset("pdunet_parallel")))


def test_unported_task_kinds_raise():
    """Every preset builds, an odd spoke length too (on the gridding NUFFT,
    with a warning); a model kind without a task raises."""
    with pytest.warns(UserWarning, match="even samples_per_spoke"):
        task = build_task(get_preset("sino_unet_radial").override(
            {"geometry.samples_per_spoke": 47, "geometry.image_size": 32,
             "geometry.n_angles": 40, "model.base_features": 8}), device="cpu")
    assert task.sigma is None
    with pytest.raises(NotImplementedError):
        build_task(get_preset("pdunet_fan").override({"model.kind": "unet3d"}), device="cpu")


def test_infer_cli_on_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    rc = infer.main(["--preset", "pdunet_parallel", "--device", "cpu",
                     "--set", "geometry.image_size=32", "--set", "geometry.n_angles=96",
                     "--set", "model.base_features=8", "--set", "model.n_iters=2",
                     "--batch", "2", "--n-slices", "4", "--json-out", str(out)])
    assert rc == 0
    table = json.loads(out.read_text())
    assert table["n_slices"] == 4 and np.isfinite(table["psnr_mean"])
    assert -1.0 <= table["ssim_mean"] <= 1.0
    assert "[infer] pdunet_parallel: PSNR" in capsys.readouterr().out


_FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "pdunet_tpu"}


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((REPO / "pdunet_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = {str(f.relative_to(REPO)): sorted(set(_imported_roots(f)) & _FORBIDDEN)
           for f in files}
    assert not {k: v for k, v in bad.items() if v}
