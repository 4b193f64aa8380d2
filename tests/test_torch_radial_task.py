"""The port's radial MRI model and task against the JAX package: the complex
PD-UNet with flax weights carried across, the pdunet_radial task's σ,
synthesis and recon_fn, nonnegative phantoms and the infer entry point, at
32² with 24 golden-angle spokes (64 samples). The operators are held in
tests/test_torch_radial.py."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.configs import get_preset as jax_get_preset
from pdunet_tpu.data.synth import rasterize_jnp
from pdunet_tpu.data.synth import sample_ellipse_params as jax_sample_ellipses
from pdunet_tpu.geometry import RadialGeometry as JaxRadial
from pdunet_tpu.models.primal_dual import make_pdunet as jax_make_pdunet
from pdunet_tpu.ops import nufft as jax_nufft
from pdunet_tpu.training import tasks as jax_tasks
from pdunet_tpu_torch import infer
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.data.synth import random_phantom_batch, rasterize, sample_ellipse_params
from pdunet_tpu_torch.geometry import RadialGeometry
from pdunet_tpu_torch.models.convert import flax_to_torch
from pdunet_tpu_torch.models.primal_dual import make_pdunet
from pdunet_tpu_torch.ops.nufft import make_radial_ops
from pdunet_tpu_torch.training.tasks import build_task

torch.set_num_threads(1)

N = 32
GEOM = dict(image_size=N, n_spokes=24)          # samples_per_spoke → 64


def rel(a, b):
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


# -- (g) the complex PD-UNet ---------------------------------------------------

def test_complex_pdunet_forward_matches_flax():
    """complex_ops: (Re, Im) channel pairs, dual 6 → 2, primal 4 → 2, with
    both packages' own fourier-slice operators and converted weights, in
    float32 to 1e-4 (bf16 is held in the task test below)."""
    jdt, tdt, tol = jnp.float32, torch.float32, 1e-4
    jo = jax_nufft.make_radial_ops(JaxRadial(**GEOM), dtype=jdt)
    to = make_radial_ops(RadialGeometry(**GEOM), dtype=tdt, device="cpu")
    sigma = 60.0
    kw = dict(n_iters=2, base_features=8, depth=2, stem=2, complex_ops=True, dtype=jdt)
    jm = jax_make_pdunet(lambda f: jo.A(f) / sigma, lambda p: jo.At(p) / sigma, **kw)
    tm = make_pdunet(lambda f: to.A(f) / sigma, lambda p: to.At(p) / sigma,
                     **dict(kw, dtype=tdt), device="cpu")
    assert tm.iterations[0].dual.blocks[0].convs[0].weight.shape[1] == 6 * 4   # stem 2
    assert tm.iterations[0].primal.head.weight.shape[0] == 2 * 4
    rng = np.random.default_rng(8)
    g = _cplx(rng, (2, 24, 64))
    f0 = _cplx(rng, (2, N, N))
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(g), jnp.asarray(f0))["params"]
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(g), jnp.asarray(f0)))
    flax_to_torch(jax.tree_util.tree_map(np.asarray, params), tm)
    with torch.no_grad():
        out = tm(torch.from_numpy(g), torch.from_numpy(f0))
    assert out.dtype == torch.complex64 and out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < tol


# -- (h) the pdunet_radial task ----------------------------------------------

def _small(config):
    """pdunet_radial cut to test size: 32², 96 spokes kept 4× sparse (24)
    of 64 samples, base 8, depth 2, stem 2, 2 iterations, batch 2."""
    return config.override({
        "geometry.image_size": 32, "geometry.n_angles": 96,
        "model.base_features": 8, "model.depth": 2, "model.stem": 2,
        "model.n_iters": 2, "train.batch_size": 2,
    })


@pytest.fixture(scope="module")
def x0_jax():
    """The JAX power iteration's start vector, handed to the port."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N, N)))


@pytest.mark.parametrize("bf16,tol", [(False, 1e-4), (True, 5e-3)], ids=["f32", "bf16"])
def test_radial_recon_fn_matches_jax(x0_jax, bf16, tol):
    """σ from the unroll's sparse operators, f32 synthesis (sino) and DCF
    adjoint (f0), and |PD-UNet| with the flax init carried across, for the
    same complex image."""
    over = {"model.use_bfloat16": bf16}
    jcfg = _small(jax_get_preset("pdunet_radial")).override(over)
    tcfg = _small(get_preset("pdunet_radial")).override(over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jtask = jax_tasks.build_task(jcfg)
    ttask = build_task(tcfg, device="cpu", opnorm_x0=x0_jax)

    _, sparse = jax_tasks.build_geometries(jcfg.geometry)
    jo = jax_nufft.make_radial_ops(sparse, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    sigma_j = jax_tasks.estimate_opnorm(jo.A, jo.At, (N, N), is_complex=True)
    assert abs(ttask.sigma - sigma_j) / sigma_j < (1e-3 if bf16 else 1e-5)

    rng = np.random.default_rng(9)
    mag = np.abs(rng.standard_normal((2, N, N))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, N, N)).astype(np.float32)
    re, im = (mag * np.cos(phase)).astype(np.float32), (mag * np.sin(phase)).astype(np.float32)
    jbatch = jtask.batch_from_images((jnp.asarray(re), jnp.asarray(im)))
    tbatch = ttask.batch_from_images((torch.from_numpy(re), torch.from_numpy(im)))
    assert set(tbatch) == set(jbatch) == {"image", "image_c", "sino", "f0"}
    assert rel(tbatch["image_c"], jbatch["image_c"]) == 0.0
    np.testing.assert_allclose(tbatch["image"].numpy(), np.asarray(jbatch["image"]), rtol=1e-6)
    assert rel(tbatch["sino"], jbatch["sino"]) < 1e-5
    assert rel(tbatch["f0"], jbatch["f0"]) < 1e-5
    # a complex tensor gives the same batch as its (re, im) pair
    alt = ttask.batch_from_images(torch.complex(torch.from_numpy(re), torch.from_numpy(im)))
    assert torch.equal(alt["sino"], tbatch["sino"])

    params = jtask.init_params(jax.random.PRNGKey(0))
    ref = np.asarray(jtask.recon_fn(params, jbatch))
    flax_to_torch(jax.tree_util.tree_map(np.asarray, params), ttask.model)
    with torch.no_grad():
        out = ttask.recon_fn(ttask.model, tbatch)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < tol


def test_radial_make_batch_is_seeded_and_phased():
    task = build_task(_small(get_preset("pdunet_radial")), device="cpu")
    a = task.make_batch(torch.Generator().manual_seed(1))
    b = task.make_batch(torch.Generator().manual_seed(1))
    assert set(a) == {"image", "image_c", "sino", "f0"}
    assert a["image_c"].dtype == torch.complex64 and a["image_c"].shape == (2, N, N)
    assert a["sino"].shape == (2, 24, 64) and a["f0"].dtype == torch.complex64
    assert torch.equal(a["sino"], b["sino"])
    assert a["image"].min() >= 0 and a["image"].max() > 0
    torch.testing.assert_close(a["image_c"].abs(), a["image"], rtol=1e-5, atol=1e-6)
    assert a["image_c"].imag.abs().max() > 0.1   # the phase field is not flat
    rec = task.recon_fn(task.model, a)
    assert rec.dtype == torch.float32 and rec.shape == (2, N, N) and rec.min() >= 0


def test_kspace_noise_is_refused():
    """k-space noise is ported: kspace_snr_db > 0 builds, make_batch draws
    the noise from its generator at that SNR, and batch_from_images stays
    noiseless without one. An odd spoke length builds on the gridding NUFFT,
    with a warning, and its noise holds the same SNR."""
    cfg = _small(get_preset("pdunet_radial")).override({"train.kspace_snr_db": 30.0})
    task = build_task(cfg, device="cpu")
    a = task.make_batch(torch.Generator().manual_seed(1))
    clean = task.batch_from_images(a["image_c"])
    noise = a["sino"] - clean["sino"]
    snr = 10 * torch.log10((clean["sino"].abs() ** 2).mean((-2, -1))
                           / (noise.abs() ** 2).mean((-2, -1)))
    assert torch.allclose(snr, torch.full_like(snr, 30.0), atol=0.5), snr
    with pytest.warns(UserWarning, match="even samples_per_spoke"):
        odd = build_task(cfg.override({"geometry.samples_per_spoke": 63}), device="cpu")
    a = odd.make_batch(torch.Generator().manual_seed(1))
    noise = a["sino"] - odd.batch_from_images(a["image_c"])["sino"]
    assert a["sino"].shape == (2, 24, 63)
    snr = 10 * torch.log10((a["sino"] - noise).abs().pow(2).mean((-2, -1))
                           / noise.abs().pow(2).mean((-2, -1)))
    assert torch.allclose(snr, torch.full_like(snr, 30.0), atol=0.5), snr


# -- (i) nonnegative phantoms --------------------------------------------------

def test_nonneg_phantoms_rasterise_like_jax():
    prm = np.stack([
        np.asarray(jax_sample_ellipses(jax.random.PRNGKey(i), 8, 0.45 * N, nonneg=True))
        for i in range(3)
    ]).astype(np.float32)
    assert prm[..., 0].min() >= 0.1
    ref = np.stack([np.asarray(rasterize_jnp(jnp.asarray(p), N)) for p in prm])
    np.testing.assert_array_equal(rasterize(torch.from_numpy(prm), N).numpy(), ref)
    prm_t = sample_ellipse_params(torch.Generator().manual_seed(2), 4, 8, 0.45 * N,
                                  nonneg=True, device="cpu")
    assert prm_t[..., 0].min() >= 0.1 and prm_t[..., 0].max() <= 1.0
    img = random_phantom_batch(torch.Generator().manual_seed(2), 4, N, nonneg=True,
                               device="cpu")
    assert img.min() >= 0 and img.max() > 0


# -- (j) the entry point -------------------------------------------------------

def test_infer_cli_radial_on_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    rc = infer.main(["--preset", "pdunet_radial", "--device", "cpu",
                     "--set", "geometry.image_size=32", "--set", "geometry.n_angles=96",
                     "--set", "model.base_features=8", "--set", "model.n_iters=2",
                     "--batch", "2", "--n-slices", "4", "--json-out", str(out)])
    assert rc == 0
    table = json.loads(out.read_text())
    assert table["n_slices"] == 4 and np.isfinite(table["psnr_mean"])
    assert -1.0 <= table["ssim_mean"] <= 1.0
    assert "[infer] pdunet_radial: PSNR" in capsys.readouterr().out
