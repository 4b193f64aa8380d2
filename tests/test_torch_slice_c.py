"""The port's last two presets, pdunet_fan and sino_unet_radial, and the
other CT tasks on fan beam (fbp_unet, lpd), against the JAX package's:
batch synthesis (noiseless, and noisy on JAX's own normal draws), σ,
recon_fn and loss_fn with its aux from the same flax init and images, three
f32 train steps, and the golden mini-training runs of tests/test_goldens.py
fed JAX's own draws (its noise included); plus the radial sino task's
contracts (hard data consistency, the (re, im) input, the 2-channel UNet's
converter) and the loop, infer and bench on the CPU.

Small shapes: 32², 40 angles (radial: spokes of 48 samples) kept 4×
sparse, base 8, depth 2, stem 2, 2 iterations, batch 2. float32 1e-4,
bfloat16 5e-3 relative."""

import copy
import dataclasses
import importlib.util
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.configs import get_preset as jax_get_preset
from pdunet_tpu.models.unet import UNet as FlaxUNet
from pdunet_tpu.training import loop as jax_loop
from pdunet_tpu.training import tasks as jax_tasks
from pdunet_tpu_torch import bench, infer
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.models.convert import flax_to_torch
from pdunet_tpu_torch.models.unet import UNet
from pdunet_tpu_torch.training import loop, tasks
from pdunet_tpu_torch.training.tasks import build_task

torch.set_num_threads(1)

N = 32
TESTS = pathlib.Path(__file__).resolve().parent
PRESETS = ["pdunet_fan", "sino_unet_radial"]
#: the two presets, and the other CT tasks on the fan preset's geometry
FAN_TASKS = {"fbp_unet_fan": "fbp_unet_parallel", "lpd_fan": "lpd_parallel"}
CASES = PRESETS + list(FAN_TASKS)


def _config(get, case, **over):
    """The small config of a case, from either package's presets."""
    if case in FAN_TASKS:
        fan = get("pdunet_fan").geometry
        cfg = get(FAN_TASKS[case])
        cfg = dataclasses.replace(cfg, geometry=fan, train=dataclasses.replace(
            cfg.train, photons_per_ray=1e5))
    else:
        cfg = get(case)
    small = {"geometry.image_size": N, "geometry.n_angles": 40,
             "model.base_features": 8, "model.depth": 2, "model.stem": 2,
             "model.n_iters": 2, "train.batch_size": 2}
    if cfg.geometry.kind == "radial":
        small["geometry.samples_per_spoke"] = 48
    return cfg.override({**small, **over})


def _rel(a, b):
    a = np.asarray(a, np.complex128)
    b = np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _tree_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def x0_jax():
    """The JAX power iteration's start vector, handed to the port."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N, N)))


def _pair(case, over, x0):
    """The JAX and port tasks of one small config, the flax init loaded
    into the port's model."""
    jcfg, tcfg = _config(jax_get_preset, case, **over), _config(get_preset, case, **over)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jtask = jax_tasks.build_task(jcfg)
    ttask = build_task(tcfg, device="cpu", opnorm_x0=x0)
    params = jtask.init_params(jax.random.PRNGKey(0))
    flax_to_torch(_tree_np(params), ttask.model)
    return jtask, ttask, params


def _images(jtask, key):
    """JAX's ground truth of a batch: the complex image where there is one."""
    b = jtask.make_batch(key)
    img = np.array(b["image_c"] if "image_c" in b else b["image"])
    return jnp.asarray(img), torch.from_numpy(img)


def _feed_jax_normals(monkeypatch, draws):
    """Make the port's noise functions read the queued JAX normal draws."""
    for name in ("lowdose_poisson_noise", "kspace_gaussian_noise"):
        real = getattr(tasks, name)
        monkeypatch.setattr(tasks, name, lambda gen, x, level, real=real: real(
            gen, x, level, normal=torch.from_numpy(draws.pop(0))))


def _jax_normal(key, shape, complex_):
    z = jax.random.normal(key, shape, dtype=jnp.complex64 if complex_ else jnp.float32)
    return np.array(z)


# -- the tasks against JAX -------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("bf16,tol", [(False, 1e-4), (True, 5e-3)], ids=["f32", "bf16"])
def test_recon_and_loss_match_jax(case, bf16, tol, x0_jax):
    """batch_from_images (noiseless, f32), recon_fn and loss_fn with its
    aux, from the same flax init and phantoms."""
    jtask, ttask, params = _pair(case, {"model.use_bfloat16": bf16}, x0_jax)
    jimg, timg = _images(jtask, jax.random.PRNGKey(11))
    jbatch = jtask.batch_from_images(jimg)
    with torch.no_grad():
        tbatch = ttask.batch_from_images(timg)
    assert set(tbatch) == set(jbatch)
    for k in tbatch:
        assert _rel(tbatch[k], jbatch[k]) < 2e-5, k
    ref = np.asarray(jtask.recon_fn(params, jbatch))
    jloss, jaux = jtask.loss_fn(params, jbatch)
    with torch.no_grad():
        out = ttask.recon_fn(ttask.model, tbatch)
        tloss, taux = ttask.loss_fn(ttask.model, tbatch)
    assert out.shape == ref.shape == (2, N, N) and out.dtype == torch.float32
    assert _rel(out, ref) < tol
    assert abs(float(tloss) - float(jloss)) / abs(float(jloss)) < tol
    assert set(taux) == set(jaux) == ({"sino_loss", "img_loss"}
                                      if case == "sino_unet_radial" else set())
    for k in taux:
        assert abs(float(taux[k]) - float(jaux[k])) / abs(float(jaux[k])) < tol, k


@pytest.mark.parametrize("case,over", [
    ("pdunet_fan", {}),
    ("fbp_unet_fan", {}),
    ("lpd_fan", {}),
    ("sino_unet_parallel", {"train.photons_per_ray": 1e4}),
    ("sino_unet_radial", {"train.kspace_snr_db": 20.0}),
    ("pdunet_radial", {"train.kspace_snr_db": 20.0, "geometry.samples_per_spoke": 48}),
])
def test_noisy_batches_match_jax_on_its_draws(case, over, x0_jax, monkeypatch):
    """batch_from_images(images, generator) with JAX's normal draw fed to
    the port's noise: the same noisy measurement and direct recon as JAX's
    batch_from_images(images, key)."""
    if case in ("sino_unet_parallel", "pdunet_radial"):
        jcfg = jax_get_preset(case).override({
            "geometry.image_size": N, "geometry.n_angles": 40, "train.batch_size": 2,
            "model.base_features": 8, "model.n_iters": 2, **over})
        tcfg = get_preset(case).override({
            "geometry.image_size": N, "geometry.n_angles": 40, "train.batch_size": 2,
            "model.base_features": 8, "model.n_iters": 2, **over})
        jtask = jax_tasks.build_task(jcfg)
        ttask = build_task(tcfg, device="cpu", opnorm_x0=x0_jax)
    else:
        jtask, ttask, _ = _pair(case, over, x0_jax)
    key = jax.random.PRNGKey(13)
    jimg, timg = _images(jtask, jax.random.PRNGKey(12))
    jbatch = jtask.batch_from_images(jimg, key)
    cfg = ttask.config
    radial = cfg.geometry.kind == "radial"
    _, sparse = tasks.build_geometries(cfg.geometry)
    rows = sparse.n_spokes if radial else sparse.n_angles
    cols = (cfg.geometry.samples_per_spoke if radial
            else sparse.det_count)
    draws = [_jax_normal(key, (2, rows, cols), radial)]
    _feed_jax_normals(monkeypatch, draws)
    with torch.no_grad():
        tbatch = ttask.batch_from_images(timg, torch.Generator())
        clean = ttask.batch_from_images(timg)
    assert not draws, "the noise was not drawn"
    for k in tbatch:
        assert _rel(tbatch[k], jbatch[k]) < 2e-5, k
    noisy_key = {"pdunet": "sino", "lpd": "sino", "fbp_unet": "fbp"}.get(
        cfg.model.kind, "k_in_w" if radial else "sino_in")
    assert _rel(clean[noisy_key], tbatch[noisy_key]) > 1e-4


def test_make_batch_draws_noise_from_its_generator():
    """pdunet_fan's make_batch: phantoms, then low-dose noise, from the one
    generator (the same seed gives the same batch); the measurement minus
    the clean one has the delta method's variance e^{μp}/(I0·μ²)."""
    task = build_task(_config(get_preset, "pdunet_fan"), device="cpu")
    with torch.no_grad():
        b1 = task.make_batch(torch.Generator().manual_seed(3))
        b2 = task.make_batch(torch.Generator().manual_seed(3))
        clean = task.batch_from_images(b1["image"])
    assert all(torch.equal(b1[k], b2[k]) for k in b1)
    d = b1["sino"] - clean["sino"]
    mu, i0 = tasks.MU_WATER, task.config.train.photons_per_ray
    want = torch.exp(mu * clean["sino"]) / (i0 * mu * mu)
    assert abs(float((d ** 2).mean() / want.mean()) - 1.0) < 0.1
    assert torch.equal(clean["image"], b1["image"])


@pytest.mark.parametrize("case", ["pdunet_fan", "lpd_fan"])
def test_fan_sigma_matches_jax(case, x0_jax):
    """σ from the unroll's own bf16 sparse fan operators, as in JAX."""
    jcfg = _config(jax_get_preset, case)
    _, sparse = jax_tasks.build_geometries(jcfg.geometry)
    from pdunet_tpu.ops.radon.fan import make_fan_ops as jax_fan_ops

    jo = jax_fan_ops(sparse, dtype=jnp.bfloat16)
    sigma_j = jax_tasks.estimate_opnorm(jo.A, jo.At, (N, N))
    ttask = build_task(_config(get_preset, case), device="cpu", opnorm_x0=x0_jax)
    assert abs(ttask.sigma - sigma_j) / sigma_j < 1e-3


def test_fan_geometries_match_jax():
    for case in ("pdunet_fan",):
        gc = _config(get_preset, case).geometry
        for j, t in zip(jax_tasks.build_geometries(gc), tasks.build_geometries(gc)):
            assert dataclasses.asdict(j) == dataclasses.asdict(t)
    with pytest.raises(ValueError, match="fan"):
        build_task(get_preset("sino_unet_parallel").override({"geometry.kind": "fan"}),
                   device="cpu")


# -- the radial sino task's contracts ---------------------------------------------

def test_radial_sino_keeps_the_measured_spokes_and_takes_a_pair():
    """Hard data consistency in the net domain: the rows of the measured
    golden-angle prefix are k_in_w's (and, noiseless, k_dense_w's), whatever
    the UNet puts out; a (re, im) pair synthesises the same batch."""
    task = build_task(_config(get_preset, "sino_unet_radial", **{"model.use_bfloat16": False}),
                      device="cpu")
    with torch.no_grad():
        for p in task.model.parameters():
            p.add_(0.1)
        batch = task.make_batch(torch.Generator().manual_seed(3))
        pair = task.batch_from_images((batch["image_c"].real, batch["image_c"].imag))
        _, aux = task.loss_fn(task.model, batch)
    for k in batch:
        assert torch.equal(batch[k], pair[k]), k
    dense, sparse = tasks.build_geometries(task.config.geometry)
    phi = np.asarray(dense.spoke_angles) % (2 * np.pi)
    measured = np.argsort(phi % np.pi, kind="stable") < sparse.n_spokes
    kin, kd = batch["k_in_w"], batch["k_dense_w"]
    assert batch["image"].shape == (2, N, N) and kin.shape == kd.shape == (2, 40, 48)
    torch.testing.assert_close(kin[:, measured], kd[:, measured], rtol=1e-5, atol=1e-6)
    assert float((kin[:, ~measured] - kd[:, ~measured]).abs().max()) > 1e-3
    assert set(aux) == {"sino_loss", "img_loss"}


def test_two_channel_unet_converts_from_flax():
    """The bare-UNet path of the converter loads the radial sino task's
    2-in / 2-out UNet: the same output as flax on the same input."""
    fm = FlaxUNet(out_channels=2, base_features=8, depth=2, stem=2)
    x = np.random.default_rng(4).standard_normal((2, 40, 48, 2)).astype(np.float32)
    params = fm.init(jax.random.PRNGKey(1), jnp.zeros((1, 40, 48, 2)))["params"]
    ref = np.asarray(fm.apply({"params": params}, jnp.asarray(x)))
    tm = UNet(in_channels=2, out_channels=2, base_features=8, depth=2, stem=2, device="cpu")
    flax_to_torch(_tree_np(params), tm)
    with torch.no_grad():
        out = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    assert _rel(out, ref) < 1e-5


# -- training against JAX --------------------------------------------------------

#: tests/test_torch_train.py's STEP_TOL
STEP_TOL = {"loss": 1e-5, "grad_norm": 2e-5, "delta": 5e-5}


@pytest.mark.parametrize("preset", PRESETS)
def test_f32_train_step_matches_jax(preset, x0_jax, monkeypatch):
    """Three from_images steps from the same flax init and images, warmup 2,
    the preset's grad_clip, against JAX's make_train_step (pdunet_fan's
    low-dose noise on JAX's draws of each step's key): loss, gradient
    norm, sino_unet's aux terms, and the parameters' change."""
    over = {"model.use_bfloat16": False, "train.warmup_steps": 2,
            "train.learning_rate": 1e-3}
    jtask, ttask, params0 = _pair(preset, over, x0_jax)
    jstate = jax_loop.build_state(jtask, params=params0, n_steps=3)
    jstep = jax_loop.make_train_step(jtask, donate=False, from_images=True)
    tstate = loop.build_state(ttask, n_steps=3)
    tstep = loop.make_train_step(ttask, from_images=True)
    draws = []
    _feed_jax_normals(monkeypatch, draws)
    noisy = ttask.config.train.photons_per_ray > 0
    _, sparse = tasks.build_geometries(ttask.config.geometry)
    p0 = [p.detach().clone() for p in ttask.model.parameters()]
    for i in range(3):
        jimg, timg = _images(jtask, jax.random.PRNGKey(20 + i))
        key = jax.random.PRNGKey(i)
        jstate, jm = jstep(jstate, key, jimg)
        if noisy:
            draws.append(_jax_normal(key, (2, sparse.n_angles, sparse.det_count), False))
        tm = tstep(tstate, timg, generator=torch.Generator())
        assert not draws
        assert set(tm) == set(jm)
        for k in tm:
            err = abs(float(tm[k]) - float(jm[k])) / abs(float(jm[k]))
            assert err < STEP_TOL.get(k, STEP_TOL["loss"]), (i, k, err)
    d_model = copy.deepcopy(ttask.model)
    flax_to_torch(jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                         jstate.params, params0), d_model)
    d_jax = np.concatenate([p.detach().double().numpy().ravel() for p in d_model.parameters()])
    d_port = np.concatenate([(p.detach() - q).double().numpy().ravel()
                             for p, q in zip(ttask.model.parameters(), p0)])
    assert np.linalg.norm(d_jax) > 0 and _rel(d_port, d_jax) < STEP_TOL["delta"]


def _golden_config_of_the_jax_tests():
    spec = importlib.util.spec_from_file_location("_jax_goldens", TESTS / "test_goldens.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.golden_config


def _golden_over(preset):
    """tests/test_goldens.py's golden_config as overrides: 32², 40 angles
    (radial: spokes of 48 samples) kept 4× sparse, base 8, depth 1, 2
    iterations, batch 2, lr 2e-3, warmup 10, 100 steps, 4 ellipses."""
    over = {"geometry.image_size": 32, "geometry.n_angles": 40, "geometry.sparsity": 4,
            "model.base_features": 8, "model.depth": 1, "model.n_iters": 2,
            "train.batch_size": 2, "train.learning_rate": 2e-3, "train.warmup_steps": 10,
            "train.steps": 100, "train.log_every": 50, "train.eval_every": 1000,
            "train.seed": 0, "train.n_ellipses": 4}
    if preset == "sino_unet_radial":
        over["geometry.samples_per_spoke"] = 48
    return over


#: tests/test_goldens.py's tolerances
TOL_DB, TOL_SSIM = 0.6, 0.02


@pytest.mark.parametrize("preset", PRESETS)
def test_golden_run_from_jax_draws(preset, monkeypatch):
    """The reference's golden mini-training with JAX's init key, JAX's batch
    for every step (fold_in(data_key, i)) and JAX's validation batches,
    noise included (make_batch splits each key; the second half draws the
    low-dose noise), through the port's train step and eval: within the
    goldens' tolerances of tests/goldens.json."""
    jcfg = jax_get_preset(preset).override(_golden_over(preset))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(
        _golden_config_of_the_jax_tests()(preset))
    tcfg = get_preset(preset).override(_golden_over(preset))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    tc = jcfg.train
    jtask = jax_tasks.build_task(jcfg)
    ttask = build_task(tcfg, device="cpu")
    key = jax.random.PRNGKey(tc.seed)
    _, init_key, data_key, val_key = jax.random.split(key, 4)
    flax_to_torch(_tree_np(jtask.init_params(init_key)), ttask.model)
    state = loop.build_state(ttask, n_steps=tc.steps)
    step = loop.make_train_step(ttask, from_images=True)
    draws = []
    _feed_jax_normals(monkeypatch, draws)
    noisy = tc.photons_per_ray > 0
    _, sparse = tasks.build_geometries(tcfg.geometry)
    gen = torch.Generator() if noisy else None

    def images(k):
        if noisy:
            draws.append(_jax_normal(jax.random.split(k)[1],
                                     (2, sparse.n_angles, sparse.det_count), False))
        return _images(jtask, k)[1]

    for i in range(tc.steps):
        step(state, images(jax.random.fold_in(data_key, i)), generator=gen)
    assert not draws
    evaluate = loop.make_eval_step(ttask)
    n_val = max(1, -(-tc.val_slices // tc.batch_size))
    sums = {"psnr": 0.0, "ssim": 0.0}
    for j in range(n_val):
        with torch.no_grad():
            batch = ttask.batch_from_images(images(jax.random.fold_in(val_key, j)), gen)
        for k, v in evaluate(ttask.model, batch).items():
            sums[k] += float(v) / n_val
    want = json.loads((TESTS / "goldens.json").read_text())[preset]
    print(f"{preset} golden from JAX draws: {sums} vs {want}")
    assert abs(sums["psnr"] - want["psnr"]) < TOL_DB, (sums, want)
    assert abs(sums["ssim"] - want["ssim"]) < TOL_SSIM, (sums, want)


# -- the loop and the entry points -----------------------------------------------

@pytest.mark.parametrize("preset", PRESETS)
def test_train_infer_and_bench_on_cpu(preset, tmp_path):
    """train(): metrics (sino_unet_radial's aux terms too), validation and
    the best checkpoint; infer restores it; bench --preset-recon times the
    recon (the radial sino task's carry is k_in_w) and bench's train row
    times a step."""
    cfg = _config(get_preset, preset)
    config = cfg.override({
        "train.log_every": 1, "train.eval_every": 2, "train.val_slices": 2,
        "train.ckpt_dir": str(tmp_path / "ck"), "train.ckpt_every": 2})
    metrics = tmp_path / "m.jsonl"
    res = loop.train(config, steps=4, metrics_path=str(metrics), verbose=False, device="cpu")
    lines = [json.loads(s) for s in metrics.read_text().splitlines()]
    steps = [ln for ln in lines if "loss" in ln]
    evals = [ln for ln in lines if "psnr" in ln]
    assert [ln["step"] for ln in steps] == [1, 2, 3, 4] and [e["step"] for e in evals] == [2, 4]
    aux = {"sino_loss", "img_loss"} if preset == "sino_unet_radial" else set()
    assert all(aux <= set(ln) and np.isfinite(ln["loss"]) for ln in steps)
    best = json.loads((tmp_path / "ck" / "best.json").read_text())
    assert best["psnr"] == max(e["psnr"] for e in evals)
    assert np.isfinite(res.final_eval["psnr"]) and res.state.step == 4
    flags = [a for k, v in (("geometry.image_size", N), ("geometry.n_angles", 40),
                            ("model.base_features", 8), ("model.depth", 2),
                            ("model.n_iters", 2))
             for a in ("--set", f"{k}={v}")]
    if preset == "sino_unet_radial":
        flags += ["--set", "geometry.samples_per_spoke=48"]
    out = tmp_path / "infer.json"
    rc = infer.main(["--preset", preset, "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck"),
                     "--ckpt", "best", "--batch", "2", "--n-slices", "2", "--json-out",
                     str(out), *flags])
    table = json.loads(out.read_text())
    assert rc == 0 and table["ckpt_step"] == best["step"] and np.isfinite(table["psnr_mean"])
    assert preset in infer.PORTED and bench.MATRIX_BATCH[preset] == {
        "pdunet_fan": 128, "sino_unet_radial": 64}[preset]
    row = bench.bench_preset_recon(preset, 2, image_size=N, n_angles=40, device="cpu")
    assert row["preset"] == preset and row["recon_slices_per_sec"] > 0
    train_row = bench.bench_train(cfg, 2, device="cpu")
    assert train_row["step_sec"] > 0 and set(train_row["split"]) == {
        "synthesis_sec", "forward_sec", "backward_sec", "optimizer_sec"}
