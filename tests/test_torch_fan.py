"""The port's fan-beam geometry and operators (pdunet_tpu_torch/geometry.py
FanGeometry, ops/radon/fan.py) and its noise and spoke transforms
(data/pipeline.py) against the JAX package.

Fan plans: a limited-angle scan (the pdunet_fan preset's 0.75·2π coverage,
4× sparse) and a full-circle one, at 32² with 40 views. Their backing
plans span angles beyond [0, π), negative ones included, and pair θ with
−θ or 2π − θ (sign +1) as well as with π − θ (sign −1). Operators:
1e-5 relative in float32, 5e-3 with bf16 operands (the tolerances of
tests/test_pallas_kernels.py). The noise functions are held elementwise on
JAX's own normal draw and by their moments on the port's draws. The
kernels run only on a card: chip_smoke.py holds them on these plans'
full-size twins there."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.data import pipeline as jax_pipeline
from pdunet_tpu.geometry import GOLDEN_ANGLE
from pdunet_tpu.geometry import FanGeometry as JaxFan
from pdunet_tpu.geometry import RadialGeometry as JaxRadial
from pdunet_tpu.ops.radon import fan as jax_fan
from pdunet_tpu_torch.data import pipeline
from pdunet_tpu_torch.geometry import FanGeometry, RadialGeometry
from pdunet_tpu_torch.ops import radon
from pdunet_tpu_torch.ops.radon import fan

torch.set_num_threads(1)

N = 32
#: the pdunet_fan preset's views at 32²: 40 over 0.75·2π, kept 4× sparse
LIMITED = dict(image_size=N, angles=tuple(0.75 * 2.0 * math.pi * k / 40 for k in range(40))[::4])
FULL = dict(image_size=N, n_angles=40)
SCANS = {"limited": LIMITED, "full": FULL}
_BF16 = [(False, 1e-5), (True, 5e-3)]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ops(kw, bf16):
    jo = jax_fan.make_fan_ops(JaxFan(**kw), dtype=jnp.bfloat16 if bf16 else jnp.float32)
    to = fan.make_fan_ops(FanGeometry(**kw), dtype=torch.bfloat16 if bf16 else torch.float32,
                          device="cpu")
    return jo, to


@pytest.fixture(scope="module")
def ops_cache():
    return {}


def _cached(cache, scan, bf16):
    if (scan, bf16) not in cache:
        cache[(scan, bf16)] = _ops(SCANS[scan], bf16)
    return cache[(scan, bf16)]


# -- geometry and plan ------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(image_size=N, n_angles=40),
    dict(image_size=N, n_angles=12, source_distance=100.0, det_distance=50.0, det_count=80),
    dict(image_size=N, n_angles=9, det_spacing=1.5, pixel_spacing=0.5),
], ids=["defaults", "distances", "spacings"])
def test_fan_geometry_matches_jax(kw):
    """Defaults (source 2N, detector distance = source, 2N detector bins,
    magnification-scaled spacing, views over [0, 2π)) and subsample."""
    j, t = JaxFan(**kw), FanGeometry(**kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(t.subsample(3)) == dataclasses.asdict(j.subsample(3))


@pytest.mark.parametrize("scan", SCANS)
def test_fan_plan_matches_jax(scan):
    """Every fan plan array and meta, and the backing parallel plan: its
    arrays, meta and pair arrays (ia/ib by way of the take rows, sgn, msk),
    with sign +1 pairs among them."""
    jp = jax_fan.build_fan_plan(JaxFan(**SCANS[scan]))
    tp = fan.build_fan_plan(FanGeometry(**SCANS[scan]), device="cpu")
    assert tp.meta == jp.meta
    for name in fan.FanPlan.ARRAYS:
        a, b = getattr(tp, name), np.asarray(getattr(jp, name))
        assert tuple(a.shape) == b.shape, name
        np.testing.assert_array_equal(a.numpy(), b.astype(a.numpy().dtype), err_msg=name)
    jpp, tpp = jp.par_plan, tp.par_plan
    assert tpp.meta == {k: v for k, v in jpp.meta.items() if k in tpp.meta}
    angles = np.asarray(tpp.geom.angles)
    assert angles.min() < 0 and angles.max() > math.pi
    for name in tpp.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tpp, name).numpy(),
                                      np.asarray(getattr(jpp, name), np.float32), err_msg=name)
    plus = sum(int(((getattr(tpp, f"pair_sgn_{g}") > 0) & (getattr(tpp, f"pair_msk_{g}") > 0))
                   .sum()) for g in "xy")
    assert tpp.meta["use_pairs"] and plus > 0


def test_fan_plan_bf16_weights_rounded_as_jax():
    """The bf16 plan's rebinning weights hold JAX's bf16 values (as f32)."""
    jp = jax_fan.build_fan_plan(JaxFan(**LIMITED), dtype=jnp.bfloat16)
    tp = fan.build_fan_plan(FanGeometry(**LIMITED), dtype=torch.bfloat16, device="cpu")
    for name in ("Ms", "Mu", "cf", "df", "wrow"):
        np.testing.assert_array_equal(
            getattr(tp, name).numpy(), np.asarray(getattr(jp, name), np.float32), err_msg=name)
    assert tp.par_plan.meta["compute_dtype"] == "bfloat16"


def test_full_circle_too_sparse_raises():
    with pytest.raises(ValueError, match="too sparse"):
        jax_fan.build_fan_plan(JaxFan(image_size=N, n_angles=8))
    with pytest.raises(ValueError, match="too sparse"):
        fan.build_fan_plan(FanGeometry(image_size=N, n_angles=8), device="cpu")


# -- the banded rebinning -----------------------------------------------------------

@pytest.mark.parametrize("which", ["fwd", "rebin"])
@pytest.mark.parametrize("scan", SCANS)
def test_band_weights_match_jax_and_are_built_once(scan, which):
    jp = jax_fan.build_fan_plan(JaxFan(**SCANS[scan]))
    tp = fan.build_fan_plan(FanGeometry(**SCANS[scan]), device="cpu")
    m = jp.meta
    if which == "fwd":
        ref = jax_fan._band_weights(jp.c0, jp.cf, m["n_beta"], m["n_ext"], m["pad_beta"],
                                    jnp.float32)
    elif m["full_circle"]:
        ref = jax_fan._band_weights(jp.d0 + m["pad_ext"], jp.df, m["n_ext"],
                                    m["n_beta"] + 2 * m["pad_ext"], 2, jnp.float32)
    else:
        ref = jax_fan._band_weights(jp.d0, jp.df, m["n_ext"], m["n_beta"], m["pad_ext"],
                                    jnp.float32)
    W = tp.band(which, torch.float32)
    np.testing.assert_array_equal(W.numpy(), np.asarray(ref))
    assert tp.band(which, torch.float32) is W and tp.band_builds == 1


def test_gather_and_scatter_are_exact_transposes():
    tp = fan.build_fan_plan(FanGeometry(**LIMITED), device="cpu")
    m = tp.meta
    W = tp.band("fwd", torch.float64)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, m["n_ext"], m["n_u"], generator=g, dtype=torch.float64)
    y = torch.randn(3, m["n_beta"], m["n_u"], generator=g, dtype=torch.float64)
    lhs = torch.vdot(fan._gather_rows(x, W, m["pad_beta"]).flatten(), y.flatten())
    rhs = torch.vdot(x.flatten(), fan._scatter_rows_T(y, W, m["n_ext"], m["pad_beta"]).flatten())
    assert abs(float(lhs - rhs)) < 1e-12 * abs(float(lhs))
    # against the 2-tap gather it stands for
    out = fan._gather_rows(x, W, m["pad_beta"])
    xp = torch.nn.functional.pad(x, (0, 0, m["pad_beta"], m["pad_beta"]))
    k = torch.arange(m["n_beta"])[:, None] + tp.c0[None, :] + m["pad_beta"]
    u = torch.arange(m["n_u"])[None, :]
    cf = tp.cf.double()
    ref = (1 - cf) * xp[:, k, u] + cf * xp[:, k + 1, u]
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-12)


# -- the operators --------------------------------------------------------------------

@pytest.mark.parametrize("op", ["A", "At", "fbp"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
@pytest.mark.parametrize("scan", SCANS)
def test_fan_operators_match_jax(ops_cache, scan, bf16, tol, op):
    """A, A† and FBP (the full-circle scan through the periodic-wrap rebin,
    the limited-angle one through the zero-padded one)."""
    jo, to = _cached(ops_cache, scan, bf16)
    rng = np.random.default_rng(1)
    shape = (2, N, N) if op == "A" else (2,) + to.sino_shape
    x = rng.standard_normal(shape).astype(np.float32)
    out = getattr(to, op)(torch.from_numpy(x))
    ref = getattr(jo, op)(jnp.asarray(x))
    assert out.dtype == torch.float32 and tuple(out.shape) == ref.shape
    assert rel(out, ref) < tol


@pytest.mark.parametrize("scan", SCANS)
def test_fan_dot_test(ops_cache, scan):
    """<A x, y> = <x, A† y> in float32 (y = A x plus noise of its norm, so
    the products are not near zero)."""
    _, to = _cached(ops_cache, scan, False)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, N, N, generator=g)
    ax = to.A(x)
    y = torch.randn(ax.shape, generator=g)
    y = ax + y * ax.norm() / y.norm()
    lhs = torch.vdot(ax.double().flatten(), y.double().flatten())
    rhs = torch.vdot(x.double().flatten(), to.At(y).double().flatten())
    assert abs(float(lhs - rhs)) / abs(float(lhs)) < 1e-5


@pytest.mark.parametrize("scan", SCANS)
def test_fan_vjps_pair_exactly(ops_cache, scan):
    """vjp(A) = A† and vjp(A†) = A, through the autograd Functions."""
    _, to = _cached(ops_cache, scan, False)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, N, N, generator=g, requires_grad=True)
    ct = torch.randn((2,) + to.sino_shape, generator=g)
    (gx,) = torch.autograd.grad(to.A(x), x, ct)
    torch.testing.assert_close(gx, to.At(ct), rtol=0, atol=0)
    p = ct.clone().requires_grad_(True)
    ci = torch.randn(2, N, N, generator=g)
    (gp,) = torch.autograd.grad(to.At(p), p, ci)
    torch.testing.assert_close(gp, to.A(ci), rtol=0, atol=0)


def test_fan_vjps_match_jax():
    """The gradients themselves against JAX's custom_vjp, float32."""
    jo, to = _ops(LIMITED, False)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, N, N)).astype(np.float32)
    ct = rng.standard_normal((2,) + to.sino_shape).astype(np.float32)
    _, vjp = jax.vjp(jo.A, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (gx,) = torch.autograd.grad(to.A(xt), xt, torch.from_numpy(ct))
    assert rel(gx, vjp(jnp.asarray(ct))[0]) < 1e-5


def test_fan_fbp_reconstructs_and_exports():
    """The fan FBP of a full-circle scan recovers a disc (a sanity check of
    the weights beside the JAX match), and the names are exported."""
    to = fan.make_fan_ops(FanGeometry(image_size=N, n_angles=90), device="cpu")
    yy, xx = torch.meshgrid(torch.arange(N) - (N - 1) / 2, torch.arange(N) - (N - 1) / 2,
                            indexing="ij")
    disc = ((xx ** 2 + yy ** 2) < (N / 4) ** 2).float()[None]
    rec = to.fbp(to.A(disc))
    inner = ((xx ** 2 + yy ** 2) < (N / 6) ** 2)
    assert abs(float(rec[0][inner].mean()) - 1.0) < 0.05
    for name in ("FanPlan", "build_fan_plan", "fan_project", "fan_backproject",
                 "fan_rebin_to_parallel", "make_fan_ops"):
        assert getattr(radon, name) is getattr(fan, name)


# -- noise --------------------------------------------------------------------------

def test_lowdose_poisson_noise_matches_jax_on_its_draw():
    key = jax.random.PRNGKey(5)
    sino = np.abs(np.random.default_rng(5).standard_normal((2, 10, 64))).astype(np.float32)
    ref = jax_pipeline.lowdose_poisson_noise(key, jnp.asarray(sino) * 0.02, 1e5)
    z = np.array(jax.random.normal(key, sino.shape))
    out = pipeline.lowdose_poisson_noise(None, torch.from_numpy(sino) * 0.02, 1e5,
                                         normal=torch.from_numpy(z))
    # −log(I/I0) of counts near 1e5: one float32 ulp of I is 6e-8 of the log
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=5e-7)
    assert rel(out, ref) < 1e-5
    # a very low dose clamps the count at one photon, as in JAX
    ref = jax_pipeline.lowdose_poisson_noise(key, jnp.asarray(sino) * 3, 10.0)
    out = pipeline.lowdose_poisson_noise(None, torch.from_numpy(sino) * 3, 10.0,
                                         normal=torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_lowdose_poisson_noise_moments():
    """On the port's own draws: mean −log(e^{−p}) = p and variance
    e^{p}/I0 (the delta method), at p = 0.5, I0 = 1e4."""
    p = torch.full((200_000,), 0.5)
    out = pipeline.lowdose_poisson_noise(torch.Generator().manual_seed(6), p, 1e4)
    assert abs(float(out.mean()) - 0.5) < 1e-3
    assert abs(float(out.var()) / (math.exp(0.5) / 1e4) - 1.0) < 0.02
    again = pipeline.lowdose_poisson_noise(torch.Generator().manual_seed(6), p, 1e4)
    assert torch.equal(out, again)


@pytest.mark.parametrize("snr_db", [10.0, 25.0])
def test_kspace_gaussian_noise_matches_jax_on_its_draw(snr_db):
    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(7)
    k = (rng.standard_normal((2, 10, 48)) + 1j * rng.standard_normal((2, 10, 48))).astype(
        np.complex64)
    ref = jax_pipeline.kspace_gaussian_noise(key, jnp.asarray(k), snr_db)
    z = np.array(jax.random.normal(key, k.shape, dtype=jnp.complex64))
    out = pipeline.kspace_gaussian_noise(None, torch.from_numpy(k), snr_db,
                                         normal=torch.from_numpy(z))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_kspace_gaussian_noise_moments_and_off_switch():
    """On the port's draws: the noise power is RMS(|g|)²·10^(−snr/10) per
    slice, split evenly between Re and Im; snr ≤ 0 returns the data."""
    g = torch.Generator().manual_seed(8)
    k = torch.randn(2, 64, 512, generator=g, dtype=torch.complex64)
    k[1] *= 3.0
    out = pipeline.kspace_gaussian_noise(torch.Generator().manual_seed(9), k, 20.0)
    n = out - k
    for b in range(2):
        want = float((k[b].abs() ** 2).mean()) * 10 ** (-2.0)
        assert abs(float((n[b].abs() ** 2).mean()) / want - 1.0) < 0.02
        assert abs(float(n[b].real.var()) / float(n[b].imag.var()) - 1.0) < 0.03
    assert pipeline.kspace_gaussian_noise(None, k, 0.0) is k
    assert pipeline.MU_WATER == jax_pipeline.MU_WATER


# -- spokes -------------------------------------------------------------------------

def test_reverse_spoke_samples_matches_jax():
    x = np.random.default_rng(10).standard_normal((2, 5, 48)).astype(np.float32)
    out = pipeline.reverse_spoke_samples(torch.from_numpy(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(jax_pipeline.reverse_spoke_samples(
        jnp.asarray(x))))
    # an involution that keeps the lone −k_max sample in place
    assert torch.equal(pipeline.reverse_spoke_samples(out), torch.from_numpy(x))
    assert torch.equal(out[..., 0], torch.from_numpy(x)[..., 0])


@pytest.mark.parametrize("n_dense,factor", [(40, 4), (512, 4), (30, 3)])
def test_interp_upsample_spokes_matches_jax(n_dense, factor):
    """Golden-angle prefixes onto the dense spoke set: exact hits pass
    through, and the wraps across π reverse the readout."""
    jd = JaxRadial(image_size=N, n_spokes=n_dense, samples_per_spoke=48)
    td = RadialGeometry(image_size=N, n_spokes=n_dense, samples_per_spoke=48)
    assert td.spoke_angles == jd.spoke_angles
    js, ts = jd.subsample(factor), td.subsample(factor)
    rng = np.random.default_rng(n_dense)
    k = (rng.standard_normal((2, js.n_spokes, 48))
         + 1j * rng.standard_normal((2, js.n_spokes, 48))).astype(np.complex64)
    ref = jax_pipeline.interp_upsample_spokes(jnp.asarray(k), js.spoke_angles, jd.spoke_angles)
    out = pipeline.interp_upsample_spokes(torch.from_numpy(k), ts.spoke_angles,
                                          td.spoke_angles)
    assert out.dtype == torch.complex64 and tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)
    # the measured prefix passes through unchanged
    np.testing.assert_array_equal(out[:, :ts.n_spokes].numpy(), k)
    assert GOLDEN_ANGLE == pytest.approx(td.angle_increment)
