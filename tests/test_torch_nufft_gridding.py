"""The port's Kaiser-Bessel gridding NUFFT (pdunet_tpu_torch/ops/nufft/nufft.py
and make_radial_ops(impl="gridding")) against the JAX package, at 32² with
24 golden-angle spokes of an odd 63-sample readout (the case the
fourier-slice path cannot take).

Tolerances: operators ≤ 1e-5 relative L2 against JAX and against the
float64 numpy twins (as tests/test_nufft.py), dot test ≤ 1e-5, the
odd-readout fallback ≤ 1e-6 from impl="gridding" (the same computation),
the cut-down pdunet_radial recon ≤ 1e-4 against JAX's (f32 unroll, as
tests/test_torch_radial_task.py).
"""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.configs import get_preset as jax_get_preset
from pdunet_tpu.geometry import RadialGeometry as JaxRadial
from pdunet_tpu.ops.nufft import nufft as jax_nufft
from pdunet_tpu.training import tasks as jax_tasks
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.geometry import RadialGeometry
from pdunet_tpu_torch.models.convert import flax_to_torch
from pdunet_tpu_torch.ops.nufft import dcf, make_radial_ops
from pdunet_tpu_torch.ops.nufft.nufft import build_nufft_plan, nufft_adjoint, nufft_forward
from pdunet_tpu_torch.training.tasks import build_task

torch.set_num_threads(1)

N = 32
GEOM = dict(image_size=N, n_spokes=24, samples_per_spoke=63)


def rel(a, b):
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def plans():
    return (jax_nufft.build_nufft_plan(JaxRadial(**GEOM)),
            build_nufft_plan(RadialGeometry(**GEOM), device="cpu"))


def test_plan_matches_jax(plans):
    jp, tp = plans
    assert tp.meta == jp.meta
    np.testing.assert_array_equal(tp.idx.numpy(), np.asarray(jp.idx))
    np.testing.assert_array_equal(tp.w.numpy(), np.asarray(jp.w))
    np.testing.assert_array_equal(tp.apod2d.numpy(), np.asarray(jp.apod2d))
    np.testing.assert_array_equal(tp.dcf.numpy(), np.asarray(jp.dcf))
    # the segment tables: the taps in grid-cell order, each cell's count
    idx = tp.idx.numpy()
    order = np.argsort(idx, kind="stable")
    G, J = tp.meta["G"], tp.meta["J"]
    np.testing.assert_array_equal(tp.seg_point.numpy(), order // (J * J))
    np.testing.assert_array_equal(tp.seg_w.numpy(), tp.w.numpy().ravel()[order])
    np.testing.assert_array_equal(idx[order], np.repeat(np.arange(G * G), tp.seg_len.numpy()))


@pytest.mark.parametrize("batch", [(), (3,), (2, 2)], ids=["single", "B3", "B2x2"])
def test_forward_adjoint_match_jax(plans, batch):
    jp, tp = plans
    rng = np.random.default_rng(1)
    x = _cplx(rng, batch + (N, N))
    k = _cplx(rng, batch + (24, 63))
    fx = nufft_forward(tp, torch.from_numpy(x))
    assert fx.dtype == torch.complex64 and fx.shape == batch + (24, 63)
    assert rel(fx, jax_nufft.nufft_forward(jp, jnp.asarray(x))) < 1e-5
    ak = nufft_adjoint(tp, torch.from_numpy(k))
    assert ak.dtype == torch.complex64 and ak.shape == batch + (N, N)
    assert rel(ak, jax_nufft.nufft_adjoint(jp, jnp.asarray(k))) < 1e-5


def test_numpy_twins_match(plans):
    """dcf._np_nufft_forward / _np_nufft_adjoint (float64, the Pipe-Menon
    solver's) against the port's device path."""
    _, tp = plans
    T = dcf._plan_tables(RadialGeometry(**GEOM))
    rng = np.random.default_rng(2)
    x = _cplx(rng, (N, N))
    k = _cplx(rng, (24, 63))
    assert rel(nufft_forward(tp, torch.from_numpy(x)), dcf._np_nufft_forward(T, x)) < 1e-5
    assert rel(nufft_adjoint(tp, torch.from_numpy(k)), dcf._np_nufft_adjoint(T, k)) < 1e-5


def test_dot_test_and_repeatable_adjoint(plans):
    _, tp = plans
    rng = np.random.default_rng(3)
    x = torch.from_numpy(_cplx(rng, (2, N, N)))
    y = torch.from_numpy(_cplx(rng, (2, 24, 63)))
    lhs = torch.vdot(nufft_forward(tp, x).flatten().to(torch.complex128),
                     y.flatten().to(torch.complex128))
    rhs = torch.vdot(x.flatten().to(torch.complex128),
                     nufft_adjoint(tp, y).flatten().to(torch.complex128))
    assert float(abs(lhs - rhs) / abs(lhs)) < 1e-5
    # the segment sum adds each cell's taps in one order
    assert torch.equal(nufft_adjoint(tp, y), nufft_adjoint(tp, y))


def test_adjoint_equals_index_add(plans):
    """The sorted segment sum is the scatter-add of the reference."""
    _, tp = plans
    k = torch.from_numpy(_cplx(np.random.default_rng(4), (2, 24, 63)))
    G = tp.meta["G"]
    contrib = (k.reshape(2, -1, 1) * tp.w).reshape(2, -1)
    grid = torch.zeros(2, G * G, dtype=torch.complex64).index_add_(1, tp.idx, contrib)
    f = torch.fft.fftshift(torch.fft.ifft2(torch.fft.ifftshift(
        grid.reshape(2, G, G), dim=(-2, -1))), dim=(-2, -1)) * G * G
    lo = G // 2 - N // 2
    ref = f[:, lo:lo + N, lo:lo + N] / tp.apod2d
    assert rel(nufft_adjoint(tp, k), ref) < 1e-6


@pytest.mark.parametrize("op", ["A", "At"])
def test_vjp_pairs(op):
    """PyTorch's gradient of the C-linear A is A^H applied to the incoming
    gradient, and of A† is A (no conjugations); real inputs get the real part."""
    ops = make_radial_ops(RadialGeometry(**GEOM), impl="gridding", device="cpu")
    rng = np.random.default_rng(5)
    fwd, back = (ops.A, ops.At) if op == "A" else (ops.At, ops.A)
    shape_in = (2, N, N) if op == "A" else (2, 24, 63)
    x = torch.from_numpy(_cplx(rng, shape_in)).requires_grad_()
    out = fwd(x)
    g = torch.from_numpy(_cplx(rng, tuple(out.shape)))
    (grad,) = torch.autograd.grad(out, x, g)
    assert rel(grad.detach(), back(g)) < 1e-6
    xr = torch.from_numpy(rng.standard_normal(shape_in).astype(np.float32)).requires_grad_()
    (grad_r,) = torch.autograd.grad(fwd(xr), xr, g)
    assert grad_r.dtype == torch.float32 and rel(grad_r, back(g).real) < 1e-6


def test_odd_readout_warns_and_falls_back():
    geom = RadialGeometry(**GEOM)
    with pytest.warns(UserWarning, match="even samples_per_spoke"):
        ops = make_radial_ops(geom, dtype=torch.bfloat16, device="cpu")
    grid = make_radial_ops(geom, impl="gridding", device="cpu")
    assert type(ops.plan).__name__ == "NufftPlan"
    assert ops.sino_shape == (24, 63) and ops.image_shape == (N, N)
    rng = np.random.default_rng(6)
    x = torch.from_numpy(_cplx(rng, (2, N, N)))
    k = torch.from_numpy(_cplx(rng, (2, 24, 63)))
    # complex64 whatever the dtype asked for
    assert ops.A(x).dtype == torch.complex64
    assert rel(ops.A(x), grid.A(x)) <= 1e-6
    assert rel(ops.At(k), grid.At(k)) <= 1e-6
    assert rel(ops.fbp(k), grid.fbp(k)) <= 1e-6
    jops = jax_nufft.make_radial_ops(JaxRadial(**GEOM), impl="gridding")
    assert rel(grid.fbp(k), jops.fbp(jnp.asarray(k.numpy()))) < 1e-5
    np.testing.assert_array_equal(grid.dcf.numpy(), np.asarray(jops.dcf))
    with pytest.raises(ValueError, match="unknown NUFFT impl"):
        make_radial_ops(geom, impl="nudft", device="cpu")


def test_plan_is_cached_per_geometry():
    geom = RadialGeometry(**GEOM)
    assert build_nufft_plan(geom, device="cpu") is build_nufft_plan(geom, device="cpu")
    assert build_nufft_plan(geom, dcf="voronoi_ramp", device="cpu") is not \
        build_nufft_plan(geom, device="cpu")


def _small(config):
    """pdunet_radial cut to test size with an odd readout: 32², 96 spokes
    kept 4× sparse (24) of 63 samples, base 8, depth 2, stem 2, 2
    iterations, batch 2, float32."""
    return config.override({
        "geometry.image_size": 32, "geometry.n_angles": 96,
        "geometry.samples_per_spoke": 63, "model.base_features": 8, "model.depth": 2,
        "model.stem": 2, "model.n_iters": 2, "train.batch_size": 2,
        "model.use_bfloat16": False,
    })


def test_odd_readout_radial_task_matches_jax():
    """pdunet_radial with an odd readout builds on the gridding operators in
    both packages: σ, the f32 synthesis and DCF adjoint, and the recon with
    the flax weights carried across, for the same complex image."""
    jcfg = _small(jax_get_preset("pdunet_radial"))
    tcfg = _small(get_preset("pdunet_radial"))
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    x0 = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (N, N)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        jtask = jax_tasks.build_task(jcfg)
        ttask = build_task(tcfg, device="cpu", opnorm_x0=x0)
        _, sparse = jax_tasks.build_geometries(jcfg.geometry)
        jo = jax_nufft.make_radial_ops(sparse)
    sigma_j = jax_tasks.estimate_opnorm(jo.A, jo.At, (N, N), is_complex=True)
    assert abs(ttask.sigma - sigma_j) / sigma_j < 1e-5

    rng = np.random.default_rng(9)
    mag = np.abs(rng.standard_normal((2, N, N))).astype(np.float32)
    phase = rng.uniform(-np.pi, np.pi, (2, N, N)).astype(np.float32)
    re, im = (mag * np.cos(phase)).astype(np.float32), (mag * np.sin(phase)).astype(np.float32)
    jbatch = jtask.batch_from_images((jnp.asarray(re), jnp.asarray(im)))
    tbatch = ttask.batch_from_images((torch.from_numpy(re), torch.from_numpy(im)))
    assert tbatch["sino"].shape == (2, 24, 63)
    assert rel(tbatch["sino"], jbatch["sino"]) < 1e-5
    assert rel(tbatch["f0"], jbatch["f0"]) < 1e-5

    params = jtask.init_params(jax.random.PRNGKey(0))
    ref = np.asarray(jtask.recon_fn(params, jbatch))
    flax_to_torch(jax.tree_util.tree_map(np.asarray, params), ttask.model)
    with torch.no_grad():
        out = ttask.recon_fn(ttask.model, tbatch)
    assert out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < 1e-4
