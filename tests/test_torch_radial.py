"""The port's radial MRI operators (pdunet_tpu_torch/ops/nufft and the
per-angle projector they run on) against the JAX package, at 32² with 24
golden-angle spokes (64 samples). The complex PD-UNet and the pdunet_radial
task are in tests/test_torch_radial_task.py.

On the CPU the per-angle kernel wrappers run their plain versions; those
are held against the JAX einsum twins (_project_group / _backproject_group)
to 1e-5 relative in float32 and 5e-3 with bf16 operands (the tolerances of
tests/test_pallas_kernels.py), and in float32 also against the Pallas
kernels in interpret mode (those round bf16 through a trig recurrence the
port does not carry over, so bf16 is held against the twin only). The
kernels themselves run only on a card: chip_smoke.py holds them against the
same plain versions there.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import RadialGeometry as JaxRadial
from pdunet_tpu.ops import nufft as jax_nufft
from pdunet_tpu.ops.nufft import fourier_slice as jax_fs
from pdunet_tpu.ops.radon import parallel as jax_parallel
from pdunet_tpu.ops.radon.pallas_kernels import (
    backproject_group_pallas,
    project_group_pallas,
)
from pdunet_tpu_torch.geometry import RadialGeometry
from pdunet_tpu_torch.ops.nufft import dcf, make_radial_ops
from pdunet_tpu_torch.ops.nufft import fourier_slice as fs
from pdunet_tpu_torch.ops.radon import cuda_kernels
from tests.oracles.torch_mri import torch_nufft_type1, torch_nufft_type2

torch.set_num_threads(1)

N = 32
GEOM = dict(image_size=N, n_spokes=24)          # samples_per_spoke → 64
_DT = [(False, 1e-5), (True, 5e-3)]


def rel(a, b):
    a = np.asarray(a).astype(np.complex128)
    b = np.asarray(b).astype(np.complex128)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _cplx(rng, shape):
    return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)


@pytest.fixture(scope="module")
def plans():
    """(JAX, port) fourier-slice plans, float32 and bf16 operands."""
    return {bf16: (jax_fs.build_fs_plan(JaxRadial(**GEOM),
                                        dtype=jnp.bfloat16 if bf16 else jnp.float32),
                   fs.build_fs_plan(RadialGeometry(**GEOM),
                                    dtype=torch.bfloat16 if bf16 else torch.float32,
                                    device="cpu"))
            for bf16 in (False, True)}


# -- (a) per-angle plain versions on the fs backing plan ---------------------

def _group(plan, grp):
    return getattr(plan, f"pos_{grp}"), getattr(plan, f"shift_{grp}")


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_group_plain_versions_match_jax_on_fs_plan(plans, contract_x, bf16, tol):
    jp, tp = (p.par_plan for p in plans[False])
    grp = "x" if contract_x else "y"
    L, A, S = tp.meta["S_ext"], tp.meta[f"A_{grp}"], tp.meta["S"]
    cj, ct = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    rng = np.random.default_rng(1)
    f = rng.standard_normal((3, N, N)).astype(np.float32)
    p = rng.standard_normal((3, A, S)).astype(np.float32)
    jargs = (*_group(jp, grp), jp.spec, jp.Wc, jp.Ws, L, contract_x)
    targs = (*_group(tp, grp), tp.spec, tp.Wc, tp.Ws, L, contract_x)
    ref_f = jax_parallel._project_group(jnp.asarray(f), *jargs, cdt=cj)
    ref_b = jax_parallel._backproject_group(jnp.asarray(p), *jargs, cdt=cj)
    out_f = cuda_kernels.project_group(torch.from_numpy(f), *targs, cdt=ct)
    out_b = cuda_kernels.backproject_group(torch.from_numpy(p), *targs, N, cdt=ct)
    assert out_f.shape == ref_f.shape == (3, A, S) and out_f.dtype == torch.float32
    assert out_b.shape == ref_b.shape == (3, N, N)
    assert rel(out_f, ref_f) < tol and rel(out_b, ref_b) < tol
    if not bf16:
        pal_f = project_group_pallas(jnp.asarray(f), *jargs, interpret=True)
        pal_b = backproject_group_pallas(jnp.asarray(p), *jargs, N, interpret=True)
        assert rel(out_f, pal_f) < tol and rel(out_b, pal_b) < tol


# -- (c) the plan ------------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_fs_plan_equals_jax(plans, bf16):
    """Same float64 plan math: every f32 array equal, meta equal."""
    jp, tp = plans[bf16]
    assert jp.meta == tp.meta
    assert jp.par_plan.meta == tp.par_plan.meta
    assert not tp.par_plan.meta["use_pairs"] and tp.par_plan.meta["K"] == 32
    for name in tp.par_plan.ARRAY_FIELDS:
        np.testing.assert_array_equal(getattr(tp.par_plan, name).numpy(),
                                      np.asarray(getattr(jp.par_plan, name)), err_msg=name)
    for name in tp.ARRAYS:
        a, b = getattr(tp, name).numpy(), np.asarray(getattr(jp, name))
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_fs_plan_refuses_odd_samples():
    with pytest.raises(ValueError, match="even samples_per_spoke"):
        fs.build_fs_plan(RadialGeometry(image_size=16, n_spokes=8, samples_per_spoke=31),
                         device="cpu")


# -- (d) the fourier-slice NUFFT ---------------------------------------------

@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_fs_nufft_matches_jax(plans, bf16, tol):
    jp, tp = plans[bf16]
    rng = np.random.default_rng(2)
    x = _cplx(rng, (2, N, N))
    y = _cplx(rng, (2, 24, 64))
    k = fs.fs_nufft_forward(tp, torch.from_numpy(x))
    assert k.dtype == torch.complex64 and k.shape == (2, 24, 64)
    assert rel(k, jax_fs.fs_nufft_forward(jp, jnp.asarray(x))) < tol
    a = fs.fs_nufft_adjoint(tp, torch.from_numpy(y))
    assert a.dtype == torch.complex64 and a.shape == (2, N, N)
    assert rel(a, jax_fs.fs_nufft_adjoint(jp, jnp.asarray(y))) < tol


def test_fs_nufft_matches_direct_dft(plans):
    """Exact to float rounding against the independent complex128 NUDFT."""
    _, tp = plans[False]
    rng = np.random.default_rng(3)
    x = _cplx(rng, (N, N))
    y = _cplx(rng, (24, 64))
    angles = RadialGeometry(**GEOM).spoke_angles
    ref_f = torch_nufft_type2(torch.from_numpy(x), 24, 64, angles)
    ref_b = torch_nufft_type1(torch.from_numpy(y), N, angles)
    assert rel(fs.fs_nufft_forward(tp, torch.from_numpy(x)), ref_f) < 1e-5
    assert rel(fs.fs_nufft_adjoint(tp, torch.from_numpy(y)), ref_b) < 1e-5


def test_fs_nufft_adjoint_dot_product(plans):
    _, tp = plans[False]
    rng = np.random.default_rng(4)
    x = torch.from_numpy(_cplx(rng, (3, N, N)))
    y = torch.from_numpy(_cplx(rng, (3, 24, 64)))
    c = torch.complex128
    lhs = torch.vdot(fs.fs_nufft_forward(tp, x).flatten().to(c), y.flatten().to(c))
    rhs = torch.vdot(x.flatten().to(c), fs.fs_nufft_adjoint(tp, y).flatten().to(c))
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_gradcheck_radial_A_and_At_complex128():
    """PyTorch's gradient of a C-linear map is A^H of the incoming gradient:
    backward(A) = A†, backward(A†) = A, checked numerically at 16²."""
    ops = make_radial_ops(RadialGeometry(image_size=16, n_spokes=6), device="cpu")
    gen = torch.Generator().manual_seed(5)
    f = torch.randn(1, 16, 16, dtype=torch.complex128, generator=gen, requires_grad=True)
    k = torch.randn(1, 6, 32, dtype=torch.complex128, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(ops.A, (f,), eps=1e-6, atol=1e-6, rtol=1e-6)
    assert torch.autograd.gradcheck(ops.At, (k,), eps=1e-6, atol=1e-6, rtol=1e-6)


def test_leading_dims_and_real_input(plans):
    _, tp = plans[False]
    x = torch.randn(2, 3, N, N, generator=torch.Generator().manual_seed(6))
    k = fs.fs_nufft_forward(tp, x)
    assert k.shape == (2, 3, 24, 64) and k.dtype == torch.complex64
    torch.testing.assert_close(k[1, 2], fs.fs_nufft_forward(tp, x[1, 2].to(torch.complex64)))
    assert fs.fs_nufft_adjoint(tp, k).shape == (2, 3, N, N)


# -- (e) density compensation and (f) the operator bundle ---------------------

@pytest.mark.parametrize("name", ["pipe_menon", "voronoi_ramp"])
def test_dcf_equals_jax(name):
    ref = np.asarray(jax_nufft.nufft._resolve_dcf(JaxRadial(**GEOM), name))
    out = dcf.resolve_dcf(RadialGeometry(**GEOM), name)
    assert out.dtype == ref.dtype == np.float32 and out.shape == (24, 64)
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="unknown dcf"):
        dcf.resolve_dcf(RadialGeometry(**GEOM), "ramp")


@pytest.mark.parametrize("bf16,tol", _DT, ids=["f32", "bf16"])
def test_radial_ops_bundle_and_fbp_match_jax(bf16, tol):
    jops = jax_nufft.make_radial_ops(JaxRadial(**GEOM),
                                     dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tops = make_radial_ops(RadialGeometry(**GEOM),
                           dtype=torch.bfloat16 if bf16 else torch.float32, device="cpu")
    assert tops.sino_shape == jops.sino_shape and tops.image_shape == jops.image_shape
    np.testing.assert_array_equal(tops.dcf.numpy(), np.asarray(jops.dcf))
    rng = np.random.default_rng(7)
    x = _cplx(rng, (2, N, N))
    k = np.array(jax_nufft.make_radial_ops(JaxRadial(**GEOM)).A(jnp.asarray(x)))
    assert rel(tops.A(torch.from_numpy(x)), jops.A(jnp.asarray(x))) < tol
    assert rel(tops.At(torch.from_numpy(k)), jops.At(jnp.asarray(k))) < tol
    assert rel(tops.fbp(torch.from_numpy(k)), jops.fbp(jnp.asarray(k))) < tol


def test_unported_nufft_paths_raise():
    """The gridding NUFFT is ported (tests/test_torch_nufft_gridding.py): it
    builds on request and, with a warning, for an odd spoke length; an
    unknown impl raises."""
    assert make_radial_ops(RadialGeometry(**GEOM), impl="gridding",
                           device="cpu").sino_shape == (24, 64)
    with pytest.warns(UserWarning, match="even samples_per_spoke"):
        ops = make_radial_ops(RadialGeometry(image_size=16, n_spokes=8, samples_per_spoke=31),
                              device="cpu")
    assert ops.sino_shape == (8, 31)
    with pytest.raises(ValueError, match="unknown NUFFT impl"):
        make_radial_ops(RadialGeometry(**GEOM), impl="nudft", device="cpu")
