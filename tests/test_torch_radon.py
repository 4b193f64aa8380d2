"""The port's projector (pdunet_tpu_torch/ops/radon) against the JAX package.

On the CPU the kernel wrappers run their plain PyTorch versions; those are
held against the JAX twins (_project_pair_group / _backproject_pair_group)
and the routed operators against the Pallas kernels in interpret mode, at
the tolerances of tests/test_pallas_kernels.py: 1e-5 relative in float32,
5e-3 with bf16 operands (rounding of bf16 operands made in a different
order), and 2e-5 against the per-angle einsum operator (pairing substitutes
prim_b by ±prim_a of independently f32-rounded rows). Plans whose angles
do not pair (golden-angle angle sets) run the per-angle operator, held the
same way against _project_group / _backproject_group and the per-angle
Pallas kernels. The kernels themselves run only on a card: chip_smoke.py
holds them against the same plain versions there.
"""

import contextlib
import functools
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import GOLDEN_ANGLE
from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.geometry import build_parallel_plan as jax_plan
from pdunet_tpu.ops.radon import filtering as jax_filtering
from pdunet_tpu.ops.radon import parallel as jax_parallel
from pdunet_tpu.ops.radon.pallas_kernels import (
    backproject_group_pallas,
    project_group_pallas,
)
from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.radon import cuda_kernels, filtering, parallel

torch.set_num_threads(1)

N = 32
_BF16 = [(False, 1e-5), (True, 5e-3)]


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _plans(n_angles, bf16=False):
    kw = dict(image_size=N, n_angles=n_angles, det_count=N)
    jp = jax_plan(JaxGeometry(**kw), dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tp = build_parallel_plan(ParallelGeometry(**kw),
                             dtype=torch.bfloat16 if bf16 else torch.float32,
                             device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def plans24():
    return _plans(24)


def _pair(plan, grp):
    return [getattr(plan, f"pair_{nm}_{grp}") for nm in ("pos", "sha", "shb", "sgn", "msk")]


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_project_pair_plain_matches_jax_twin(plans24, contract_x, bf16, tol):
    jp, tp = plans24
    grp = "x" if contract_x else "y"
    f = np.random.default_rng(1).standard_normal((2, N, N)).astype(np.float32)
    L = tp.meta["S_ext"]
    ref = jax_parallel._project_pair_group(
        jnp.asarray(f), *_pair(jp, grp)[:4], jp.spec, jp.Wc, jp.Ws, L, contract_x,
        cdt=jnp.bfloat16 if bf16 else jnp.float32)
    out = cuda_kernels.project_pair_group(
        torch.from_numpy(f), *_pair(tp, grp)[:4], tp.spec, tp.Wc, tp.Ws, L, contract_x,
        cdt=torch.bfloat16 if bf16 else torch.float32)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_backproject_pair_plain_matches_jax_twin(plans24, contract_x, bf16, tol):
    jp, tp = plans24
    grp = "x" if contract_x else "y"
    P = tp.meta[f"P_{grp}"]
    p = np.random.default_rng(2).standard_normal((2, 2 * P, N)).astype(np.float32)
    L = tp.meta["S_ext"]
    ref = jax_parallel._backproject_pair_group(
        jnp.asarray(p), *_pair(jp, grp), jp.spec, jp.Wc, jp.Ws, L, contract_x,
        cdt=jnp.bfloat16 if bf16 else jnp.float32)
    out = cuda_kernels.backproject_pair_group(
        torch.from_numpy(p), *_pair(tp, grp), tp.spec, tp.Wc, tp.Ws, L, contract_x, N,
        cdt=torch.bfloat16 if bf16 else torch.float32)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol


def test_cpu_calls_do_not_count_launches(plans24):
    _, tp = plans24
    cuda_kernels.reset_launch_counts()
    f = torch.zeros(1, N, N)
    parallel.parallel_backproject(tp, parallel.parallel_project(tp, f))
    assert cuda_kernels.project_pair_group.launches == 0
    assert cuda_kernels.backproject_pair_group.launches == 0


def test_wrappers_refuse_devices_without_a_kernel(plans24):
    _, tp = plans24
    x = _pair(tp, "x")
    f = torch.zeros(1, N, N, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        cuda_kernels.project_pair_group(f, *x[:4], tp.spec, tp.Wc, tp.Ws,
                                        tp.meta["S_ext"], True)


@pytest.mark.parametrize("n_angles", [24, 21])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_routed_operators_match_jax_pallas_interpret(n_angles, bf16, tol):
    """Full routed pair path (pair groups, index_select on pair_inv_perm /
    pair_take, compute dtype) against the JAX Pallas kernels in interpret
    mode, including the unpaired leftover angles at 21 angles."""
    jp, tp = _plans(n_angles, bf16)
    assert tp.meta["use_pairs"]
    rng = np.random.default_rng(3)
    f = rng.standard_normal((2, N, N)).astype(np.float32)
    sino_j = jax_parallel.parallel_project(jp, jnp.asarray(f), impl="pallas", interpret=True)
    sino_t = parallel.parallel_project(tp, torch.from_numpy(f))
    assert sino_t.shape == sino_j.shape
    assert rel(sino_t, sino_j) < tol
    q = rng.standard_normal(sino_j.shape).astype(np.float32)
    bp_j = jax_parallel.parallel_backproject(jp, jnp.asarray(q), impl="pallas",
                                             interpret=True)
    bp_t = parallel.parallel_backproject(tp, torch.from_numpy(q))
    assert rel(bp_t, bp_j) < tol


@pytest.mark.parametrize("n_angles", [24, 21])
def test_routed_operators_match_jax_einsum(n_angles):
    jp, tp = _plans(n_angles)
    rng = np.random.default_rng(4)
    f = rng.standard_normal((2, N, N)).astype(np.float32)
    sino_j = jax_parallel.parallel_project(jp, jnp.asarray(f), impl="einsum")
    sino_t = parallel.parallel_project(tp, torch.from_numpy(f))
    assert rel(sino_t, sino_j) < 2e-5
    q = rng.standard_normal(sino_j.shape).astype(np.float32)
    bp_j = jax_parallel.parallel_backproject(jp, jnp.asarray(q), impl="einsum")
    bp_t = parallel.parallel_backproject(tp, torch.from_numpy(q))
    assert rel(bp_t, bp_j) < 2e-5


@pytest.mark.parametrize("n_angles", [24, 21])
def test_adjoint_dot_product(n_angles):
    _, tp = _plans(n_angles)
    gen = torch.Generator().manual_seed(5)
    f = torch.randn(3, N, N, generator=gen)
    q = torch.randn(3, n_angles, N, generator=gen)
    lhs = torch.vdot(parallel.parallel_project(tp, f).flatten().double(),
                     q.flatten().double())
    rhs = torch.vdot(f.flatten().double(),
                     parallel.parallel_backproject(tp, q).flatten().double())
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_leading_dims_and_dtype_are_kept(plans24):
    _, tp = plans24
    f = torch.randn(2, 3, N, N, generator=torch.Generator().manual_seed(6))
    p = parallel.parallel_project(tp, f)
    assert p.shape == (2, 3, 24, N)
    torch.testing.assert_close(p[1, 2], parallel.parallel_project(tp, f[1, 2]))
    assert parallel.parallel_backproject(tp, p).shape == (2, 3, N, N)
    assert parallel.parallel_project(tp, f.double()).dtype == torch.float64


def test_gradcheck_A_and_At_f64():
    """vjp(A) = A† and vjp(A†) = A, checked numerically in float64 at 16²."""
    geom = ParallelGeometry(image_size=16, n_angles=12)
    ops = parallel.make_parallel_ops(geom, device="cpu")
    gen = torch.Generator().manual_seed(7)
    f = torch.randn(1, 16, 16, dtype=torch.float64, generator=gen, requires_grad=True)
    p = torch.randn(1, 12, 16, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(ops.A, (f,), eps=1e-6, atol=1e-7, rtol=1e-6)
    assert torch.autograd.gradcheck(ops.At, (p,), eps=1e-6, atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("name", filtering.FILTERS)
def test_filter_sinogram_matches_jax(name):
    sino = np.random.default_rng(8).standard_normal((2, 10, 37)).astype(np.float32)
    ref = jax_filtering.filter_sinogram(jnp.asarray(sino), 0.8, name)
    out = filtering.filter_sinogram(torch.from_numpy(sino), 0.8, name)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    H_j, pad_j = jax_filtering.ramp_kernel(37, 0.8, name)
    H_t, pad_t = filtering.ramp_kernel(37, 0.8, name)
    assert pad_t == pad_j
    np.testing.assert_array_equal(H_t.numpy(), np.asarray(H_j))


def test_filter_name_typo_raises():
    with pytest.raises(ValueError, match="unknown filter"):
        filtering.filter_sinogram(torch.zeros(2, 8), 1.0, "hanning")


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_ops_bundle_and_fbp_match_jax(bf16):
    geom_kw = dict(image_size=N, n_angles=24, det_count=N)
    jops = jax_parallel.make_parallel_ops(JaxGeometry(**geom_kw),
                                          dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tops = parallel.make_parallel_ops(ParallelGeometry(**geom_kw),
                                      dtype=torch.bfloat16 if bf16 else torch.float32,
                                      device="cpu")
    assert tops.sino_shape == jops.sino_shape and tops.image_shape == jops.image_shape
    rng = np.random.default_rng(9)
    img = rng.standard_normal((2, N, N)).astype(np.float32)
    sino = np.array(jax_parallel.make_parallel_ops(JaxGeometry(**geom_kw)).A(
        jnp.asarray(img)))
    # JAX runs the per-angle einsum operator on the CPU; the port always
    # pairs, so bf16 operands are rounded at different points (<5e-3)
    tol = 5e-3 if bf16 else 2e-5
    assert rel(tops.A(torch.from_numpy(img)), jops.A(jnp.asarray(img))) < tol
    assert rel(tops.At(torch.from_numpy(sino)), jops.At(jnp.asarray(sino))) < tol
    assert rel(tops.fbp(torch.from_numpy(sino)), jops.fbp(jnp.asarray(sino))) < tol
    assert rel(tops.fbp(torch.from_numpy(sino), "hann"),
               jops.fbp(jnp.asarray(sino), "hann")) < tol


# -- plans whose angles do not pair: the per-angle operator ------------------

_GOLDEN = tuple((k * GOLDEN_ANGLE) % math.pi for k in range(16))


def _golden_plans(bf16=False):
    jp = jax_plan(JaxGeometry(image_size=N, angles=_GOLDEN),
                  dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tp = build_parallel_plan(ParallelGeometry(image_size=N, angles=_GOLDEN),
                             dtype=torch.bfloat16 if bf16 else torch.float32,
                             device="cpu")
    assert not tp.meta["use_pairs"] and tp.meta["A_x"] and tp.meta["A_y"]
    return jp, tp


@pytest.fixture(scope="module")
def golden():
    return _golden_plans()


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_project_group_plain_matches_jax_twin(golden, contract_x, bf16, tol):
    """Per-angle forward on a golden-angle plan (K = L//2+1 there, unlike
    the fourier-slice plan of tests/test_torch_radial.py); in f32 also
    against project_group_pallas in interpret mode."""
    jp, tp = golden
    grp = "x" if contract_x else "y"
    L = tp.meta["S_ext"]
    f = np.random.default_rng(10).standard_normal((2, N, N)).astype(np.float32)
    jargs = (getattr(jp, f"pos_{grp}"), getattr(jp, f"shift_{grp}"), jp.spec, jp.Wc,
             jp.Ws, L, contract_x)
    ref = jax_parallel._project_group(jnp.asarray(f), *jargs,
                                      cdt=jnp.bfloat16 if bf16 else jnp.float32)
    out = cuda_kernels.project_group(
        torch.from_numpy(f), getattr(tp, f"pos_{grp}"), getattr(tp, f"shift_{grp}"),
        tp.spec, tp.Wc, tp.Ws, L, contract_x,
        cdt=torch.bfloat16 if bf16 else torch.float32)
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol
    if not bf16:
        assert rel(out, project_group_pallas(jnp.asarray(f), *jargs, interpret=True)) < tol


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_backproject_group_plain_matches_jax_twin(golden, contract_x, bf16, tol):
    jp, tp = golden
    grp = "x" if contract_x else "y"
    L, A = tp.meta["S_ext"], tp.meta[f"A_{grp}"]
    p = np.random.default_rng(11).standard_normal((2, A, N)).astype(np.float32)
    jargs = (getattr(jp, f"pos_{grp}"), getattr(jp, f"shift_{grp}"), jp.spec, jp.Wc,
             jp.Ws, L, contract_x)
    ref = jax_parallel._backproject_group(jnp.asarray(p), *jargs,
                                          cdt=jnp.bfloat16 if bf16 else jnp.float32)
    out = cuda_kernels.backproject_group(
        torch.from_numpy(p), getattr(tp, f"pos_{grp}"), getattr(tp, f"shift_{grp}"),
        tp.spec, tp.Wc, tp.Ws, L, contract_x, N,
        cdt=torch.bfloat16 if bf16 else torch.float32)
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < tol
    if not bf16:
        pal = backproject_group_pallas(jnp.asarray(p), *jargs, N, interpret=True)
        assert rel(out, pal) < tol


@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_unpaired_routed_operators_match_jax(bf16, tol):
    """The unpaired dispatch (x and y groups concatenated and reordered by
    inv_perm; the adjoint takes idx_x / idx_y per group and sums) against
    JAX's per-angle operator."""
    jp, tp = _golden_plans(bf16)
    rng = np.random.default_rng(12)
    f = rng.standard_normal((2, N, N)).astype(np.float32)
    sino_j = jax_parallel.parallel_project(jp, jnp.asarray(f), impl="einsum")
    sino_t = parallel.parallel_project(tp, torch.from_numpy(f))
    assert sino_t.shape == sino_j.shape == (2, 16, N)
    assert rel(sino_t, sino_j) < tol
    q = rng.standard_normal(sino_j.shape).astype(np.float32)
    bp_j = jax_parallel.parallel_backproject(jp, jnp.asarray(q), impl="einsum")
    bp_t = parallel.parallel_backproject(tp, torch.from_numpy(q))
    assert rel(bp_t, bp_j) < tol
    if not bf16:
        sino_p = jax_parallel.parallel_project(jp, jnp.asarray(f), impl="pallas",
                                               interpret=True)
        bp_p = jax_parallel.parallel_backproject(jp, jnp.asarray(q), impl="pallas",
                                                 interpret=True)
        assert rel(sino_t, sino_p) < tol and rel(bp_t, bp_p) < tol


def test_unpaired_adjoint_dot_product_and_gradcheck(golden):
    _, tp = golden
    gen = torch.Generator().manual_seed(13)
    f = torch.randn(3, N, N, generator=gen)
    q = torch.randn(3, 16, N, generator=gen)
    lhs = torch.vdot(parallel.parallel_project(tp, f).flatten().double(),
                     q.flatten().double())
    rhs = torch.vdot(f.flatten().double(),
                     parallel.parallel_backproject(tp, q).flatten().double())
    assert abs(lhs - rhs) / abs(lhs) < 1e-5
    angles = tuple((k * GOLDEN_ANGLE) % math.pi for k in range(5))
    ops = parallel.make_parallel_ops(ParallelGeometry(image_size=12, angles=angles),
                                     device="cpu")
    assert not ops.plan.meta["use_pairs"]
    x = torch.randn(1, 12, 12, dtype=torch.float64, generator=gen, requires_grad=True)
    y = torch.randn(1, 5, 12, dtype=torch.float64, generator=gen, requires_grad=True)
    assert torch.autograd.gradcheck(ops.A, (x,), eps=1e-6, atol=1e-7, rtol=1e-6)
    assert torch.autograd.gradcheck(ops.At, (y,), eps=1e-6, atol=1e-7, rtol=1e-6)


def test_group_wrappers_count_nothing_on_cpu_and_refuse_other_devices(golden):
    _, tp = golden
    cuda_kernels.reset_launch_counts()
    parallel.parallel_backproject(tp, parallel.parallel_project(tp, torch.zeros(1, N, N)))
    assert cuda_kernels.project_group.launches == 0
    assert cuda_kernels.backproject_group.launches == 0
    args = (tp.pos_x, tp.shift_x, tp.spec, tp.Wc, tp.Ws, tp.meta["S_ext"], True)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_kernels.project_group(torch.zeros(1, N, N, device="meta"), *args)
    with pytest.raises(ValueError, match="no kernel"):
        cuda_kernels.backproject_group(
            torch.zeros(1, tp.meta["A_x"], N, device="meta"), *args, N)


def test_adjoint_splits_fill_the_card(monkeypatch):
    """The per-angle adjoint, on either CUDA route, hands its C entry point
    the depth split of group_adjoint_splits at the route's output tile
    width (128 x 256 bf16, 128 x 128 split) on the card's SM count: one
    wave of one block per SM, never more slices than angles, one slice when
    the tiles alone fill the card. Meta tensors stand in for the card's;
    the launch is recorded, not made."""
    recorded = []
    monkeypatch.setattr(cuda_kernels, "_check_device", lambda x: None)
    monkeypatch.setattr(cuda_kernels, "_launch", lambda name, *a: recorded.append((name, a)))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    n, A, K, S = 256, 64, 256, 1024   # pdunet_radial's per-angle shape
    meta = functools.partial(torch.zeros, device="meta")
    rows = (meta(A, n), meta(A, n), meta(K), meta(K, S), meta(K, S), 2 * K, True)
    Np, K2p = cuda_kernels._tc_dims(n, K)
    tables = {torch.bfloat16: meta(2, A, Np, K2p, dtype=torch.bfloat16),
              torch.float32: (meta(2, A, Np, K2p, dtype=torch.bfloat16),
                              meta(1, A, Np, K2p))}
    # (batch, bf16 slices, split slices): 16 / 32 tiles at B' = 8
    for B, g_tc, g_split in ((8, 8, 4), (1, 64, 33), (2, 33, 16), (256, 1, 1)):
        for cdt, want in ((torch.bfloat16, g_tc), (torch.float32, g_split)):
            recorded.clear()
            out = cuda_kernels.backproject_group(meta(B, A, S), *rows, n, cdt,
                                                 tables=tables[cdt])
            assert out.shape == (B, n, n)
            (name, args), = recorded
            assert name == ("radon_group_tc_backproject" if cdt == torch.bfloat16
                            else "radon_group_split_backproject")
            assert args[-2] == want, (B, cdt)
