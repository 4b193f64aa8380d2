"""The split-bf16 float32 route of the mirror-pair kernels
(pdunet_tpu_torch/ops/radon/csrc/radon_pair_split.cu) on the CPU.

The kernels run only on a card (chip_smoke.py holds them against the plain
versions there). Here: the plain split tables (T̂ as bf16 hi and lo
planes, φ in float32), and the plain versions that run the kernels'
arithmetic in their order (F or h and T̂ split into hi and lo, three bf16
products with f32 sums, φ, Ŝ and stages 2-3 in f32), against
project_pair_group_pallas / backproject_pair_group_pallas in interpret mode
on the small plans of tests/test_torch_pair_tc.py, and against the JAX
package's float32 einsum twins at the serving shape (256², 90 of 360
angles), which guards the route's numerics: the split drops the lo·lo
term and rounds each lo part, ≈ 2⁻¹⁷ relative per operand, so the float32
contract (1e-5 relative) holds with a margin of a few times.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.geometry import build_parallel_plan as jax_plan
from pdunet_tpu.ops.radon import parallel as jax_parallel
from pdunet_tpu.ops.radon.pallas_kernels import (
    backproject_pair_group_pallas,
    project_pair_group_pallas,
)
from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.radon import cuda_kernels, parallel

torch.set_num_threads(1)

N = 32
TOL = 1e-5
_NAMES = ("pos", "sha", "shb", "sgn", "msk")


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module", params=[24, 21], ids=["24", "21"])
def plans(request):
    kw = dict(image_size=N, n_angles=request.param, det_count=N)
    return (jax_plan(JaxGeometry(**kw)),
            build_parallel_plan(ParallelGeometry(**kw), device="cpu"))


@pytest.fixture(scope="module")
def serving_plans():
    """The serving geometry: 256², 90 of 360 angles (pdunet_parallel)."""
    return (jax_plan(JaxGeometry(image_size=256, n_angles=360).subsample(4)),
            build_parallel_plan(ParallelGeometry(image_size=256, n_angles=360).subsample(4),
                                device="cpu"))


def _rows(plan, grp):
    return [getattr(plan, f"pair_{nm}_{grp}") for nm in _NAMES]


def _split_tables(tp, grp):
    return cuda_kernels._pair_split_tables(*_rows(tp, grp)[:3], tp.spec, tp.meta["S_ext"])


@pytest.mark.parametrize("grp", ["x", "y"])
def test_split_tables_hold_the_f32_trig(plans, grp):
    """hi + lo is T̂ to ≤ 2⁻¹⁶ relative per element; φ is the f32 trig of
    _pair_spectral_tensors, bit for bit; zero padding."""
    _, tp = plans
    T, phi = _split_tables(tp, grp)
    P, K = tp.meta[f"P_{grp}"], tp.meta["K"]
    K2p = 128 * -(-2 * K // 128)
    assert T.dtype == torch.bfloat16 and T.shape == (2, P, 128, K2p)
    assert phi.dtype == torch.float32 and phi.shape == (2, P, 128, K2p)
    ref = cuda_kernels._pair_spectral_tensors(*_rows(tp, grp)[:3], tp.spec, tp.meta["S_ext"])
    recon = T[0].float() + T[1].float()
    for ri in range(2):
        t = ref[ri]
        err = (recon[:, :N, ri:2 * K:2] - t).abs()
        assert bool((err <= 2.0 ** -16 * t.abs()).all())
        for m in range(2):
            torch.testing.assert_close(phi[m, :, :N, ri:2 * K:2], ref[2 + 2 * m + ri],
                                       rtol=0, atol=0)
    assert not T[:, :, N:].any() and not T[..., 2 * K:].any()
    assert not phi[:, :, N:].any() and not phi[..., 2 * K:].any()
    # the lo plane carries what bf16 drops: without it T̂ is off by ~2⁻⁹
    assert T[1].float().abs().max() > 0


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
def test_split_forward_matches_pallas_interpret(plans, contract_x):
    jp, tp = plans
    grp = "x" if contract_x else "y"
    L = tp.meta["S_ext"]
    f = np.random.default_rng(31).standard_normal((2, N, N)).astype(np.float32)
    ref = project_pair_group_pallas(jnp.asarray(f), *_rows(jp, grp)[:4], jp.spec, jp.Wc,
                                    jp.Ws, L, contract_x, interpret=True)
    rows = _rows(tp, grp)
    out = cuda_kernels._pair_forward_tc(torch.from_numpy(f), _split_tables(tp, grp), rows[3],
                                        tp.Wc, tp.Ws, contract_x, torch.float32)
    assert out.shape == ref.shape
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("G", [1, 3])
def test_split_adjoint_matches_pallas_interpret(plans, contract_x, G):
    jp, tp = plans
    grp = "x" if contract_x else "y"
    L, P = tp.meta["S_ext"], tp.meta[f"P_{grp}"]
    p = np.random.default_rng(32).standard_normal((2, 2 * P, N)).astype(np.float32)
    ref = backproject_pair_group_pallas(jnp.asarray(p), *_rows(jp, grp), jp.spec, jp.Wc,
                                        jp.Ws, L, contract_x, N, interpret=True)
    rows = _rows(tp, grp)
    out = cuda_kernels._pair_adjoint_tc(torch.from_numpy(p), _split_tables(tp, grp), rows[3],
                                        rows[4], tp.Wc, tp.Ws, contract_x, N, G, torch.float32)
    assert out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
def test_split_matches_jax_einsum_at_serving_shape(serving_plans, contract_x):
    """The numerics guard: 256², 90 of 360 angles, B = 1, an image of
    ellipse-like structure for A and a white sinogram (as after the ramp
    filter) for A†, against the JAX float32 einsum twins."""
    jp, tp = serving_plans
    grp = "x" if contract_x else "y"
    L, P, S = tp.meta["S_ext"], tp.meta[f"P_{grp}"], tp.meta["S"]
    n = tp.meta["N"]
    rng = np.random.default_rng(33)
    yy, xx = np.mgrid[:n, :n] / n - 0.5
    f = ((xx ** 2 / 0.16 + yy ** 2 / 0.09 < 1) * 1.0
         + 0.1 * rng.standard_normal((n, n)))[None].astype(np.float32)
    p = rng.standard_normal((1, 2 * P, S)).astype(np.float32)
    jr, rows = _rows(jp, grp), _rows(tp, grp)
    tab = _split_tables(tp, grp)
    ref = jax_parallel._project_pair_group(jnp.asarray(f), *jr[:4], jp.spec, jp.Wc, jp.Ws, L,
                                           contract_x)
    out = cuda_kernels._pair_forward_tc(torch.from_numpy(f), tab, rows[3], tp.Wc, tp.Ws,
                                        contract_x, torch.float32)
    assert rel(out, ref) < TOL
    ref = jax_parallel._backproject_pair_group(jnp.asarray(p), *jr, jp.spec, jp.Wc, jp.Ws, L,
                                               contract_x)
    G = cuda_kernels.pair_adjoint_splits(1, n, P, 132, cols=128)
    out = cuda_kernels._pair_adjoint_tc(torch.from_numpy(p), tab, rows[3], rows[4], tp.Wc,
                                        tp.Ws, contract_x, n, G, torch.float32)
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("grp", ["x", "y"])
def test_split_pair_dot_test(plans, grp):
    """<A x, y> = <x, A† y> to 1e-5 for the plain split pair (the split
    rounds the two sides' operands differently, so not to machine
    precision). y = A x plus a random sinogram of the same norm: <A x, y>
    stays near ‖A x‖², so the mismatch reads the pair's error (≈ 4e-6 per
    operator) and not the ratio of two near-zero random dot products."""
    _, tp = plans
    cx = grp == "x"
    rows = _rows(tp, grp)
    tab = _split_tables(tp, grp)
    rng = np.random.default_rng(34)
    x = torch.from_numpy(rng.standard_normal((2, N, N)).astype(np.float32))
    ax = cuda_kernels._pair_forward_tc(x, tab, rows[3], tp.Wc, tp.Ws, cx, torch.float32)
    r = torch.from_numpy(rng.standard_normal(tuple(ax.shape)).astype(np.float32))
    y = ax + r * (ax.norm() / r.norm())
    y[:, 1::2] *= rows[4][None, :, None]  # unpaired member-b rows
    aty = cuda_kernels._pair_adjoint_tc(y, tab, rows[3], rows[4], tp.Wc, tp.Ws, cx, N, 2,
                                        torch.float32)
    lhs = torch.vdot(ax.double().flatten(), y.double().flatten())
    rhs = torch.vdot(x.double().flatten(), aty.double().flatten())
    assert float(abs(lhs - rhs) / abs(lhs)) < TOL


def test_cuda_f32_call_without_tables_raises(plans, monkeypatch):
    """The float32 route needs the plan's split tables: a CUDA float32 call
    without them raises before any launch (no fallback to another
    kernel)."""
    _, tp = plans
    monkeypatch.setattr(cuda_kernels, "_check_device", lambda x: None)
    cuda_kernels.reset_launch_counts()
    rows = _rows(tp, "x")
    P, L = rows[0].shape[0], tp.meta["S_ext"]
    f = torch.zeros(1, N, N, device="meta")
    with pytest.raises(ValueError, match="split trig tables"):
        cuda_kernels.project_pair_group(f, *rows[:4], tp.spec, tp.Wc, tp.Ws, L, True)
    p = torch.zeros(1, 2 * P, N, device="meta")
    with pytest.raises(ValueError, match="split trig tables"):
        cuda_kernels.backproject_pair_group(p, *rows, tp.spec, tp.Wc, tp.Ws, L, True, N)
    # bf16 tables are refused too
    tab = cuda_kernels._pair_tables(*rows[:3], tp.spec, L)
    with pytest.raises(ValueError, match="split trig tables"):
        cuda_kernels.project_pair_group(f, *rows[:4], tp.spec, tp.Wc, tp.Ws, L, True,
                                        tables=tab)
    assert cuda_kernels.project_pair_group.launches == 0
    assert cuda_kernels.backproject_pair_group.launches == 0


def test_cpu_f32_operators_build_no_split_tables():
    """On the CPU the float32 operators run the plain versions: no split
    table is made or kept on the plan, and no launch is counted."""
    ops = parallel.make_parallel_ops(ParallelGeometry(image_size=N, n_angles=24),
                                     dtype=torch.float32, device="cpu")
    cuda_kernels.reset_launch_counts()
    x = torch.randn(1, N, N, generator=torch.Generator().manual_seed(35))
    ops.fbp(ops.A(x))
    assert ops.plan.pair_split_tables == {} and ops.plan.pair_tables == {}
    assert cuda_kernels.build_pair_split_tables.launches == 0
    assert cuda_kernels.project_pair_group.launches_split == 0
    assert cuda_kernels.backproject_pair_group.launches_split == 0


def test_split_adjoint_fills_one_wave():
    """The split adjoint's 128-column tiles take the one-wave rule: 16 tiles
    at the serving shape (B = 4, N = 256) → 8 slices on 132 SMs."""
    assert cuda_kernels.pair_adjoint_splits(4, 256, 23, 132, cols=128) == 8
    assert cuda_kernels.pair_adjoint_splits(1, 256, 23, 132, cols=128) == 23
    assert cuda_kernels.pair_adjoint_splits(256, 256, 23, 132, cols=128) == 1
