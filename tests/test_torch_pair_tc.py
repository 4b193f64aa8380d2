"""The tensor-core route of the mirror-pair kernels
(pdunet_tpu_torch/ops/radon/csrc/radon_pair_tc.cu) on the CPU.

The kernels run only on a card (chip_smoke.py holds them against the plain
versions there). Here: the plain trig-table builder (layout, re/im
interleave, zero padding) against the port's and the JAX package's
_pair_spectral_tensors; the adjoint's pair split; and plain versions that
read the tables, pad, split and sum in the kernels' order, against
project_pair_group_pallas / backproject_pair_group_pallas in interpret mode
at 32² with 24 and 21 angles (θ = 0 has no mirror in [0, π), so both
leave an unpaired pair, msk = 0; the x group pairs θ with π − θ at
sgn = −1, the y group at sgn = +1). Tolerances
(relative norm): 1e-5 in float32; 5e-3 with bf16 operands, where the Pallas
kernels make their bf16 trig by block doubling, as in
tests/test_torch_radon.py.
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
_BF16 = [(False, 1e-5), (True, 5e-3)]
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


def _rows(plan, grp):
    return [getattr(plan, f"pair_{nm}_{grp}") for nm in _NAMES]


def _cdt(bf16):
    return torch.bfloat16 if bf16 else torch.float32


@pytest.mark.parametrize("grp", ["x", "y"])
def test_tables_layout_matches_pair_spectral_tensors(plans, grp):
    _, tp = plans
    pos, sha, shb = _rows(tp, grp)[:3]
    L, K = tp.meta["S_ext"], tp.meta["K"]
    tab = cuda_kernels.build_pair_tables(pos, sha, shb, tp.spec, L)
    P = pos.shape[0]
    Np, K2p = 128, 128 * -(-2 * K // 128)
    assert tab.dtype == torch.bfloat16 and tab.shape == (3, P, Np, K2p)
    ref = cuda_kernels._pair_spectral_tensors(pos, sha, shb, tp.spec, L, torch.bfloat16)
    for t in range(3):
        for ri in range(2):
            torch.testing.assert_close(tab[t, :, :N, ri:2 * K:2].float(), ref[2 * t + ri],
                                       rtol=0, atol=0)
    assert not tab[:, :, N:].any() and not tab[..., 2 * K:].any()


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tables_match_jax_pair_spectral_tensors(plans, grp, bf16):
    jp, tp = plans
    L, K = tp.meta["S_ext"], tp.meta["K"]
    ref = jax_parallel._pair_spectral_tensors(
        *_rows(jp, grp)[:3], jp.spec, L, cdt=jnp.bfloat16 if bf16 else jnp.float32)
    tab = cuda_kernels._pair_tables(*_rows(tp, grp)[:3], tp.spec, L, _cdt(bf16)).float()
    for i, r in enumerate(ref):
        t, ri = divmod(i, 2)
        out = tab[t, :, :N, ri:2 * K:2]
        # the trig of the two libraries differs in the last f32 bit, which
        # can flip a bf16 rounding
        assert rel(out, np.asarray(r, np.float32)) < (5e-3 if bf16 else 1e-6)


def test_pair_adjoint_splits_fill_the_card():
    """One wave of one block per SM at the serving shape (B = 4, N = 256,
    P = 23 on 132 SMs: 8 tiles x 16 slices = 128 blocks, where 17 slices
    would leave a second, nearly empty wave), no split at batch 256, never
    more slices than pairs."""
    G = cuda_kernels.pair_adjoint_splits(4, 256, 23, 132)
    assert 4 * 2 * 1 * G <= 132 < 4 * 2 * 1 * (G + 1) and G <= 23
    assert G == 16
    assert cuda_kernels.pair_adjoint_splits(256, 256, 23, 132) == 1
    assert cuda_kernels.pair_adjoint_splits(1, 96, 6, 132) == 6
    assert cuda_kernels.pair_adjoint_splits(32, 256, 23, 132) == 2


def test_plans_cover_unpaired_and_mirrored_pairs(plans):
    """The cases above include sgn = −1 pairs and unpaired rows (θ = 0 has
    no mirror in [0, π))."""
    _, tp = plans
    assert (tp.pair_sgn_x[tp.pair_msk_x == 1] == -1).all()
    assert (tp.pair_sgn_y == 1).all()
    assert (tp.pair_msk_x == 0).any()


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_tiled_forward_matches_pallas_interpret(plans, contract_x, bf16, tol):
    jp, tp = plans
    grp = "x" if contract_x else "y"
    L = tp.meta["S_ext"]
    f = np.random.default_rng(21).standard_normal((2, N, N)).astype(np.float32)
    ref = project_pair_group_pallas(jnp.asarray(f), *_rows(jp, grp)[:4], jp.spec, jp.Wc,
                                    jp.Ws, L, contract_x, interpret=True, bf16=bf16)
    rows = _rows(tp, grp)
    tab = cuda_kernels._pair_tables(*rows[:3], tp.spec, L, _cdt(bf16))
    out = cuda_kernels._pair_forward_tc(torch.from_numpy(f), tab, rows[3], tp.Wc, tp.Ws,
                                        contract_x, _cdt(bf16))
    assert out.shape == ref.shape
    assert rel(out, ref) < tol
    plain = cuda_kernels._project_pair_group(torch.from_numpy(f), *rows[:4], tp.spec, tp.Wc,
                                             tp.Ws, L, contract_x, _cdt(bf16))
    assert rel(out, plain) < tol


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3])
def test_tiled_adjoint_matches_pallas_interpret(plans, contract_x, bf16, tol, G):
    jp, tp = plans
    grp = "x" if contract_x else "y"
    L, P = tp.meta["S_ext"], tp.meta[f"P_{grp}"]
    p = np.random.default_rng(22).standard_normal((2, 2 * P, N)).astype(np.float32)
    ref = backproject_pair_group_pallas(jnp.asarray(p), *_rows(jp, grp), jp.spec, jp.Wc,
                                        jp.Ws, L, contract_x, N, interpret=True, bf16=bf16)
    rows = _rows(tp, grp)
    tab = cuda_kernels._pair_tables(*rows[:3], tp.spec, L, _cdt(bf16))
    out = cuda_kernels._pair_adjoint_tc(torch.from_numpy(p), tab, rows[3], rows[4], tp.Wc,
                                        tp.Ws, contract_x, N, G, _cdt(bf16))
    assert out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < tol


def test_unpaired_rows_contribute_nothing(plans):
    """Member-b rows of unpaired pairs (msk = 0) never reach the image."""
    _, tp = plans
    for grp, cx in (("x", True), ("y", False)):
        rows = _rows(tp, grp)
        msk = rows[4]
        if bool((msk != 0).all()):
            continue
        P = msk.shape[0]
        tab = cuda_kernels._pair_tables(*rows[:3], tp.spec, tp.meta["S_ext"])
        p = torch.zeros(1, 2 * P, N)
        p[0, 2 * int(torch.nonzero(msk == 0)[0]) + 1] = 1.0
        out = cuda_kernels._pair_adjoint_tc(p, tab, rows[3], msk, tp.Wc, tp.Ws, cx, N, 2)
        assert not out.any()


def test_cuda_bf16_call_without_tables_raises(plans, monkeypatch):
    """The tensor-core route needs the plan's tables: a CUDA bf16 call
    without them raises before any launch (no fallback)."""
    _, tp = plans
    monkeypatch.setattr(cuda_kernels, "_check_device", lambda x: None)
    rows = _rows(tp, "x")
    P, L = rows[0].shape[0], tp.meta["S_ext"]
    f = torch.zeros(1, N, N, device="meta")
    with pytest.raises(ValueError, match="trig tables"):
        cuda_kernels.project_pair_group(f, *rows[:4], tp.spec, tp.Wc, tp.Ws, L, True,
                                        cdt=torch.bfloat16)
    p = torch.zeros(1, 2 * P, N, device="meta")
    with pytest.raises(ValueError, match="trig tables"):
        cuda_kernels.backproject_pair_group(p, *rows, tp.spec, tp.Wc, tp.Ws, L, True, N,
                                            cdt=torch.bfloat16)


def test_cpu_operators_build_no_tables():
    """On the CPU the bf16 operators run the plain versions: no table is
    made or kept on the plan, and no launch is counted."""
    ops = parallel.make_parallel_ops(ParallelGeometry(image_size=N, n_angles=24),
                                     dtype=torch.bfloat16, device="cpu")
    cuda_kernels.reset_launch_counts()
    x = torch.randn(1, N, N, generator=torch.Generator().manual_seed(23))
    ops.At(ops.A(x))
    assert ops.plan.pair_tables == {}
    assert cuda_kernels.build_pair_tables.launches == 0
    assert cuda_kernels.project_pair_group.launches_tc == 0
