"""The tensor-core route of the per-angle kernels
(pdunet_tpu_torch/ops/radon/csrc/radon_group_tc.cu) on the CPU.

The kernels run only on a card (chip_smoke.py holds them against the plain
versions there). Here, on two plans whose angles do not pair — the 32²
radial fourier-slice plan (24 golden-angle spokes of 64 samples; K = L/2,
W a ±1 selection) and a 32² parallel plan of 16 golden angles (K = L//2+1)
— the plain trig-table builder (layout, re/im interleave, zero padding)
against the port's and the JAX package's _spectral_tensors; the adjoint's
depth split; and the plain versions that read the tables, pad, split and
sum in the kernels' order, against project_group_pallas /
backproject_group_pallas in interpret mode in float32 and against the
einsum twins with bf16 operands (the Pallas kernels make their bf16 trig
by block doubling, the port reads exact trig from the tables).
Tolerances (relative norm): 1e-5 in float32, 5e-3 with bf16 operands.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import GOLDEN_ANGLE
from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.geometry import RadialGeometry as JaxRadial
from pdunet_tpu.geometry import build_parallel_plan as jax_plan
from pdunet_tpu.ops.nufft import fourier_slice as jax_fs
from pdunet_tpu.ops.radon import parallel as jax_parallel
from pdunet_tpu.ops.radon.pallas_kernels import (
    backproject_group_pallas,
    project_group_pallas,
)
from pdunet_tpu_torch.geometry import ParallelGeometry, RadialGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.nufft import fourier_slice as fs
from pdunet_tpu_torch.ops.nufft import make_radial_ops
from pdunet_tpu_torch.ops.radon import cuda_kernels

torch.set_num_threads(1)

N = 32
_BF16 = [(False, 1e-5), (True, 5e-3)]
_GOLDEN = tuple((k * GOLDEN_ANGLE) % math.pi for k in range(16))


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module", params=["radial", "golden"])
def plans(request):
    """(JAX, port) backing plans whose angles do not pair."""
    if request.param == "radial":
        geom = dict(image_size=N, n_spokes=24)
        jp = jax_fs.build_fs_plan(JaxRadial(**geom)).par_plan
        tp = fs.build_fs_plan(RadialGeometry(**geom), device="cpu").par_plan
    else:
        jp = jax_plan(JaxGeometry(image_size=N, angles=_GOLDEN))
        tp = build_parallel_plan(ParallelGeometry(image_size=N, angles=_GOLDEN),
                                 device="cpu")
    assert not tp.meta["use_pairs"] and tp.meta["A_x"] and tp.meta["A_y"]
    return jp, tp


def _rows(plan, grp):
    return getattr(plan, f"pos_{grp}"), getattr(plan, f"shift_{grp}")


def _cdt(bf16):
    return torch.bfloat16 if bf16 else torch.float32


@pytest.mark.parametrize("grp", ["x", "y"])
def test_tables_layout_matches_spectral_tensors(plans, grp):
    _, tp = plans
    pos, shift = _rows(tp, grp)
    L, K = tp.meta["S_ext"], tp.spec.shape[0]
    tab = cuda_kernels.build_group_tables(pos, shift, tp.spec, L)
    A = pos.shape[0]
    Np, K2p = 128, 128 * -(-2 * K // 128)
    assert tab.dtype == torch.bfloat16 and tab.shape == (2, A, Np, K2p)
    assert K2p > 2 * K and Np > N  # both paddings are exercised
    ref = cuda_kernels._spectral_tensors(pos, shift, tp.spec, L, torch.bfloat16)
    for t in range(2):
        for ri in range(2):
            torch.testing.assert_close(tab[t, :, :N, ri:2 * K:2].float(), ref[2 * t + ri],
                                       rtol=0, atol=0)
    assert not tab[:, :, N:].any() and not tab[..., 2 * K:].any()


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_tables_match_jax_spectral_tensors(plans, grp, bf16):
    jp, tp = plans
    L, K = tp.meta["S_ext"], tp.spec.shape[0]
    ref = jax_parallel._spectral_tensors(*_rows(jp, grp), jp.spec, L,
                                         cdt=jnp.bfloat16 if bf16 else jnp.float32)
    tab = cuda_kernels._group_tables(*_rows(tp, grp), tp.spec, L, _cdt(bf16)).float()
    for i, r in enumerate(ref):
        t, ri = divmod(i, 2)
        # the trig of the two libraries differs in the last f32 bit, which
        # can flip a bf16 rounding
        assert rel(tab[t, :, :N, ri:2 * K:2], np.asarray(r, np.float32)) < (
            5e-3 if bf16 else 1e-6)


def test_group_adjoint_splits_fill_the_card():
    """One full wave of one block per SM at the radial serving shape
    (B' = 8, N = 256, A = 64 on 132 SMs: 16 tiles x 8 slices = 128 blocks,
    where 9 slices would start a second, nearly empty wave), no split once
    the tiles alone fill the card, never more slices than angles."""
    G = cuda_kernels.group_adjoint_splits(8, 256, 64, 132)
    assert G == 8 and 8 * 2 * 1 * G <= 132 < 8 * 2 * 1 * (G + 1)
    assert cuda_kernels.group_adjoint_splits(2, 256, 64, 132) == 33
    assert cuda_kernels.group_adjoint_splits(256, 256, 64, 132) == 1
    assert cuda_kernels.group_adjoint_splits(1, 32, 12, 132) == 12


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_tiled_forward_matches_jax(plans, contract_x, bf16, tol):
    """f32: against project_group_pallas in interpret mode; bf16: against
    the JAX einsum twin. Both: against the port's plain version."""
    jp, tp = plans
    grp = "x" if contract_x else "y"
    L = tp.meta["S_ext"]
    f = np.random.default_rng(31).standard_normal((2, N, N)).astype(np.float32)
    jargs = (*_rows(jp, grp), jp.spec, jp.Wc, jp.Ws, L, contract_x)
    if bf16:
        ref = jax_parallel._project_group(jnp.asarray(f), *jargs, cdt=jnp.bfloat16)
    else:
        ref = project_group_pallas(jnp.asarray(f), *jargs, interpret=True)
    tab = cuda_kernels._group_tables(*_rows(tp, grp), tp.spec, L, _cdt(bf16))
    out = cuda_kernels._group_forward_tc(torch.from_numpy(f), tab, tp.Wc, tp.Ws,
                                         contract_x, _cdt(bf16))
    assert out.shape == ref.shape == (2, tp.meta[f"A_{grp}"], tp.meta["S"])
    assert rel(out, ref) < tol
    plain = cuda_kernels._project_group(torch.from_numpy(f), *_rows(tp, grp), tp.spec,
                                        tp.Wc, tp.Ws, L, contract_x, _cdt(bf16))
    assert rel(out, plain) < tol


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
@pytest.mark.parametrize("G", [1, 3])
def test_tiled_adjoint_matches_jax(plans, contract_x, bf16, tol, G):
    jp, tp = plans
    grp = "x" if contract_x else "y"
    L, A, S = tp.meta["S_ext"], tp.meta[f"A_{grp}"], tp.meta["S"]
    p = np.random.default_rng(32).standard_normal((2, A, S)).astype(np.float32)
    jargs = (*_rows(jp, grp), jp.spec, jp.Wc, jp.Ws, L, contract_x)
    if bf16:
        ref = jax_parallel._backproject_group(jnp.asarray(p), *jargs, cdt=jnp.bfloat16)
    else:
        ref = backproject_group_pallas(jnp.asarray(p), *jargs, N, interpret=True)
    tab = cuda_kernels._group_tables(*_rows(tp, grp), tp.spec, L, _cdt(bf16))
    out = cuda_kernels._group_adjoint_tc(torch.from_numpy(p), tab, tp.Wc, tp.Ws,
                                         contract_x, N, G, _cdt(bf16))
    assert out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < tol
    plain = cuda_kernels._backproject_group(torch.from_numpy(p), *_rows(tp, grp), tp.spec,
                                            tp.Wc, tp.Ws, L, contract_x, _cdt(bf16))
    assert rel(out, plain) < tol


@pytest.mark.parametrize("grp", ["x", "y"])
def test_tiled_pair_adjoint_dot_product(plans, grp):
    """The tiled forward and adjoint are exact transposes in float32; with
    bf16 operands (each side rounds its own operands) the mismatch is no
    worse than the plain bf16 pair's, the check chip_smoke.py makes on the
    card."""
    _, tp = plans
    cx = grp == "x"
    L, A, S = tp.meta["S_ext"], tp.meta[f"A_{grp}"], tp.meta["S"]
    gen = torch.Generator().manual_seed(33)
    x = torch.randn(3, N, N, generator=gen)
    y = torch.randn(3, A, S, generator=gen)

    def mismatch(fwd, adj):
        lhs = torch.vdot(fwd(x).double().flatten(), y.double().flatten())
        rhs = torch.vdot(x.double().flatten(), adj(y).double().flatten())
        return float(abs(lhs - rhs) / abs(lhs))

    rows = (*_rows(tp, grp), tp.spec, tp.Wc, tp.Ws, L, cx)
    for cdt in (torch.float32, torch.bfloat16):
        tab = cuda_kernels._group_tables(*_rows(tp, grp), tp.spec, L, cdt)
        tiled = mismatch(lambda v: cuda_kernels._group_forward_tc(v, tab, tp.Wc, tp.Ws, cx, cdt),
                         lambda v: cuda_kernels._group_adjoint_tc(v, tab, tp.Wc, tp.Ws, cx, N, 2,
                                                                  cdt))
        if cdt == torch.float32:
            assert tiled < 1e-5
        else:
            plain = mismatch(lambda v: cuda_kernels._project_group(v, *rows, cdt),
                             lambda v: cuda_kernels._backproject_group(v, *rows, cdt))
            assert tiled <= 2 * plain + 1e-4


def test_cuda_bf16_call_without_tables_raises(plans, monkeypatch):
    """The tensor-core route needs the plan's tables: a CUDA bf16 call
    without them raises before any launch (no fallback to the split route
    or the plain version)."""
    _, tp = plans
    monkeypatch.setattr(cuda_kernels, "_check_device", lambda x: None)
    args = (*_rows(tp, "x"), tp.spec, tp.Wc, tp.Ws, tp.meta["S_ext"], True)
    f = torch.zeros(1, N, N, device="meta")
    with pytest.raises(ValueError, match="trig tables"):
        cuda_kernels.project_group(f, *args, cdt=torch.bfloat16)
    p = torch.zeros(1, tp.meta["A_x"], tp.meta["S"], device="meta")
    with pytest.raises(ValueError, match="trig tables"):
        cuda_kernels.backproject_group(p, *args, N, cdt=torch.bfloat16)
    assert cuda_kernels.project_group.launches_tc == 0


def test_cpu_operators_build_no_tables():
    """On the CPU the bf16 radial operators run the plain versions: no
    table is made or kept on the plan, and no launch is counted."""
    ops = make_radial_ops(RadialGeometry(image_size=N, n_spokes=24), dtype=torch.bfloat16,
                          device="cpu")
    cuda_kernels.reset_launch_counts()
    gen = torch.Generator().manual_seed(34)
    x = torch.complex(torch.randn(1, N, N, generator=gen), torch.randn(1, N, N, generator=gen))
    ops.At(ops.A(x))
    assert ops.plan.par_plan.group_tables == {} and ops.plan.par_plan.pair_tables == {}
    assert cuda_kernels.build_group_tables.launches == 0
    assert cuda_kernels.project_group.launches == cuda_kernels.project_group.launches_tc == 0
    assert cuda_kernels.backproject_group.launches_tc == 0
