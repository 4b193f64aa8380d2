"""The split-bf16 float32 route of the per-angle kernels
(pdunet_tpu_torch/ops/radon/csrc/radon_group_split.cu) on the CPU.

The kernels run only on a card (chip_smoke.py holds them against the plain
versions there). Here: the plain split tables (T̂ as bf16 hi and lo planes,
φ in float32), and the plain versions that run the kernels' arithmetic in
their order (F or h and T̂ split into hi and lo, three bf16 products with
f32 sums, φ, Ŝ and stages 2-3 in f32), against project_group_pallas /
backproject_group_pallas in interpret mode on the small plans of
tests/test_torch_group_tc.py, and against the JAX package's float32 einsum
twins at the radial serving shape (pdunet_radial's fourier-slice plan:
256², 128 golden-angle spokes of 512 samples, K = 256, S = 1024), which
guards the route's numerics at its longest depth: the split drops the lo·lo
term and rounds each lo part, ≈ 2⁻¹⁷ relative per operand, so the float32
contract (1e-5 relative) holds with a margin of a few times.
"""

import math
import types

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
from pdunet_tpu_torch.ops.nufft.dcf import resolve_dcf
from pdunet_tpu_torch.ops.radon import cuda_kernels, parallel

torch.set_num_threads(1)

N = 32
TOL = 1e-5
_GOLDEN = tuple((k * GOLDEN_ANGLE) % math.pi for k in range(16))
#: angles of each group at the serving shape (of its 64): the depth of one
#: call's stage 1ᵀ grows with them, its error does not
_SERVING_ANGLES = 16


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module", params=["radial", "golden"])
def plans(request):
    """(JAX, port) backing plans whose angles do not pair: the 32² radial
    fourier-slice plan (24 spokes of 64 samples) and a 32² parallel plan of
    16 golden angles."""
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


@pytest.fixture(scope="module")
def serving():
    """The pdunet_radial serving geometry: its fourier-slice plans (JAX,
    port) and the port's Pipe-Menon DCF."""
    geom = dict(image_size=256, n_spokes=128)
    jfs = jax_fs.build_fs_plan(JaxRadial(**geom))
    tfs = fs.build_fs_plan(RadialGeometry(**geom), device="cpu")
    dcf = np.asarray(resolve_dcf(RadialGeometry(**geom), "pipe_menon"), np.float32)
    return jfs, tfs, dcf


def _rows(plan, grp):
    return getattr(plan, f"pos_{grp}"), getattr(plan, f"shift_{grp}")


def _split_tables(tp, grp):
    return cuda_kernels.build_group_split_tables(*_rows(tp, grp), tp.spec, tp.meta["S_ext"])


@pytest.mark.parametrize("grp", ["x", "y"])
def test_split_tables_hold_the_f32_trig(plans, grp):
    """T̂ hi and lo are _split of the f32 trig of _spectral_tensors, bit
    for bit (hi + lo within 2⁻¹⁶ of T̂); φ is its f32 trig, bit for bit;
    zero padding."""
    _, tp = plans
    T, phi = _split_tables(tp, grp)
    A, K = tp.meta[f"A_{grp}"], tp.spec.shape[0]
    K2p = 128 * -(-2 * K // 128)
    assert T.dtype == torch.bfloat16 and T.shape == (2, A, 128, K2p)
    assert phi.dtype == torch.float32 and phi.shape == (1, A, 128, K2p)
    ref = cuda_kernels._spectral_tensors(*_rows(tp, grp), tp.spec, tp.meta["S_ext"])
    for ri in range(2):
        hi, lo = cuda_kernels._split(ref[ri])
        torch.testing.assert_close(T[0, :, :N, ri:2 * K:2].float(), hi, rtol=0, atol=0)
        torch.testing.assert_close(T[1, :, :N, ri:2 * K:2].float(), lo, rtol=0, atol=0)
        err = (hi + lo - ref[ri]).abs()
        assert bool((err <= 2.0 ** -16 * ref[ri].abs()).all())
        torch.testing.assert_close(phi[0, :, :N, ri:2 * K:2], ref[2 + ri], rtol=0, atol=0)
    assert not T[:, :, N:].any() and not T[..., 2 * K:].any()
    assert not phi[:, :, N:].any() and not phi[..., 2 * K:].any()
    # the lo plane carries what bf16 drops: without it T̂ is off by ~2⁻⁹
    assert T[1].float().abs().max() > 0


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
def test_split_forward_matches_pallas_interpret(plans, contract_x):
    jp, tp = plans
    grp = "x" if contract_x else "y"
    L = tp.meta["S_ext"]
    f = np.random.default_rng(41).standard_normal((2, N, N)).astype(np.float32)
    ref = project_group_pallas(jnp.asarray(f), *_rows(jp, grp), jp.spec, jp.Wc, jp.Ws, L,
                               contract_x, interpret=True)
    out = cuda_kernels._group_forward_tc(torch.from_numpy(f), _split_tables(tp, grp), tp.Wc,
                                         tp.Ws, contract_x, torch.float32)
    assert out.shape == ref.shape == (2, tp.meta[f"A_{grp}"], tp.meta["S"])
    assert rel(out, ref) < TOL


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
@pytest.mark.parametrize("G", [1, 3])
def test_split_adjoint_matches_pallas_interpret(plans, contract_x, G):
    jp, tp = plans
    grp = "x" if contract_x else "y"
    L, A, S = tp.meta["S_ext"], tp.meta[f"A_{grp}"], tp.meta["S"]
    p = np.random.default_rng(42).standard_normal((2, A, S)).astype(np.float32)
    ref = backproject_group_pallas(jnp.asarray(p), *_rows(jp, grp), jp.spec, jp.Wc, jp.Ws, L,
                                   contract_x, N, interpret=True)
    out = cuda_kernels._group_adjoint_tc(torch.from_numpy(p), _split_tables(tp, grp), tp.Wc,
                                         tp.Ws, contract_x, N, G, torch.float32)
    assert out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < TOL


def _serving_inputs(tfs, dcf):
    """A complex phantom (ellipses, a phase ramp, a little noise) as the
    (Re, Im) batch the projector sees, and the kernel input of the DCF
    adjoint: the port's A of that phantom, weighted by the DCF, split into
    the (Re, Im) components of fs_nufft_adjoint. Made with numpy from a
    seed, in the port's float32."""
    n = tfs.meta["N"]
    rng = np.random.default_rng(43)
    yy, xx = np.mgrid[:n, :n] / n - 0.5
    mag = ((xx ** 2 / 0.16 + yy ** 2 / 0.09 < 1) * 1.0
           + (xx ** 2 / 0.01 + (yy - 0.1) ** 2 / 0.04 < 1) * 0.5
           + 0.05 * rng.standard_normal((n, n)))
    z = torch.from_numpy((mag * np.exp(1j * np.pi * xx)).astype(np.complex64))[None]
    with torch.no_grad():
        k = fs.fs_nufft_forward(tfs, z) * torch.from_numpy(dcf)
    sg = tfs.sgn[None, :, None]
    q = torch.cat([torch.cat([k.real, sg * k.imag], dim=-1),
                   torch.cat([k.imag, -sg * k.real], dim=-1)], dim=0)   # (2, A, 2M)
    u = torch.cat([z.real, z.imag], dim=0)                               # (2, N, N)
    return u.contiguous(), q.contiguous()


@pytest.mark.parametrize("contract_x", [True, False], ids=["x", "y"])
def test_split_matches_jax_einsum_at_serving_shape(serving, contract_x):
    """The numerics guard at the radial serving shape (the first
    _SERVING_ANGLES spokes of each group, B' = 2): the tiled split forward
    on a complex phantom and the tiled split adjoint on its DCF-weighted
    k-space (what fbp sends) and on a white p (the largest error), against
    the JAX float32 einsum twins."""
    jfs, tfs, dcf = serving
    jp, tp = jfs.par_plan, tfs.par_plan
    grp = "x" if contract_x else "y"
    m = tp.meta
    assert (m["N"], m["K"], m["S"]) == (256, 256, 1024) and m[f"A_{grp}"] >= _SERVING_ANGLES
    n, L = m["N"], m["S_ext"]
    sel = slice(0, _SERVING_ANGLES)
    jrows = [jnp.asarray(r)[sel] for r in _rows(jp, grp)]
    trows = [r[sel].contiguous() for r in _rows(tp, grp)]
    u, q = _serving_inputs(tfs, dcf)
    p = q.index_select(1, tp.index(f"idx_{grp}")[sel]).contiguous()
    tab = cuda_kernels._group_split_tables(*trows, tp.spec, L)
    ref = jax_parallel._project_group(jnp.asarray(u.numpy()), *jrows, jp.spec, jp.Wc, jp.Ws, L,
                                      contract_x)
    out = cuda_kernels._group_forward_tc(u, tab, tp.Wc, tp.Ws, contract_x, torch.float32)
    assert rel(out, ref) < TOL
    # the DCF-weighted k-space, and a white p, the split's worst case
    white = torch.from_numpy(
        np.random.default_rng(46).standard_normal(tuple(p.shape)).astype(np.float32))
    G = cuda_kernels.group_adjoint_splits(2, n, _SERVING_ANGLES, 132, cols=128)
    for pp in (p, white):
        ref = jax_parallel._backproject_group(jnp.asarray(pp.numpy()), *jrows, jp.spec, jp.Wc,
                                              jp.Ws, L, contract_x)
        out = cuda_kernels._group_adjoint_tc(pp, tab, tp.Wc, tp.Ws, contract_x, n, G,
                                             torch.float32)
        assert rel(out, ref) < TOL


@pytest.mark.parametrize("grp", ["x", "y"])
def test_split_group_dot_test(plans, grp):
    """<A x, y> = <x, A† y> to 1e-5 for the plain split per-angle pair (the
    split rounds the two sides' operands differently, so not to machine
    precision). y = A x plus a random sinogram of the same norm: <A x, y>
    stays near ‖A x‖², so the mismatch reads the pair's error and not the
    ratio of two near-zero random dot products."""
    _, tp = plans
    cx = grp == "x"
    tab = _split_tables(tp, grp)
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.standard_normal((2, N, N)).astype(np.float32))
    ax = cuda_kernels._group_forward_tc(x, tab, tp.Wc, tp.Ws, cx, torch.float32)
    r = torch.from_numpy(rng.standard_normal(tuple(ax.shape)).astype(np.float32))
    y = ax + r * (ax.norm() / r.norm())
    aty = cuda_kernels._group_adjoint_tc(y, tab, tp.Wc, tp.Ws, cx, N, 2, torch.float32)
    lhs = torch.vdot(ax.double().flatten(), y.double().flatten())
    rhs = torch.vdot(x.double().flatten(), aty.double().flatten())
    assert float(abs(lhs - rhs) / abs(lhs)) < TOL


def test_cuda_f32_call_without_tables_raises(plans, monkeypatch):
    """The per-angle float32 route needs the plan's split tables: a CUDA
    float32 call without them raises before any launch (no fallback to
    another kernel); the bf16 route's tables are refused too."""
    _, tp = plans
    monkeypatch.setattr(cuda_kernels, "_check_device", lambda x: None)
    cuda_kernels.reset_launch_counts()
    args = (*_rows(tp, "x"), tp.spec, tp.Wc, tp.Ws, tp.meta["S_ext"], True)
    f = torch.zeros(1, N, N, device="meta")
    with pytest.raises(ValueError, match="split trig tables"):
        cuda_kernels.project_group(f, *args)
    p = torch.zeros(1, tp.meta["A_x"], tp.meta["S"], device="meta")
    with pytest.raises(ValueError, match="split trig tables"):
        cuda_kernels.backproject_group(p, *args, N)
    tab = cuda_kernels._group_tables(*_rows(tp, "x"), tp.spec, tp.meta["S_ext"])
    with pytest.raises(ValueError, match="split trig tables"):
        cuda_kernels.project_group(f, *args, tables=tab)
    assert cuda_kernels.project_group.launches == cuda_kernels.backproject_group.launches == 0


def test_cpu_f32_operators_build_no_split_tables():
    """On the CPU the float32 radial operators run the plain versions: no
    split table is made or kept on the plan, and no launch is counted."""
    ops = make_radial_ops(RadialGeometry(image_size=N, n_spokes=24), dtype=torch.float32,
                          device="cpu")
    cuda_kernels.reset_launch_counts()
    gen = torch.Generator().manual_seed(45)
    x = torch.complex(torch.randn(1, N, N, generator=gen), torch.randn(1, N, N, generator=gen))
    ops.fbp(ops.A(x))
    pp = ops.plan.par_plan
    assert pp.group_split_tables == {} and pp.group_tables == {}
    assert cuda_kernels.build_group_split_tables.launches == 0
    assert cuda_kernels.project_group.launches_split == 0
    assert cuda_kernels.backproject_group.launches_split == 0


def test_cuda_f32_plan_builds_split_tables_once_per_group(plans, monkeypatch):
    """parallel.py hands a CUDA float32 per-angle call the plan's split
    tables, built at the first call of each group (build_group_split_tables
    of the group's rows) and kept in plan.group_split_tables; bf16 calls
    keep their own store."""
    _, tp = plans
    built = []

    def fake_build(pos, shift, spec, L):
        built.append((pos, shift))
        return ("T", "phi")

    monkeypatch.setattr(parallel, "build_group_split_tables", fake_build)
    monkeypatch.setattr(tp, "group_split_tables", {})
    x = types.SimpleNamespace(device=torch.device("cuda"))
    for grp in ("x", "y", "x", "y"):
        assert parallel._tables(tp, grp, x, torch.float32) == ("T", "phi")
    assert [(p is tp.pos_x, s is tp.shift_x) for p, s in built[:1]] == [(True, True)]
    assert len(built) == 2 and built[1][0] is tp.pos_y
    assert set(tp.group_split_tables) == {"x", "y"} and tp.group_tables == {}


def test_split_adjoint_fills_one_wave():
    """The split adjoint's 128-column tiles take the one-wave rule: 32 tiles
    at the radial serving shape (B' = 8, N = 256) → 4 slices on 132 SMs
    (128 blocks, where 5 would start a second wave)."""
    G = cuda_kernels.group_adjoint_splits(8, 256, 64, 132, cols=128)
    assert G == 4 and 8 * 2 * 2 * G <= 132 < 8 * 2 * 2 * (G + 1)
    assert cuda_kernels.group_adjoint_splits(2, 256, 64, 132, cols=128) == 16
    assert cuda_kernels.group_adjoint_splits(256, 256, 64, 132, cols=128) == 1
    # the bf16 route keeps its 256-column tiles
    assert cuda_kernels.group_adjoint_splits(8, 256, 64, 132) == 8
