"""The port's kernel probes (pdunet_tpu_torch/ops/radon/proto_kernels.py)
against the JAX probe scripts' Pallas bodies.

scripts/trig_proto.py and scripts/pack_proto.py are loaded by path and their
pallas_calls run in interpret mode on the CPU, at 32² with 24 angles and
batch 2, for the x and y groups, float32 and bf16 operands. On the CPU the
port's wrappers run their plain versions. Tolerances (relative norm): 1e-5
in float32, 5e-3 with bf16 operands (bf16 operands rounded at the same
points but products summed in another order), as in
tests/test_pallas_kernels.py. The kernels themselves run only on a card:
chip_smoke.py holds them against the same plain versions there.
"""

import importlib.util
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.geometry import build_parallel_plan as jax_plan
from pdunet_tpu.ops.radon.pallas_kernels import _doubling_trig_rows
from pdunet_tpu_torch.geometry import ParallelGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.radon import cuda_kernels, proto_kernels

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N = 32
_BF16 = [(False, 1e-5), (True, 5e-3)]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trig_proto():
    return _load("trig_proto")


@pytest.fixture(scope="module")
def pack_proto():
    return _load("pack_proto")


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _plans(bf16):
    kw = dict(image_size=N, n_angles=24, det_count=N)
    jp = jax_plan(JaxGeometry(**kw), dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tp = build_parallel_plan(ParallelGeometry(**kw),
                             dtype=torch.bfloat16 if bf16 else torch.float32,
                             device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def plans():
    return {bf16: _plans(bf16) for bf16 in (False, True)}


def _cdt(bf16):
    return torch.bfloat16 if bf16 else torch.float32


def _image(seed=1):
    return np.random.default_rng(seed).standard_normal((2, N, N)).astype(np.float32)


@pytest.mark.parametrize("n", [32, 256])
def test_doubling_rows_match_jax(n):
    """The port's doubling helper against the Pallas helper, at the seed
    sizes the plans give (row-0 phases of hundreds of rad, steps ≤ π)."""
    torch.set_num_threads(1)
    rng = np.random.default_rng(n)
    K = 97
    th0 = (rng.uniform(-400.0, 400.0, (1, K))).astype(np.float32)
    dth = (rng.uniform(-np.pi, np.pi, (1, K))).astype(np.float32)
    cj, sj = _doubling_trig_rows(jnp.asarray(th0), jnp.asarray(dth), n)
    ct, st = proto_kernels.doubling_trig_rows(torch.from_numpy(th0[0]),
                                              torch.from_numpy(dth[0]), n)
    assert ct.shape == st.shape == (n, K) == cj.shape
    assert rel(ct, cj) < 1e-5 and rel(st, sj) < 1e-5
    # and the drift from exact trig stays at the N·eps_f32 scale
    j = np.arange(n)[:, None]
    exact = np.cos(th0.astype(np.float64) + j * dth.astype(np.float64))
    assert rel(ct, exact) < 1e-3


@pytest.mark.parametrize("grp", ["x", "y"])
def test_phase_seeds_match_jax(trig_proto, plans, grp):
    jp, tp = plans[False]
    K, L = tp.meta["K"], tp.meta["S_ext"]
    ref = trig_proto._phase_seeds(jp, grp, K, L)
    out = proto_kernels.phase_seeds(*(getattr(tp, f"pair_{nm}_{grp}")
                                      for nm in ("pos", "sha", "shb")), K, L)
    for o, r in zip(out, ref):
        assert o.dtype == np.float32 and o.shape == (tp.meta[f"P_{grp}"], 3 * K)
        np.testing.assert_array_equal(o, r)


def _pair_rows(plan, grp):
    return [getattr(plan, f"pair_{nm}_{grp}") for nm in ("pos", "sha", "shb", "sgn")]


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_pair_doubling_matches_jax(trig_proto, plans, grp, bf16, tol):
    jp, tp = plans[bf16]
    K, L = tp.meta["K"], tp.meta["S_ext"]
    f = _image()
    seeds = trig_proto._phase_seeds(jp, grp, K, L)
    ref = trig_proto.call_pair_fwd(trig_proto._fwd_pair_kernel_doubling, jnp.asarray(f),
                                   jp, grp, grp == "x", bf16, interpret=True,
                                   extra=tuple(jnp.asarray(s) for s in seeds))
    s0, st = (torch.from_numpy(s) for s in
              proto_kernels.phase_seeds(*_pair_rows(tp, grp)[:3], K, L))
    out = proto_kernels.project_pair_group_doubling(
        torch.from_numpy(f), s0, st, getattr(tp, f"pair_sgn_{grp}"), tp.spec, tp.Wc,
        tp.Ws, grp == "x", cdt=_cdt(bf16))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol
    # doubling stays within the probe's 2e-2 of the exact-trig pair operator
    exact = cuda_kernels.project_pair_group(torch.from_numpy(f), *_pair_rows(tp, grp),
                                            tp.spec, tp.Wc, tp.Ws, L, grp == "x",
                                            cdt=_cdt(bf16))
    assert rel(out, exact) < 2e-2


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_pair_notrig_matches_jax(trig_proto, plans, grp, bf16, tol):
    """Its numbers are not a projection (|p| reaches ~1e5), so only the
    relative norm against the JAX body means anything."""
    jp, tp = plans[bf16]
    L = tp.meta["S_ext"]
    f = _image(2)
    ref = trig_proto.call_pair_fwd(trig_proto._fwd_pair_kernel_notrig, jnp.asarray(f),
                                   jp, grp, grp == "x", bf16, interpret=True)
    out = proto_kernels.project_pair_group_notrig(
        torch.from_numpy(f), *_pair_rows(tp, grp), tp.spec, tp.Wc, tp.Ws, L,
        grp == "x", cdt=_cdt(bf16))
    assert out.shape == ref.shape
    assert rel(out, ref) < tol


def _group_rows(plan, grp):
    return (getattr(plan, f"pos_{grp}"), getattr(plan, f"shift_{grp}"), plan.spec,
            plan.Wc, plan.Ws, plan.meta["S_ext"], grp == "x")


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_packed_forward_matches_jax(pack_proto, plans, grp, bf16, tol):
    """bf16: each half of the packed rows is rounded on its own and the trig
    is block doubling, as the packed Pallas body does."""
    jp, tp = plans[bf16]
    f = _image(3)
    ref = pack_proto.call_fwd(pack_proto._fwd_kernel_packed, jnp.asarray(f),
                              *_group_rows(jp, grp), bf16, interpret=True)
    out = proto_kernels.project_group_packed(torch.from_numpy(f), *_group_rows(tp, grp),
                                             cdt=_cdt(bf16))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert rel(out, ref) < tol


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_packed_adjoint_matches_jax(pack_proto, plans, grp, bf16, tol):
    """call_adj leaves the y group untransposed; the port's adjoints return
    it transposed, as backproject_group does."""
    jp, tp = plans[bf16]
    A = tp.meta[f"A_{grp}"]
    p = np.random.default_rng(4).standard_normal((2, A, N)).astype(np.float32)
    ref = np.asarray(pack_proto.call_adj(pack_proto._adj_kernel_packed, jnp.asarray(p),
                                         *_group_rows(jp, grp), N, bf16, interpret=True))
    if grp == "y":
        ref = ref.transpose(0, 2, 1)
    out = proto_kernels.backproject_group_packed(torch.from_numpy(p),
                                                 *_group_rows(tp, grp), N, cdt=_cdt(bf16))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < tol


@pytest.mark.parametrize("grp", ["x", "y"])
def test_packed_equals_shipped_per_angle_in_f32(plans, grp):
    _, tp = plans[False]
    f = torch.from_numpy(_image(5))
    fwd = proto_kernels.project_group_packed(f, *_group_rows(tp, grp))
    assert rel(fwd, cuda_kernels.project_group(f, *_group_rows(tp, grp))) < 1e-5
    p = torch.randn(2, tp.meta[f"A_{grp}"], N, generator=torch.Generator().manual_seed(6))
    adj = proto_kernels.backproject_group_packed(p, *_group_rows(tp, grp), N)
    assert rel(adj, cuda_kernels.backproject_group(p, *_group_rows(tp, grp), N)) < 1e-5


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("doubling", [False, True], ids=["exact", "doubling"])
def test_packed_adjoint_dot_product(plans, grp, doubling):
    """Forward and adjoint generate the same trig tensors, exact or doubled,
    so the packed pair is an exact transpose in float32."""
    _, tp = plans[False]
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(3, N, N, generator=gen)
    y = torch.randn(3, tp.meta[f"A_{grp}"], N, generator=gen)
    ax = proto_kernels.project_group_packed(x, *_group_rows(tp, grp), doubling=doubling)
    aty = proto_kernels.backproject_group_packed(y, *_group_rows(tp, grp), N,
                                                 doubling=doubling)
    lhs = torch.vdot(ax.flatten().double(), y.flatten().double())
    rhs = torch.vdot(x.flatten().double(), aty.flatten().double())
    assert abs(lhs - rhs) / abs(lhs) < 1e-5


def test_cpu_calls_count_no_launches_and_other_devices_raise(plans):
    _, tp = plans[False]
    K, L = tp.meta["K"], tp.meta["S_ext"]
    proto_kernels.reset_launch_counts()
    f = torch.from_numpy(_image(8))
    s0, st = (torch.from_numpy(s) for s in
              proto_kernels.phase_seeds(*_pair_rows(tp, "x")[:3], K, L))
    proto_kernels.project_pair_group_doubling(f, s0, st, tp.pair_sgn_x, tp.spec, tp.Wc,
                                              tp.Ws, True)
    proto_kernels.project_pair_group_notrig(f, *_pair_rows(tp, "x"), tp.spec, tp.Wc,
                                            tp.Ws, L, True)
    p = proto_kernels.project_group_packed(f, *_group_rows(tp, "x"))
    proto_kernels.backproject_group_packed(p, *_group_rows(tp, "x"), N)
    for fn in (proto_kernels.project_pair_group_doubling,
               proto_kernels.project_pair_group_notrig,
               proto_kernels.project_group_packed,
               proto_kernels.backproject_group_packed):
        assert fn.launches == 0
    meta = torch.zeros(1, N, N, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        proto_kernels.project_group_packed(meta, *_group_rows(tp, "x"))
    with pytest.raises(ValueError, match="no kernel"):
        proto_kernels.project_pair_group_doubling(meta, s0, st, tp.pair_sgn_x, tp.spec,
                                                  tp.Wc, tp.Ws, True)


@pytest.mark.parametrize("script", ["trig_proto", "pack_proto"])
def test_probe_scripts_run_on_cpu(script, capsys):
    """``python -m pdunet_tpu_torch.scripts.<probe> --cpu``: the plain
    versions at 32² pass the scripts' own checks and skip the timing."""
    import importlib

    mod = importlib.import_module(f"pdunet_tpu_torch.scripts.{script}")
    assert mod.main(["--cpu"]) == 0
    out = capsys.readouterr().out
    assert "rel-err" in out and "(no timing)" in out
