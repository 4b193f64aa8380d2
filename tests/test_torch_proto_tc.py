"""The packed per-angle probe's tensor-core route
(pdunet_tpu_torch/ops/radon/csrc/radon_proto_tc.cu, through
ops/radon/proto_kernels.py) on the CPU.

The kernels run only on a card (chip_smoke.py holds them against the plain
versions there). Here:
  * the packed plain versions against the Pallas bodies of
    scripts/pack_proto.py (loaded by path, interpret mode) on a radial
    fourier-slice plan (32², 24 golden-angle spokes of 64 samples: K = L/2,
    W a ±1 selection), both groups; tolerances (relative norm) 1e-5 in
    float32, 5e-3 with bf16 operands (the Pallas body makes its bf16 trig
    by block doubling, as the plain version does);
  * the plan rows that block doubling seeds from (row[0] and row[1] − row[0])
    are affine in the row index within float32 rounding on the parallel,
    fan-backing and radial plans, so the kernels may take them;
  * the kernels' doubling, each row the seed rotated by the rotors of its
    index's set bits (lowest first, shared along a tree of rows), is
    doubling_trig_rows bit for bit, so no other plain twin is needed;
  * routing: CPU calls run the plain versions and launch nothing, and a
    CUDA call hands the C entry point one argument per declared type, which
    match the C signature.
"""

import importlib.util
import math
import pathlib
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdunet_tpu.geometry import RadialGeometry as JaxRadial
from pdunet_tpu.ops.nufft import fourier_slice as jax_fs
from pdunet_tpu_torch.geometry import (
    FanGeometry,
    ParallelGeometry,
    RadialGeometry,
    build_parallel_plan,
)
from pdunet_tpu_torch.ops.nufft import fourier_slice as fs
from pdunet_tpu_torch.ops.radon import proto_kernels
from pdunet_tpu_torch.ops.radon.fan import build_fan_plan

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
N = 32
_BF16 = [(False, 1e-5), (True, 5e-3)]
_RADIAL = dict(image_size=N, n_spokes=24)


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def pack_proto():
    return _load("pack_proto")


@pytest.fixture(scope="module")
def radial():
    """(JAX, port) backing plans of the 32² radial fourier-slice plan."""
    jp = jax_fs.build_fs_plan(JaxRadial(**_RADIAL)).par_plan
    tp = fs.build_fs_plan(RadialGeometry(**_RADIAL), device="cpu").par_plan
    assert not tp.meta["use_pairs"] and tp.meta["S_ext"] % 2 == 0
    return jp, tp


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rows(plan, grp):
    return (getattr(plan, f"pos_{grp}"), getattr(plan, f"shift_{grp}"), plan.spec,
            plan.Wc, plan.Ws, plan.meta["S_ext"], grp == "x")


def _cdt(bf16):
    return torch.bfloat16 if bf16 else torch.float32


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_packed_forward_matches_jax_on_radial_plan(pack_proto, radial, grp, bf16, tol):
    jp, tp = radial
    f = np.random.default_rng(11).standard_normal((2, N, N)).astype(np.float32)
    ref = pack_proto.call_fwd(pack_proto._fwd_kernel_packed, jnp.asarray(f),
                              *_rows(jp, grp), bf16, interpret=True)
    out = proto_kernels.project_group_packed(torch.from_numpy(f), *_rows(tp, grp),
                                             cdt=_cdt(bf16))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    assert out.shape == (2, tp.meta[f"A_{grp}"], tp.meta["S"])
    assert rel(out, ref) < tol


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
def test_packed_adjoint_matches_jax_on_radial_plan(pack_proto, radial, grp, bf16, tol):
    """call_adj leaves the y group untransposed; the port returns it
    transposed, as backproject_group does."""
    jp, tp = radial
    A, S = tp.meta[f"A_{grp}"], tp.meta["S"]
    p = np.random.default_rng(12).standard_normal((2, A, S)).astype(np.float32)
    ref = np.asarray(pack_proto.call_adj(pack_proto._adj_kernel_packed, jnp.asarray(p),
                                         *_rows(jp, grp), N, bf16, interpret=True))
    if grp == "y":
        ref = ref.transpose(0, 2, 1)
    out = proto_kernels.backproject_group_packed(torch.from_numpy(p), *_rows(tp, grp), N,
                                                 cdt=_cdt(bf16))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, N, N)
    assert rel(out, ref) < tol


def _plan(kind, n):
    if kind == "parallel":
        return build_parallel_plan(
            ParallelGeometry(image_size=n, n_angles=360 if n == 256 else 96).subsample(4),
            device="cpu")
    if kind == "fan":
        return build_fan_plan(FanGeometry(image_size=n, n_angles=40), device="cpu").par_plan
    return fs.build_fs_plan(RadialGeometry(image_size=n, n_spokes=128 if n == 256 else 24),
                            device="cpu").par_plan


@pytest.mark.parametrize("n", [32, 256])
@pytest.mark.parametrize("kind", ["parallel", "fan", "radial"])
def test_plan_rows_are_affine(kind, n):
    """Every row family a doubling kernel seeds from (per angle: pos, shift;
    per pair: pos, sha, shb) is affine in j within the float32 rounding of
    its elements: |row[j] − row[0] − j·(row[1] − row[0])| ≤ N·2⁻²³·max|row|
    (each element is within half an ulp, ≤ 2⁻²⁴·max|row|, of the exact
    affine value, and the extrapolation multiplies the first difference's
    error by j ≤ N − 1)."""
    plan = _plan(kind, n)
    fams = [f"{nm}_{g}" for nm in ("pos", "shift", "pair_pos", "pair_sha", "pair_shb")
            for g in "xy"]
    seen = 0
    for name in fams:
        rows = getattr(plan, name, None)
        if rows is None or rows.shape[0] == 0:
            continue
        assert rows.dtype == torch.float32 and rows.shape[1] == n
        r = rows.double()
        j = torch.arange(n, dtype=torch.float64)
        dev = (r - r[:, :1] - j * (r[:, 1:2] - r[:, :1])).abs().max().item()
        assert dev <= n * 2.0 ** -23 * r.abs().max().item(), (name, dev)
        seen += 1
    assert seen >= 4


def _cmul(v, r):
    return v[0] * r[0] - v[1] * r[1], v[0] * r[1] + v[1] * r[0]


def _tree_rows(th0, dth, n, lo_bits, u_rows, lo, hi):
    """The kernels' doubling (radon_proto_tc.cu pt_rotors / pt_dbl_rows):
    rotors R_{2^b} by repeated squaring of e^{i·dth}; the rows hi + lo +
    2^lo_bits·u (u < u_rows) from the seed e^{i·th0}: lo's bits one by
    one, then row 2^l + u = row u · R_{2^(lo_bits + l)}, then hi's bits,
    each complex product rounded as the kernels round it."""
    nb = math.ceil(math.log2(n))
    rot = [(torch.cos(th0), torch.sin(th0))]
    rc, rs = torch.cos(dth), torch.sin(dth)
    for _ in range(nb):
        rot.append((rc, rs))
        rc, rs = rc * rc - rs * rs, 2.0 * rc * rs
    v = rot[0]
    for b in range(min(lo_bits, nb)):
        if (lo >> b) & 1:
            v = _cmul(v, rot[b + 1])
    rows = [v]
    for lvl in range(int(math.log2(u_rows))):
        step = rot[lo_bits + lvl + 1] if lo_bits + lvl < nb else None
        rows += [_cmul(r, step) if step is not None else r for r in rows]
    for b in range(lo_bits + int(math.log2(u_rows)), nb):
        if (hi >> b) & 1:
            rows = [_cmul(r, rot[b + 1]) for r in rows]
    return rows


#: (low bits, rows per thread, row block) of each doubling the kernels make:
#: forward T̂ and φ, adjoint T̂ (bf16, split) and h
_TREES = [(4, 8, 128), (3, 2, 16), (5, 8, 256), (5, 4, 128)]


@pytest.mark.parametrize("n", [32, 256])
def test_kernel_doubling_tree_transcription_is_doubling_trig_rows(n):
    """Each row the kernels double is the seed rotated by the rotors of its
    index's set bits, lowest first, the products shared along a tree; a
    transcription of that tree (``_tree_rows``, ``_TREES`` from the
    kernels' template arguments) gives doubling_trig_rows' values bit for
    bit: the same products in the same order (rows [n, 2n) = rows [0,
    n)·R_n), so the kernels' order needs no plain twin of its own. Seeds as
    the plans give them (row-0 phases of hundreds of rad, steps ≤ π)."""
    rng = np.random.default_rng(n)
    th0 = torch.from_numpy(rng.uniform(-400.0, 400.0, 97).astype(np.float32))
    dth = torch.from_numpy(rng.uniform(-np.pi, np.pi, 97).astype(np.float32))
    c, s = proto_kernels.doubling_trig_rows(th0, dth, n)
    covered = 0
    for lo_bits, u_rows, block in _TREES:
        for hi in range(0, n, block):
            for lo in range(1 << lo_bits):
                for u, (rc, rs) in enumerate(_tree_rows(th0, dth, n, lo_bits, u_rows, lo, hi)):
                    j = hi + lo + (u << lo_bits)
                    if j < n:
                        assert torch.equal(rc, c[j]) and torch.equal(rs, s[j]), (lo_bits, j)
                        covered += 1
    assert covered == len(_TREES) * n


def test_packed_window():
    assert [proto_kernels._packed_window(np_) for np_ in (128, 256, 384, 512, 640)] == [
        128, 256, 128, 256, 128]


def test_cpu_calls_run_plain_versions_and_launch_nothing(radial):
    """Both packed wrappers run the plain versions on CPU tensors and count
    no launch."""
    _, tp = radial
    proto_kernels.reset_launch_counts()
    gen = torch.Generator().manual_seed(13)
    f = torch.randn(2, N, N, generator=gen)
    p = torch.randn(2, tp.meta["A_x"], tp.meta["S"], generator=gen)
    for cdt in (torch.float32, torch.bfloat16):
        for doubling in (None, False, True):
            kw = dict(cdt=cdt, doubling=doubling)
            fwd = proto_kernels.project_group_packed(f, *_rows(tp, "x"), **kw)
            assert torch.equal(fwd, proto_kernels._project_group_packed(f, *_rows(tp, "x"), **kw))
            adj = proto_kernels.backproject_group_packed(p, *_rows(tp, "x"), N, **kw)
            assert torch.equal(adj, proto_kernels._backproject_group_packed(
                p, *_rows(tp, "x"), **kw))
    for fn in (proto_kernels.project_group_packed, proto_kernels.backproject_group_packed):
        assert fn.launches == 0
    with pytest.raises(ValueError, match="no kernel"):
        proto_kernels.project_group_packed(torch.zeros(1, N, N, device="meta"), *_rows(tp, "x"))


def _c_signature(entry):
    """(pointer, int, float) parameter kinds of a C entry point of
    csrc/radon_proto_tc.cu, in order."""
    src = (REPO / "pdunet_tpu_torch/ops/radon/csrc/radon_proto_tc.cu").read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    kinds = []
    for prm in params.split(","):
        prm = prm.strip()
        kinds.append("p" if "*" in prm else ("f" if prm.startswith("float") else "i"))
    return kinds


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_calls_match_the_c_entry_points(radial, monkeypatch, bf16):
    """A CUDA call (meta tensors standing in for the card's; the launch
    recorded, not made) passes the C entry point one argument per
    parameter, pointers as tensors (None: a null pointer), ints and the
    float where the signature has them, and counts one launch; the
    argument types declared for ctypes match the signature."""
    _, tp = radial
    recorded = []

    def fake_launch(name, *args):
        recorded.append((name, args))
        return 0

    monkeypatch.setattr(proto_kernels, "_check_device", lambda x: None)
    monkeypatch.setattr(proto_kernels, "_launch", fake_launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))
    proto_kernels.reset_launch_counts()
    rows = [t.to("meta") if torch.is_tensor(t) else t for t in _rows(tp, "x")]
    cdt = _cdt(bf16)
    f = torch.zeros(2, N, N, device="meta")
    p = torch.zeros(2, tp.meta["A_x"], tp.meta["S"], device="meta")
    assert proto_kernels.project_group_packed(f, *rows, cdt=cdt).shape == (2, tp.meta["A_x"],
                                                                         tp.meta["S"])
    assert proto_kernels.backproject_group_packed(p, *rows, N, cdt=cdt).shape == (2, N, N)
    assert proto_kernels.project_group_packed.launches == 1
    assert proto_kernels.backproject_group_packed.launches == 1
    ctype_kind = {proto_kernels._P: "p", proto_kernels._I: "i", proto_kernels._F: "f"}
    for name, args in recorded:
        kinds = _c_signature(name)
        assert [ctype_kind[t] for t in proto_kernels._ARGTYPES[name]] == kinds
        assert len(args) + 1 == len(kinds)  # the stream is added by _launch
        for a, k in zip(args, kinds):
            if k == "p":
                assert a is None or torch.is_tensor(a)
            else:
                assert isinstance(a, float if k == "f" else int)
        named = dict(zip(("bf16", "doubling"), args[-2:]))
        assert named == {"bf16": int(bf16), "doubling": int(bf16)}


def test_cuda_f32_doubling_is_refused(radial, monkeypatch):
    """The float32 tensor-core kernels make exact trig only: a CUDA float32
    call asking for doubling raises before any launch (the CPU still runs
    it)."""
    _, tp = radial
    monkeypatch.setattr(proto_kernels, "_check_device", lambda x: None)
    monkeypatch.setattr(proto_kernels, "_launch", lambda *a: pytest.fail("launched"))
    proto_kernels.reset_launch_counts()
    rows = [t.to("meta") if torch.is_tensor(t) else t for t in _rows(tp, "x")]
    f = torch.zeros(2, N, N, device="meta")
    p = torch.zeros(2, tp.meta["A_x"], tp.meta["S"], device="meta")
    with pytest.raises(ValueError, match="exact trig only"):
        proto_kernels.project_group_packed(f, *rows, cdt=torch.float32, doubling=True)
    with pytest.raises(ValueError, match="exact trig only"):
        proto_kernels.backproject_group_packed(p, *rows, N, cdt=torch.float32, doubling=True)
    assert proto_kernels.project_group_packed.launches == 0
    assert proto_kernels.backproject_group_packed.launches == 0
