"""The mirror-pair trig probe's tensor-core route
(pdunet_tpu_torch/ops/radon/csrc/radon_pair_proto_tc.cu, through
ops/radon/proto_kernels.py) on the CPU.

The kernels run only on a card (chip_smoke.py holds them against the plain
versions there). Here:
  * the row-5 plain versions against the Pallas bodies of
    scripts/trig_proto.py (loaded by path, interpret mode) on pdunet_fan's
    backing plan at 32² (its 40 views over 0.75·2π kept 4× sparse: sign +1
    pairs, an odd S) and on a dense 32², 96-angle parallel plan, both groups,
    doubling and no-trig bodies; tolerances (relative norm) 1e-5 in
    float32, 5e-3 with bf16 operands (tests/test_pallas_kernels.py's);
  * every doubling tree the kernels make is one whose CPU transcription
    tests/test_torch_proto_tc.py holds to doubling_trig_rows bit for bit;
  * the kernels' build hash covers every header they include;
  * routing: CPU calls run the plain versions and launch nothing, and a
    CUDA call hands its C entry point one argument per declared type, which
    match the C signature;
  * ``python -m pdunet_tpu_torch.scripts.trig_proto --cpu --plan P`` runs
    on each of its plans.
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

from pdunet_tpu.geometry import FanGeometry as JaxFan
from pdunet_tpu.geometry import ParallelGeometry as JaxGeometry
from pdunet_tpu.geometry import build_parallel_plan as jax_plan
from pdunet_tpu.ops.radon import fan as jax_fan
from pdunet_tpu_torch.geometry import FanGeometry, ParallelGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.radon import _build, proto_kernels
from pdunet_tpu_torch.ops.radon.fan import build_fan_plan
from pdunet_tpu_torch.scripts import trig_proto as port_trig_proto

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]
CSRC = REPO / "pdunet_tpu_torch/ops/radon/csrc"
N = 32
_BF16 = [(False, 1e-5), (True, 5e-3)]
#: pdunet_fan's views at 32²: 40 over 0.75·2π, kept 4× sparse
FAN = dict(image_size=N, angles=tuple(0.75 * 2.0 * math.pi * k / 40 for k in range(40))[::4])
DENSE = dict(image_size=N, n_angles=96)


def _load(path):
    spec = importlib.util.spec_from_file_location(f"_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def trig_proto():
    return _load(REPO / "scripts" / "trig_proto.py")


def _plans(kind, bf16):
    """(JAX, port) pair plans of a probe plan at 32²."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32, torch.float32)
    if kind == "fan":
        return (jax_fan.build_fan_plan(JaxFan(**FAN), dtype=jdt).par_plan,
                build_fan_plan(FanGeometry(**FAN), dtype=tdt, device="cpu").par_plan)
    return (jax_plan(JaxGeometry(**DENSE), dtype=jdt),
            build_parallel_plan(ParallelGeometry(**DENSE), dtype=tdt, device="cpu"))


@pytest.fixture(scope="module")
def plans():
    return {(kind, bf16): _plans(kind, bf16) for kind in ("fan", "dense")
            for bf16 in (False, True)}


def rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pair_rows(plan, grp):
    return [getattr(plan, f"pair_{nm}_{grp}") for nm in ("pos", "sha", "shb", "sgn")]


def _cdt(bf16):
    return torch.bfloat16 if bf16 else torch.float32


@pytest.mark.parametrize("grp", ["x", "y"])
@pytest.mark.parametrize("bf16,tol", _BF16, ids=["f32", "bf16"])
@pytest.mark.parametrize("body", ["doubling", "notrig"])
@pytest.mark.parametrize("kind", ["fan", "dense"])
def test_pair_probe_matches_jax(trig_proto, plans, kind, body, grp, bf16, tol):
    """The no-trig body's numbers are not a projection (|p| reaches ~1e5),
    so only the relative norm against the JAX body means anything."""
    jp, tp = plans[(kind, bf16)]
    m = tp.meta
    K, L, P = m["K"], m["S_ext"], m[f"P_{grp}"]
    rows = _pair_rows(tp, grp)
    assert P > 0 and rows[0].shape == (P, N)
    if kind == "fan":
        assert m["S"] % 2 == 1 and bool((rows[3] > 0).any())
    f = np.random.default_rng(21).standard_normal((2, N, N)).astype(np.float32)
    consts = (tp.spec, tp.Wc, tp.Ws)
    if body == "doubling":
        seeds = trig_proto._phase_seeds(jp, grp, K, L)
        ref = trig_proto.call_pair_fwd(trig_proto._fwd_pair_kernel_doubling, jnp.asarray(f), jp,
                                       grp, grp == "x", bf16, interpret=True,
                                       extra=tuple(jnp.asarray(s) for s in seeds))
        s0, st = (torch.from_numpy(s) for s in proto_kernels.phase_seeds(*rows[:3], K, L))
        out = proto_kernels.project_pair_group_doubling(torch.from_numpy(f), s0, st, rows[3],
                                                        *consts, grp == "x", cdt=_cdt(bf16))
    else:
        ref = trig_proto.call_pair_fwd(trig_proto._fwd_pair_kernel_notrig, jnp.asarray(f), jp,
                                       grp, grp == "x", bf16, interpret=True)
        out = proto_kernels.project_pair_group_notrig(torch.from_numpy(f), *rows, *consts, L,
                                                      grp == "x", cdt=_cdt(bf16))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 2 * P, m["S"])
    assert rel(out, ref) < tol


@pytest.mark.parametrize("kind", ["fan", "dense"])
def test_split_parts_of_the_f32_kernels_hold_the_contract(plans, kind):
    """The f32 kernels' own arithmetic (chip_smoke.pair_own_arithmetic: F
    and T̂ in hi and lo parts, three products, f32 sums in the kernels'
    tiling) against the plain versions: the doubling body's bf16 parts and
    the no-trig body's fp16 parts hold 1e-5. The no-trig numbers cancel
    ~190x in stage 2, which is why its kernel takes fp16 parts (2⁻²²)."""
    import chip_smoke

    from pdunet_tpu_torch.ops.radon import cuda_kernels as ck

    _, tp = plans[(kind, False)]
    m = tp.meta
    K, L = m["K"], m["S_ext"]
    rows = _pair_rows(tp, "x")
    s0, st = (torch.from_numpy(s) for s in proto_kernels.phase_seeds(*rows[:3], K, L))
    f = torch.from_numpy(np.random.default_rng(24).standard_normal((2, N, N)).astype(np.float32))
    consts = (tp.spec, tp.Wc, tp.Ws)
    dbl = chip_smoke.pair_own_arithmetic(
        ck, f, proto_kernels._doubling_pair_trig(s0, st, tp.spec, N), rows[3], tp.Wc, tp.Ws,
        True, torch.float32)
    assert rel(dbl, proto_kernels._project_pair_group_doubling(f, s0, st, rows[3], *consts,
                                                               True)) < 1e-5
    split = ck._split
    notrig = chip_smoke.pair_own_arithmetic(
        ck, f, proto_kernels._notrig_pair_trig(*rows[:3], tp.spec, L), rows[3], tp.Wc, tp.Ws,
        True, torch.float32, fp16=True)
    assert ck._split is split  # restored
    assert rel(notrig, proto_kernels._project_pair_group_notrig(f, *rows, *consts, L,
                                                                True)) < 1e-6


def _trees(path):
    """(low bits, rows per thread) of each pt_dbl_rows tree in a source."""
    return {tuple(map(int, t)) for t in
            re.findall(r"pt_dbl_rows<(\d+), (\d+)>", path.read_text())}


def test_pair_kernel_doubling_trees_are_transcribed():
    """Each doubling tree the pair kernels make (pt_dbl_rows<low bits, rows
    per thread>, its row block 2^low bits · rows) is one that
    tests/test_torch_proto_tc.py's transcription holds to
    doubling_trig_rows bit for bit (its _TREES), so the pair kernels'
    order needs no twin of its own."""
    trees = _load(REPO / "tests" / "test_torch_proto_tc.py")._TREES
    pair = _trees(CSRC / "radon_pair_proto_tc.cu")
    assert pair == {(4, 8), (3, 2)}
    for lo_bits, u_rows in pair:
        assert (lo_bits, u_rows, (1 << lo_bits) * u_rows) in trees


def test_build_hash_covers_every_included_header():
    """The pair probe's library is named by a hash of its source and of every
    header it includes, directly (radon_proto_tc.cuh) or through another
    (radon_tc.cuh), so that an edited header rebuilds it."""
    text = (CSRC / "radon_pair_proto_tc.cu").read_bytes()
    assert _build._headers(text) == ["radon_proto_tc.cuh", "radon_tc.cuh"]
    assert _build._headers((CSRC / "radon_proto_tc.cu").read_bytes()) == [
        "radon_proto_tc.cuh", "radon_tc.cuh"]
    assert "radon_pair_proto_tc" in _build.SOURCES


def _args(plan, grp, bf16):
    K, L = plan.meta["K"], plan.meta["S_ext"]
    rows = _pair_rows(plan, grp)
    seeds = [torch.from_numpy(s) for s in proto_kernels.phase_seeds(*rows[:3], K, L)]
    consts = (plan.spec, plan.Wc, plan.Ws)
    return {"doubling": (*seeds, rows[3], *consts, grp == "x", _cdt(bf16)),
            "notrig": (*rows, *consts, L, grp == "x", _cdt(bf16))}


_WRAPPERS = {"doubling": ("project_pair_group_doubling", "_project_pair_group_doubling"),
             "notrig": ("project_pair_group_notrig", "_project_pair_group_notrig")}


def test_cpu_calls_run_plain_versions_and_launch_nothing(plans):
    """Both pair wrappers run the plain versions on CPU tensors and count
    no launch; a tensor on another device has no kernel."""
    _, tp = plans[("fan", False)]
    proto_kernels.reset_launch_counts()
    f = torch.randn(2, N, N, generator=torch.Generator().manual_seed(23))
    for bf16 in (False, True):
        args = _args(tp, "x", bf16)
        for body, names in _WRAPPERS.items():
            tc, plain = (getattr(proto_kernels, n) for n in names)
            assert torch.equal(tc(f, *args[body]), plain(f, *args[body]))
    for body, (name, _) in _WRAPPERS.items():
        fn = getattr(proto_kernels, name)
        assert fn.launches == 0
        with pytest.raises(ValueError, match="no kernel"):
            fn(torch.zeros(1, N, N, device="meta"), *_args(tp, "x", False)[body])


def _c_signature(source, entry):
    """(pointer, int, float) parameter kinds of a C entry point, in order."""
    src = (CSRC / source).read_text()
    params = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src).group(1)
    kinds = []
    for prm in params.split(","):
        prm = prm.strip()
        kinds.append("p" if "*" in prm else ("f" if prm.startswith("float") else "i"))
    return kinds


def _fake_cuda(monkeypatch, recorded):
    def fake_launch(name, *args):
        recorded.append((name, args))
        return 0

    monkeypatch.setattr(proto_kernels, "_check_device", lambda x: None)
    monkeypatch.setattr(proto_kernels, "_launch", fake_launch)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda d: types.SimpleNamespace(multi_processor_count=132))


def _meta(args):
    return [t.to("meta") if torch.is_tensor(t) else t for t in args]


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cuda_calls_match_the_c_entry_points(plans, monkeypatch, bf16):
    """A CUDA call (meta tensors standing in for the card's; the launch
    recorded, not made) of each pair wrapper passes its C entry point one
    argument per parameter, pointers as tensors, ints
    and the float where the signature has them, and counts one launch; the
    argument types declared for ctypes match the signature. The
    tensor-core calls take no table: seeds (doubling) or plan rows."""
    _, tp = plans[("dense", bf16)]
    recorded = []
    _fake_cuda(monkeypatch, recorded)
    proto_kernels.reset_launch_counts()
    m = tp.meta
    f = torch.zeros(2, N, N, device="meta")
    for body, (name, _) in _WRAPPERS.items():
        args = _meta(_args(tp, "x", bf16)[body])
        assert getattr(proto_kernels, name)(f, *args).shape == (2, 2 * m["P_x"], m["S"])
        assert getattr(proto_kernels, name).launches == 1
    sources = {"radon_pair_proto_tc_doubling": "radon_pair_proto_tc.cu",
               "radon_pair_proto_tc_notrig": "radon_pair_proto_tc.cu"}
    assert [name for name, _ in recorded] == list(sources)
    ctype_kind = {proto_kernels._P: "p", proto_kernels._I: "i", proto_kernels._F: "f"}
    for name, args in recorded:
        kinds = _c_signature(sources[name], name)
        assert [ctype_kind[t] for t in proto_kernels._ARGTYPES[name]] == kinds
        assert len(args) + 1 == len(kinds)  # the stream is added by _launch
        for a, k in zip(args, kinds):
            if k == "p":
                assert torch.is_tensor(a)
            else:
                assert isinstance(a, float if k == "f" else int)
        assert args[-1] == int(bf16)
    for name, args in recorded:
        # (B, N, Np, P, K, Kp, S, Dw): one depth window of Np = 128 rows
        ints = [a for a in args if isinstance(a, int)][:8]
        assert ints == [2, N, 128, m["P_x"], m["K"], 64, m["S"], 128]
        part = [a for a in args if torch.is_tensor(a)][-2]
        assert part.shape == (1, 2, 2 * m["P_x"], m["K"], 2)


def test_cuda_call_beyond_stage3_raises_with_the_reason(plans, monkeypatch):
    """A K whose Ŝ rows do not fit the pair stage 3's shared memory raises
    before any launch, naming the limit."""
    _, tp = plans[("dense", False)]
    _fake_cuda(monkeypatch, [])
    monkeypatch.setattr(proto_kernels, "_launch", lambda *a: pytest.fail("launched"))
    K = proto_kernels._PAIR_STAGE3_MAX_K + 1
    P = tp.meta["P_x"]
    meta = {"device": "meta"}
    f = torch.zeros(1, N, N, **meta)
    seeds = torch.zeros(P, 3 * K, **meta)
    with pytest.raises(ValueError, match="stage 3's shared memory"):
        proto_kernels.project_pair_group_doubling(
            f, seeds, seeds, torch.zeros(P, **meta), torch.zeros(K, **meta),
            torch.zeros(K, 8, **meta), torch.zeros(K, 8, **meta), True)


@pytest.mark.parametrize("plan", port_trig_proto.PLANS)
def test_trig_proto_cpu_runs(plan, capsys):
    """``python -m pdunet_tpu_torch.scripts.trig_proto --cpu --plan P``: the
    plain versions at 32², doubling within the JAX script's 2e-2 of the
    exact-trig pair operator in both operand types."""
    assert port_trig_proto.main(["--cpu", "--plan", plan]) == 0
    out = capsys.readouterr().out
    assert "CPU correctness done" in out
    assert out.count("doubling vs shipped rel-err") == 2
