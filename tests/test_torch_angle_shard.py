"""The port's angle-sharded operators (pdunet_tpu_torch/parallel/angle_shard.py
and the ``mesh=`` bundles of ops/radon/parallel.py, ops/radon/fan.py and
ops/nufft) against the JAX package's ``angle_sharded_*`` and ``mesh=``
bundles on a CPU mesh of the same angle size, on the same numpy inputs.

The port's side runs as one launch of six gloo ranks on the CPU
(``python -m pdunet_tpu_torch.parallel.check``): each case on a (3, 2) or
a (2, 3) (data, angle) mesh, so the batch of 6 is sharded over the data
axis too and every output is gathered back in batch order. Plans: the
pdunet_parallel preset's sparse pair plan at 32² (10 of 40 angles, 3
pairs per group, padded at G = 2), the full 40-angle scan (pairs) at
G = 2 and, padded, at G = 3, a golden-angle scan that does not pair (the
per-angle route) at G = 3, the pdunet_fan preset's backing plan (pairs of
sign +1 and −1) and the radial fourier-slice plan (48 spokes). Tolerances:
1e-5 relative in float32, 5e-3 with bf16 operands. The kernels themselves
run only on a card: chip_smoke.py phase 19 holds them per shard there.
"""

import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pdunet_tpu.geometry import GOLDEN_ANGLE
from pdunet_tpu.geometry import FanGeometry as JaxFan
from pdunet_tpu.geometry import ParallelGeometry as JaxParallel
from pdunet_tpu.geometry import RadialGeometry as JaxRadial
from pdunet_tpu.geometry import build_parallel_plan as jax_plan
from pdunet_tpu.ops.nufft import make_radial_ops as jax_radial_ops
from pdunet_tpu.ops.radon.fan import make_fan_ops as jax_fan_ops
from pdunet_tpu.parallel import angle_shard as jax_shard
from pdunet_tpu_torch.geometry import ParallelGeometry, RadialGeometry, build_parallel_plan
from pdunet_tpu_torch.ops.nufft import make_radial_ops
from pdunet_tpu_torch.parallel.angle_shard import shard_plan
from pdunet_tpu_torch.parallel.launch import launch

torch.set_num_threads(1)

N, B = 32, 6
FULL = tuple(math.pi * k / 40 for k in range(40))
GOLDEN = tuple((k * GOLDEN_ANGLE) % math.pi for k in range(14))
FAN = tuple(0.75 * 2.0 * math.pi * k / 40 for k in range(40))[::4]
#: name → (geometry kind, fields, dtype, angle shards)
CASES = {
    "pair": ("parallel", dict(image_size=N, angles=FULL[::4]), "float32", 2),
    "pair_bf16": ("parallel", dict(image_size=N, angles=FULL[::4]), "bfloat16", 2),
    "full_scan": ("parallel", dict(image_size=N, angles=FULL), "float32", 2),
    "full_scan_bf16": ("parallel", dict(image_size=N, angles=FULL), "bfloat16", 2),
    "padded": ("parallel", dict(image_size=N, angles=FULL), "float32", 3),
    "per_angle": ("parallel", dict(image_size=N, angles=GOLDEN), "float32", 3),
    "fan": ("fan", dict(image_size=N, angles=FAN), "float32", 2),
    "fan_bf16": ("fan", dict(image_size=N, angles=FAN), "bfloat16", 2),
    "fourier_slice": ("radial", dict(image_size=N, n_spokes=48, samples_per_spoke=48),
                      "float32", 2),
}
TOL = {"float32": 1e-5, "bfloat16": 5e-3}


def rel(a, b):
    a, b = np.asarray(a, np.complex128), np.asarray(b, np.complex128)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _jax_ops(kind, fields, dtype, G):
    """(A, At, fbp) of the JAX package, angle-sharded over G CPU devices."""
    mesh = JaxMesh(np.array(jax.devices()[:G]), ("angle",))
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    if kind == "parallel":
        plan = jax_plan(JaxParallel(**fields), dtype=jdt)
        return (lambda x: jax_shard.angle_sharded_project(plan, x, mesh),
                lambda y: jax_shard.angle_sharded_backproject(plan, y, mesh),
                lambda y: jax_shard.angle_sharded_fbp(plan, y, mesh))
    if kind == "fan":
        ops = jax_fan_ops(JaxFan(**fields), dtype=jdt, mesh=mesh)
    else:
        ops = jax_radial_ops(JaxRadial(**fields), mesh=mesh)
    return ops.A, ops.At, ops.fbp


def _inputs(kind, fields, rng):
    """Images (B, N, N) and measurements of the geometry's shape; complex
    for the radial one."""
    if kind == "radial":
        shape = (B, fields["n_spokes"], fields["samples_per_spoke"])
        x = rng.standard_normal((B, N, N)) + 1j * rng.standard_normal((B, N, N))
        return x.astype(np.complex64), (rng.standard_normal(shape)
                                        + 1j * rng.standard_normal(shape)).astype(np.complex64)
    geom = (JaxFan if kind == "fan" else JaxParallel)(**fields)
    x = rng.standard_normal((B, N, N)).astype(np.float32)
    return x, rng.standard_normal((B, len(geom.angles), geom.det_count)).astype(np.float32)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every case through the port's sharded bundles (one launch of six
    ranks) and through JAX's, on the same inputs."""
    out = tmp_path_factory.mktemp("angle_shard")
    rng = np.random.default_rng(0)
    cases, refs = [], {}
    for name, (kind, fields, dtype, G) in CASES.items():
        x, y = _inputs(kind, fields, rng)
        A, At, fbp = (jax.jit(fn) for fn in _jax_ops(kind, fields, dtype, G))
        refs[name] = {"x": x, "y": y, "A": np.asarray(A(jnp.asarray(x))),
                      "At": np.asarray(At(jnp.asarray(y))), "fbp": np.asarray(fbp(jnp.asarray(y)))}
        cases.append(dict(kind="ops", name=name, geometry=dict(kind=kind, **fields),
                          dtype=dtype, mesh=(6 // G, G), x=torch.from_numpy(x),
                          y=torch.from_numpy(y)))
    job = dict(device="cpu", threads=1, timeout_s=120.0, out=str(out), cases=cases)
    torch.save(job, out / "job.pt")
    launch("pdunet_tpu_torch.parallel.check", [str(out / "job.pt")], 6, timeout_s=600)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True) for r in range(6)]
    return refs, ranks


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("op", ["A", "At", "fbp"])
def test_sharded_op_matches_jax(results, name, op):
    refs, ranks = results
    got = ranks[0][name][op].numpy()
    assert got.shape == refs[name][op].shape
    assert rel(got, refs[name][op]) <= TOL[CASES[name][2]], rel(got, refs[name][op])


@pytest.mark.parametrize("name", list(CASES))
def test_every_rank_holds_the_same_gathered_result(results, name):
    """Each rank's gathered output is the whole batch, bit for bit the
    same on all six ranks (the angle gather and the data gather)."""
    _, ranks = results
    for op in ("A", "At", "fbp", "vjp_A", "vjp_At"):
        for r in ranks[1:]:
            assert torch.equal(r[name][op], ranks[0][name][op]), (name, op)
    D, G = ranks[0][name]["mesh"]
    assert sorted(r[name]["coords"] for r in ranks) == [(d, a) for d in range(D)
                                                        for a in range(G)]


@pytest.mark.parametrize("name", list(CASES))
def test_vjp_pairing(results, name):
    """vjp(A_sh) = A†_sh and vjp(A†_sh) = A_sh: the custom gradients of the
    sharded bundle are the sharded operators themselves."""
    _, ranks = results
    r = ranks[0][name]
    assert torch.equal(r["vjp_A"], r["At"])
    assert torch.equal(r["vjp_At"], r["A"])


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c[2] == "float32"])
def test_sharded_dot_test(results, name):
    """⟨A x, y⟩ = ⟨x, A† y⟩ for the sharded pair (float32)."""
    refs, ranks = results
    r = ranks[0][name]
    lhs = np.vdot(r["A"].numpy().astype(np.complex128), refs[name]["y"])
    rhs = np.vdot(refs[name]["x"].astype(np.complex128), r["At"].numpy())
    assert abs(lhs - rhs) <= 1e-5 * abs(lhs), (lhs, rhs)


def _plan_and_shards(name):
    _, fields, _, G = CASES[name]
    plan = build_parallel_plan(ParallelGeometry(**fields), device="cpu")
    return plan, G, [shard_plan(plan, G, r) for r in range(G)]


@pytest.mark.parametrize("name", ["pair", "full_scan", "padded", "per_angle"])
def test_shard_plan_blocks_reassemble_the_plan(name):
    """Each shard holds ceil(units / G) pairs (or angles) of each group; the
    shards' unpadded blocks, in rank order, are the plan's, and the pad
    units have pos = shift = 0, sign +1 and mask 0; each shard reads its
    block's sinogram rows (``take``), and a zero row for each pad row."""
    plan, G, shards = _plan_and_shards(name)
    pairs = plan.meta["use_pairs"]
    names = (("pair_pos", "pair_sha", "pair_shb", "pair_sgn", "pair_msk") if pairs
             else ("pos", "shift"))
    count, take, per = ("P_", "pair_take_", 2) if pairs else ("A_", "idx_", 1)
    A = len(plan.geom.angles)
    padded_somewhere = False
    want_take = [[] for _ in shards]
    for grp in "xy":
        n = plan.meta[count + grp]
        n_local = -(-n // G)
        assert all(s.meta[count + grp] == n_local for s in shards)
        for field in names:
            full = getattr(plan, f"{field}_{grp}")
            blocks = torch.cat([getattr(s, f"{field}_{grp}") for s in shards])
            assert blocks.shape[0] == n_local * G
            assert torch.equal(blocks[:n], full)
            pad = blocks[n:]
            fill = 1.0 if field == "pair_sgn" else 0.0
            assert torch.all(pad == fill)
            padded_somewhere |= pad.shape[0] > 0
        rows = plan.meta[take + grp] + (A,) * (per * (n_local * G - n))
        for r in range(G):
            want_take[r] += rows[per * r * n_local:per * (r + 1) * n_local]
    assert [list(s.meta["take"]) for s in shards] == want_take
    assert shard_plan(plan, G, 0) is shards[0]  # made once
    if name == "padded":
        assert padded_somewhere


@pytest.mark.parametrize("name", ["pair", "full_scan", "padded", "per_angle"])
def test_shard_gather_reads_the_rows_the_adjoint_takes(name):
    """The forward's reassembly and the adjoint's row selection address the
    same rows: sinogram row a of the plan is gathered from the shard
    output row whose adjoint reads row a, and every such row is a real
    (unpadded) one."""
    plan, G, shards = _plan_and_shards(name)
    rows_local = len(shards[0].meta["take"])
    gather = shards[0].meta["gather"]
    assert all(s.meta["gather"] == gather for s in shards)
    assert len(gather) == len(plan.geom.angles) == len(set(gather))
    for a, g in enumerate(gather):
        s, k = divmod(g, rows_local)
        assert shards[s].meta["take"][k] == a


def test_gridding_with_a_mesh_raises():
    geom = RadialGeometry(image_size=N, n_spokes=48, samples_per_spoke=48)
    with pytest.raises(NotImplementedError, match="fourier_slice"):
        make_radial_ops(geom, impl="gridding", mesh=types.SimpleNamespace(), device="cpu")
