"""The port's data-parallel mesh (pdunet_tpu_torch/parallel/sharding.py, the
sharded step of training/loop.py, the train CLI's --devices /
--angle-devices) on gloo ranks on the CPU, held to what the JAX package's
own checks demand (tests/test_sharding.py, tests/test_angle_shard.py and
the multichip dry run of __graft_entry__.py): one sharded f32 SGD step
equals the single-device step from the same weights and seed (loss rtol
1e-4, parameters atol 1e-4), and the sharded loss equals JAX's on the
same weights and batch.

Two launches of the check worker (``python -m
pdunet_tpu_torch.parallel.check``): two ranks for the (2, 1) and (1, 2)
meshes, four for (2, 2), with remat, in bf16, and the loss against JAX's
``build_task(mesh=...)``; the single-device references run here. Small
shapes: 32², 10 of 40 angles (radial: 12 of 48 spokes), base 8, depth 1
(fbp_unet: 2), 2 iterations, batch 4.
"""

import json

import jax
import numpy as np
import pytest
import torch

from pdunet_tpu.configs import get_preset as jax_get_preset
from pdunet_tpu.parallel import make_mesh as jax_make_mesh
from pdunet_tpu.training import tasks as jax_tasks
from pdunet_tpu_torch import infer
from pdunet_tpu_torch import train as train_cli
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.models.convert import flax_to_torch
from pdunet_tpu_torch.parallel import Mesh, make_mesh, shard_batch
from pdunet_tpu_torch.parallel.launch import RankFailed, launch
from pdunet_tpu_torch.training import loop
from pdunet_tpu_torch.training.checkpoint import CheckpointManager
from pdunet_tpu_torch.training.tasks import build_task

torch.set_num_threads(1)

SMALL = {"geometry.image_size": 32, "geometry.n_angles": 40, "geometry.sparsity": 4,
         "model.base_features": 8, "model.depth": 1, "model.n_iters": 2,
         "model.use_bfloat16": False, "train.batch_size": 4}
RADIAL = {**SMALL, "geometry.n_angles": 48, "geometry.samples_per_spoke": 48}
#: name → (preset, overrides, mesh, from images)
STEPS_2 = {
    "pdunet_21": ("pdunet_parallel", SMALL, (2, 1), False),
    "pdunet_12": ("pdunet_parallel", SMALL, (1, 2), False),
    "fbp_unet_21": ("fbp_unet_parallel", {**SMALL, "model.depth": 2}, (2, 1), False),
    "fbp_unet_images_21": ("fbp_unet_parallel", {**SMALL, "model.depth": 2}, (2, 1), True),
    "sino_unet_12": ("sino_unet_parallel", SMALL, (1, 2), False),
    "fan_12": ("pdunet_fan", SMALL, (1, 2), False),
    "radial_12": ("pdunet_radial", RADIAL, (1, 2), False),
}
STEPS_4 = {
    "pdunet_22": ("pdunet_parallel", SMALL, (2, 2), False),
    "pdunet_22_remat": ("pdunet_parallel", {**SMALL, "model.remat": True}, (2, 2), False),
}
STEP_SEED, INIT_SEED, LR = 7, 1, 1e-2
#: the tolerances of __graft_entry__.py's multichip dry run
LOSS_RTOL, PARAM_ATOL = 1e-4, 1e-4
LAUNCH = dict(timeout_s=600)


def _config(preset, over):
    return get_preset(preset).override(over)


def _images():
    return torch.from_numpy(np.random.default_rng(5).standard_normal((4, 32, 32))
                            .astype(np.float32))


def _step_case(name, preset, over, mesh, images, **extra):
    case = dict(kind="step", name=name, config=_config(preset, over).to_json(), mesh=mesh,
                init_seed=INIT_SEED, lr=LR, seed=STEP_SEED, **extra)
    if images:
        case["images"] = _images()
    return case


def _run(tmp, cases, world):
    job = dict(device="cpu", threads=1, timeout_s=120.0, out=str(tmp), cases=cases)
    torch.save(job, tmp / "job.pt")
    launch("pdunet_tpu_torch.parallel.check", [str(tmp / "job.pt")], world, **LAUNCH)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(world)]


@pytest.fixture(scope="module")
def jax_loss():
    """JAX's sharded loss on a (2, 2) mesh of CPU devices, its weights, batch
    and the power iteration's start vector."""
    cfg = jax_get_preset("pdunet_parallel").override(SMALL)
    mesh = jax_make_mesh(4, axes=("data", "angle"), shape=(2, 2))
    jtask = jax_tasks.build_task(cfg, mesh=mesh, batch_axis="data")
    params = jtask.init_params(jax.random.PRNGKey(1))
    batch = jtask.make_batch(jax.random.PRNGKey(3))
    loss, _ = jax.jit(jtask.loss_fn)(params, batch)
    task = build_task(_config("pdunet_parallel", SMALL), device="cpu")
    flax_to_torch(jax.tree_util.tree_map(np.asarray, params), task.model)
    x0 = np.array(jax.random.normal(jax.random.PRNGKey(0), (32, 32)))
    return {"loss": float(loss), "state_dict": task.model.state_dict(),
            "batch": {k: torch.from_numpy(np.array(v)) for k, v in batch.items()},
            "x0": torch.from_numpy(x0)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_loss):
    """{case: [rank 0's results, rank 1's, ...]} of both launches."""
    cases2 = [_step_case(n, *spec) for n, spec in STEPS_2.items()]
    cases4 = [_step_case(n, *spec) for n, spec in STEPS_4.items()]
    cases4.append(_step_case("pdunet_22_bf16", "pdunet_parallel",
                             {**SMALL, "model.use_bfloat16": True}, (2, 2), False, steps=2))
    cases4.append(dict(kind="loss", name="loss_22", mesh=(2, 2),
                       config=_config("pdunet_parallel", SMALL).to_json(),
                       state_dict=jax_loss["state_dict"], batch=jax_loss["batch"],
                       opnorm_x0=jax_loss["x0"]))
    out = {}
    for world, cases in ((2, cases2), (4, cases4)):
        rs = _run(tmp_path_factory.mktemp(f"world{world}"), cases, world)
        out.update({c["name"]: [r[c["name"]] for r in rs] for c in cases})
    return out


def _single_step(preset, over, images):
    """The port's single-device step from the same weights, seed and SGD."""
    task = build_task(_config(preset, over), device="cpu")
    task.init_params(torch.Generator().manual_seed(INIT_SEED))
    state = loop.TrainState(task.model, torch.optim.SGD(task.model.parameters(), lr=LR),
                            lambda i: LR)
    step = loop.make_train_step(task, from_images=images)
    x = _images() if images else torch.Generator().manual_seed(STEP_SEED)
    metrics = {k: float(v) for k, v in step(state, x).items()}
    return task, metrics


@pytest.mark.parametrize("name", list(STEPS_2) + list(STEPS_4))
def test_sharded_step_matches_single_device(ranks, name):
    preset, over, mesh, images = {**STEPS_2, **STEPS_4}[name]
    task, single = _single_step(preset, over, images)
    got = ranks[name]
    assert got[0]["mesh"] == mesh
    for r in got:  # every rank logs the same (data-averaged) metrics
        assert r["metrics"][0] == got[0]["metrics"][0]
    sharded = got[0]["metrics"][0]
    assert sharded.keys() == single.keys()
    for k in single:
        np.testing.assert_allclose(sharded[k], single[k], rtol=LOSS_RTOL, err_msg=k)
    want = task.model.state_dict()
    assert got[0]["params"].keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[0]["params"][k].numpy(), v.numpy(), atol=PARAM_ATOL,
                                   err_msg=k)
        for r in got[1:]:  # the replicas stay identical
            assert torch.equal(r["params"][k], got[0]["params"][k]), k


@pytest.mark.parametrize("name", [n for n, s in {**STEPS_2, **STEPS_4}.items()
                                  if s[0] != "fbp_unet_parallel" and s[0] != "sino_unet_parallel"])
def test_sigma_is_the_same_on_every_rank(ranks, name):
    """σ comes from the unsharded twin of the sparse operator, so every rank
    has the single-device task's σ."""
    preset, over, _, _ = {**STEPS_2, **STEPS_4}[name]
    single = build_task(_config(preset, over), device="cpu").sigma
    assert {r["sigma"] for r in ranks[name]} == {single}


def test_bf16_step_on_the_2x2_mesh_is_finite(ranks):
    for r in ranks["pdunet_22_bf16"]:
        assert all(np.isfinite(m["loss"]) and m["grad_norm"] > 0 for m in r["metrics"])
    assert ranks["pdunet_22_bf16"][0]["metrics"][1]["loss"] != \
        ranks["pdunet_22_bf16"][0]["metrics"][0]["loss"]


def test_sharded_loss_matches_jax_sharded_loss(ranks, jax_loss):
    """The port's loss_fn over (2, 2) on JAX's batch with JAX's weights
    (models/convert.py) against JAX's build_task(mesh=...).loss_fn."""
    for r in ranks["loss_22"]:
        np.testing.assert_allclose(r["loss"], jax_loss["loss"], rtol=1e-5)


def test_make_mesh_shape_validation():
    with pytest.raises(ValueError, match="mesh shape"):
        make_mesh(8, shape=(4, 4))


def test_shard_batch_keeps_each_ranks_rows():
    x = torch.arange(12.0).reshape(6, 2)
    for r in range(6):
        mesh = Mesh((3, 2), r, groups={})
        d = r // 2
        got = shard_batch({"a": x, "b": (x, x)}, mesh)
        assert torch.equal(got["a"], x[2 * d:2 * d + 2])
        assert torch.equal(got["b"][1], x[2 * d:2 * d + 2])
    with pytest.raises(ValueError, match="not divisible"):
        shard_batch(x[:5], Mesh((2, 1), 0, groups={}))


def test_a_failing_rank_fails_the_launch(tmp_path):
    """The first rank that exits non-zero fails the launch with its error;
    the others are stopped."""
    job = dict(device="cpu", threads=1, timeout_s=60.0, out=str(tmp_path),
               cases=[dict(kind="nonexistent", name="x")])
    torch.save(job, tmp_path / "job.pt")
    with pytest.raises(RankFailed, match="nonexistent"):
        launch("pdunet_tpu_torch.parallel.check", [str(tmp_path / "job.pt")], 2, **LAUNCH)


SMALL_FLAGS = [a for k, v in {**SMALL, "train.val_slices": 4, "train.eval_every": 2,
                              "train.log_every": 1}.items()
               for a in ("--set", f"{k}={v}")]
DIST_FLAGS = ["--dist-timeout", "120"]


def test_checkpoints_move_between_mesh_and_single_device(tmp_path, capfd):
    """A single-device run's checkpoint resumes on a (2, 2) mesh, whose
    checkpoint (rank 0's, with the model's own keys) a single-device run
    restores and infer reads; only rank 0 writes the metrics and
    TensorBoard."""
    ck = tmp_path / "ck"
    common = ["--preset", "pdunet_parallel", "--device", "cpu", "--ckpt-dir", str(ck),
              *SMALL_FLAGS]
    assert train_cli.main([*common, "--steps", "1"]) == 0
    capfd.readouterr()
    assert train_cli.main([*common, "--steps", "3", "--devices", "2", "--angle-devices", "2",
                           "--metrics", str(tmp_path / "m.jsonl"), "--tb-dir",
                           str(tmp_path / "tb"), *DIST_FLAGS]) == 0
    out = capfd.readouterr().out
    assert "[train] resumed from step 1" in out and "[done] final eval" in out
    assert CheckpointManager(str(ck)).latest_step() == 3
    lines = [json.loads(s) for s in (tmp_path / "m.jsonl").read_text().splitlines()]
    assert [m["step"] for m in lines] == [2, 2, 3]  # step 2's log and eval, step 3's log
    assert len(list((tmp_path / "tb").iterdir())) == 1
    state = loop.build_state(build_task(_config("pdunet_parallel", SMALL), device="cpu"))
    assert CheckpointManager(str(ck)).restore(state).step == 3
    assert train_cli.main([*common, "--steps", "4"]) == 0  # and back on one device
    assert "[train] resumed from step 3" in capfd.readouterr().out
    js = tmp_path / "infer.json"
    assert infer.main(["--preset", "pdunet_parallel", "--device", "cpu", "--ckpt-dir", str(ck),
                       "--batch", "4", "--n-slices", "4", "--json-out", str(js),
                       *[a for k, v in SMALL.items() if not k.startswith("train.")
                         for a in ("--set", f"{k}={v}")]]) == 0
    assert json.loads(js.read_text())["ckpt_step"] == 4
