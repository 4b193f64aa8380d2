"""The frozen counts are what the benchmark's own counting code gives, and
its projector count is the program's own formula on the program's plans
(the copy is faithful; the harness never calls the program's count)."""

import json

import pytest

from portbench import counting, harness

CONFIGS = [c["name"] for c in harness.load_spec()["configs"]]


def _cfg(name):
    return json.loads((harness.HERE / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", CONFIGS)
def test_frozen_counts_are_the_code(name):
    frozen = json.loads((harness.HERE / "counts" / f"{name}.json").read_text())
    assert frozen == json.loads(json.dumps(counting.counts(_cfg(name))))


@pytest.mark.parametrize("name", CONFIGS)
def test_projector_count_is_the_programs(name):
    from pdunet_tpu_torch.bench import projector_flops_per_apply
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.geometry import build_parallel_plan
    from pdunet_tpu_torch.ops.nufft.fourier_slice import build_fs_plan
    from pdunet_tpu_torch.training.tasks import build_geometries

    config = get_preset(_cfg(name)["preset"])
    _, sparse = build_geometries(config.geometry)
    plan = (build_fs_plan(sparse, device="cpu").par_plan if config.geometry.kind == "radial"
            else build_parallel_plan(sparse, device="cpu"))
    want = projector_flops_per_apply(plan.meta, plan.spec.shape[0], plan.Wc.shape[1])
    groups = counting.projector_groups(_cfg(name))
    assert sum(g["flops_per_image"] for g in counting._group_counts(groups)) == want
    assert (groups["family"] == "pair") == plan.meta["use_pairs"]


@pytest.mark.parametrize("name", CONFIGS)
def test_parameter_shapes_are_the_programs(name):
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.training.tasks import build_task

    config = get_preset(_cfg(name)["preset"]).override(
        {"geometry.image_size": 32, "geometry.n_angles": 64 if "radial" in name else 40})
    model = build_task(config, device="cpu").model
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == counting.pdunet_shapes(_cfg(name))


def test_conv_count_matches_a_direct_count():
    """At a tiny size the stubbed count equals FlopCounterMode over the
    program's own model with its operators (the projector kernels are
    ctypes calls or einsums that the counter scores separately)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.training.tasks import build_task

    config = get_preset("pdunet_parallel").override(
        {"geometry.image_size": 32, "geometry.n_angles": 40, "model.base_features": 8,
         "model.use_bfloat16": False, "train.batch_size": 1})
    task = build_task(config, device="cpu")
    task.model.A = lambda f: torch.zeros((f.shape[0], 10, 32)) + f[:, :1, :1] * 0
    task.model.At = lambda p: torch.zeros((p.shape[0], 32, 32)) + p[:, :1, :1] * 0
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        task.model(torch.zeros(1, 10, 32), torch.zeros(1, 32, 32))
    cfg = harness.resolved(_cfg("pdunet_parallel"), config)
    assert counting.conv_flops(cfg, train=False) == counter.get_total_flops()
