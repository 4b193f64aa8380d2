"""The frozen counts are what the benchmark's own counting code gives, and
its projector count is the program's own formula on the program's plans
(the copy is faithful; the harness never calls the program's count)."""

import json

import pytest

from portbench import counting, harness, modules
from portbench.tests.tiny import CONFIGS, config_overrides


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
    """The model file's shapes at the configuration's widths (the program
    built at its cells' tiny geometry)."""
    from pdunet_tpu_torch.training.tasks import build_task

    cfg = _cfg(name)
    tiny = {k: v for k, v in config_overrides(name).items() if k.startswith("geometry.")}
    model = build_task(harness.program_config(cfg, {"batch": 1}, tiny), device="cpu").model
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert shapes == modules.reference_model(cfg["model"]["kind"]).shapes(cfg)


@pytest.mark.parametrize("train", [False, True], ids=["recon", "train"])
@pytest.mark.parametrize("name", CONFIGS)
def test_conv_count_matches_a_direct_count(name, train):
    """At the configuration's cells' tiny sizes the stubbed count equals
    FlopCounterMode over the program's own model, its operators replaced by
    the same stubs (the projector kernels are ctypes calls or einsums that
    the counter scores separately), and so do the operators' calls."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from pdunet_tpu_torch.training.tasks import build_task

    config = harness.program_config(_cfg(name), {"batch": 1}, config_overrides(name))
    cfg = harness.resolved(_cfg(name), config)
    task = build_task(config, device="cpu")
    N = config.geometry.image_size
    A, S = counting._sino_shape(cfg)
    dt = torch.complex64 if task.model.complex_ops else torch.float32
    calls = {"forward": 0, "backward": 0}
    task.model.A = lambda f: counting._Stub.apply(f, A, S, calls)
    task.model.At = lambda p: counting._Stub.apply(p, N, N, calls)
    with torch.set_grad_enabled(train), FlopCounterMode(display=False) as counter:
        out = task.model(torch.zeros(1, A, S, dtype=dt), torch.zeros(1, N, N, dtype=dt))
        if train:
            out.abs().mean().backward()
    assert counting.network_counts(cfg, train) == {"conv_flops": counter.get_total_flops(),
                                                   **calls}
