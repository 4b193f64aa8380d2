"""The port's spans (``pdunet_tpu_torch/utils/trace.py``) on the CPU: the
off path, nesting and ids, the profiler's ranges, the train step's
``marks=``, outputs unchanged by recording, remat's recomputed spans, the
kernel counters' changes over root spans (registered by the kernel
layer), a card step's marks without events, and the spans each entry
point opens. Tiny tasks: 32², 24 of 96 angles (radial: 24 of 96 spokes), base 8,
depth 2, stem 2, 2 iterations, batch 2."""

import types

import pytest
import torch

from pdunet_tpu_torch import infer
from pdunet_tpu_torch.configs import get_preset
from pdunet_tpu_torch.ops.radon import _build, cuda_kernels
from pdunet_tpu_torch.training import loop
from pdunet_tpu_torch.training.tasks import build_task
from pdunet_tpu_torch.utils import trace

torch.set_num_threads(1)

SMALL = {"geometry.image_size": 32, "geometry.n_angles": 96, "model.base_features": 8,
         "model.depth": 2, "model.stem": 2, "model.n_iters": 2, "train.batch_size": 2}
PHASES = ["start", "synthesis", "forward", "backward", "optimizer"]


def _config(preset="pdunet_parallel", **over):
    return get_preset(preset).override({**SMALL, **over})


def _task(preset="pdunet_parallel", **over):
    return build_task(_config(preset, **over), device="cpu")


def _by_name(spans, name):
    return [s for s in spans if s.name == name]


def test_off_span_is_one_shared_no_op(monkeypatch):
    """No recording and no profiler: every name gets the same object, which
    opens no profiler range and records nothing."""
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a: pytest.fail("a range opened with tracing off"))
    assert trace.active() is None
    a, b = trace.span("recon"), trace.span("train.step")
    assert a is b
    with a as inner:
        assert inner is a and trace.active() is None


@pytest.mark.parametrize("profiled", [False, True])
def test_nesting_ids_and_profiled(profiled):
    """Parents, roots and ids follow the nesting; under a running profiler
    each span is also a record_function range and says so."""
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    if profiled:
        prof.start()
    try:
        with trace.recording() as rec:
            with trace.span("train.step"):
                with trace.span("train.synthesis"):
                    pass
                with trace.span("train.forward"):
                    with trace.span("pd.dual"):
                        pass
            with trace.span("setup.plans"):
                pass
    finally:
        if profiled:
            prof.stop()
    spans = rec.spans()
    assert [(s.name, s.id, s.parent, s.root) for s in spans] == [
        ("train.step", 0, None, 0), ("train.synthesis", 1, 0, 0), ("train.forward", 2, 0, 0),
        ("pd.dual", 3, 2, 0), ("setup.plans", 4, None, 4)]
    assert all(s.profiled is profiled for s in spans)
    for s in spans:
        assert s.host_start <= s.host_end
        # on the CPU the device's clock is the host's
        assert (s.device_start, s.device_end) == (s.host_start, s.host_end)
    inner, outer = spans[3], spans[2]
    assert outer.host_start <= inner.host_start <= inner.host_end <= outer.host_end
    if profiled:
        ranges = [e.name for e in prof.events()]
        assert all(ranges.count(n) == 1
                   for n in ("train.step", "train.synthesis", "train.forward", "pd.dual"))
    assert trace.active() is None


def test_recording_is_one_at_a_time_and_survives_exceptions():
    with trace.recording() as rec:
        with pytest.raises(RuntimeError, match="already active"):
            with trace.recording():
                pass
        with pytest.raises(ValueError):
            with trace.span("synthesis"):
                with trace.span("recon"):
                    raise ValueError
        with trace.span("train.step"):
            pass
    assert [(s.name, s.parent) for s in rec.spans()] == [
        ("synthesis", None), ("recon", 0), ("train.step", None)]
    assert trace.active() is None


@pytest.mark.parametrize("recorded", [False, True])
def test_marks_are_the_step_spans_boundaries(recorded):
    """``marks=`` gets the five boundaries in order, from the step's spans,
    with or without a recording around the step; ``split_ms`` keeps its
    keys."""
    task = _task()
    state, step = loop.build_state(task), loop.make_train_step(task)
    marks = []
    if recorded:
        with trace.recording() as rec:
            step(state, torch.Generator().manual_seed(1), marks)
        spans = {s.name: s for s in rec.spans()}
        want = [spans["train.step"].host_start] + [
            spans[f"train.{p}"].host_end for p in PHASES[1:]]
        assert [t for _, t in marks] == [ns * 1e-9 for ns in want]
    else:
        step(state, torch.Generator().manual_seed(1), marks)
        assert trace.active() is None
    assert [name for name, _ in marks] == PHASES
    assert all(isinstance(t, float) for _, t in marks)
    assert [t for _, t in marks] == sorted(t for _, t in marks)
    split = loop.split_ms(marks)
    assert list(split) == PHASES[1:] and all(v >= 0 for v in split.values())


def _serve_and_step(task) -> dict:
    """The synthesised batch, its recon, and the metrics and parameters
    after one train step, from fixed weights and seeds."""
    task.init_params(torch.Generator().manual_seed(3))
    images = torch.rand(2, 32, 32, generator=torch.Generator().manual_seed(4))
    with torch.inference_mode():
        batch = task.batch_from_images(images)
        out = {"recon": task.recon_fn(task.model, batch), **batch}
    state = loop.build_state(task)
    state.step = 3  # past lr(0) = 0, so the update moves the weights
    metrics = loop.make_train_step(task)(state, torch.Generator().manual_seed(5))
    out.update(metrics)
    out.update({f"param.{k}": v.detach().clone() for k, v in task.model.state_dict().items()})
    return out


@pytest.mark.parametrize("preset", ["pdunet_parallel", "pdunet_radial"])
def test_recording_changes_no_output(preset):
    """Synthesis, recon and a train step give bit-identical outputs and
    states with recording on and off."""
    off = _serve_and_step(_task(preset))
    with trace.recording() as rec:
        on = _serve_and_step(_task(preset))
    assert list(off) == list(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k
    names = [s.name for s in rec.spans()]
    for name in ("synthesis", "recon", "pd.dual", "pd.primal", "train.step", "setup.plans",
                 "setup.opnorm"):
        assert name in names


def test_remat_spans_nest_under_the_backward():
    """Under remat the unroll's recomputation opens pd.* again inside
    train.backward; every span closes and the step's results are
    remat-free's."""
    results = []
    for remat in (False, True):
        task = _task(**{"model.remat": remat})
        task.init_params(torch.Generator().manual_seed(3))
        state = loop.build_state(task)
        state.step = 3
        with trace.recording() as rec:
            metrics = loop.make_train_step(task)(state, torch.Generator().manual_seed(5))
        results.append((metrics, task.model.state_dict()))
        spans = rec.spans()
        ids = {s.name: s.id for s in spans if s.name.startswith("train.")}
        under = {n: [s.name for s in spans if s.parent == ids[n]]
                 for n in ("train.forward", "train.backward")}
        assert under["train.forward"] == ["pd.dual", "pd.primal"] * 2
        if remat:
            assert "pd.dual" in under["train.backward"]
            assert "pd.primal" in under["train.backward"]
        else:
            assert under["train.backward"] == []
        assert all(s.root == ids["train.step"] for s in spans)
        assert len(spans) == len(rec._spans) and rec._stack == []
    for k in results[0][0]:
        assert torch.equal(results[0][0][k], results[1][0][k]), k
    for k in results[0][1]:
        assert torch.equal(results[0][1][k], results[1][1][k]), k


@pytest.mark.parametrize("counter, by", [
    ("project_pair_group.launches_tc", 8), ("backproject_pair_group.launches_split", 2),
    ("build_group_split_tables.launches", 1), ("kernels_built", 1), ("kernels_loaded", 2)])
def test_root_spans_carry_the_counters_changes(monkeypatch, counter, by):
    """Calls on the CPU count nothing, so the counter is moved by hand; the
    root span over it carries the change, its children nothing."""
    if counter.startswith("kernels_"):
        owner, attr = _build, counter
    else:
        name, attr = counter.split(".")
        owner = getattr(cuda_kernels, name)
    monkeypatch.setattr(owner, attr, getattr(owner, attr) + 5)
    with trace.recording() as rec:
        with trace.span("train.step"):
            with trace.span("train.forward"):
                setattr(owner, attr, getattr(owner, attr) + by)
        with trace.span("synthesis"):
            pass
    root, child, idle = rec.spans()
    assert root.counts == {counter: by}
    assert child.counts == {} and idle.counts == {}


def test_a_real_library_load_opens_setup_kernels(monkeypatch, tmp_path):
    """``load_library`` opens ``setup.kernels`` on the load that builds and
    loads the library, and not on a later call that finds it loaded."""
    loaded = {}
    monkeypatch.setattr(_build, "_loaded", loaded)
    monkeypatch.setattr(_build, "build", lambda name, defines=(): tmp_path / f"lib{name}.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "kernels_loaded", 0)
    with trace.recording() as rec:
        with trace.span("setup.opnorm"):
            first = _build.load_library("radon_pair_tc")
        second = _build.load_library("radon_pair_tc")
    assert first is second and _build.kernels_loaded == 1
    outer, load = rec.spans()
    assert (load.name, load.parent) == ("setup.kernels", outer.id)
    assert outer.counts == {"kernels_loaded": 1}


@pytest.mark.parametrize("preset, plans, opnorm", [
    ("pdunet_parallel", 2, 1), ("pdunet_radial", 2, 1), ("fbp_unet_parallel", 1, 0),
    ("lpd_parallel", 2, 1)])
def test_build_task_set_up_spans(preset, plans, opnorm):
    """``build_task`` opens ``setup.plans`` for each operator it builds
    (bf16 unroll and f32 synthesis) and ``setup.opnorm`` for σ."""
    with trace.recording() as rec:
        task = _task(preset)
    names = [s.name for s in rec.spans()]
    assert names.count("setup.plans") == plans and names.count("setup.opnorm") == opnorm
    assert (task.sigma is None) == (opnorm == 0)


def test_infer_batches_open_synthesis_and_recon_roots():
    """``infer`` opens ``synthesis`` and ``recon`` (with its unroll spans)
    once per batch, each a root."""
    flags = ["--preset", "pdunet_parallel", "--device", "cpu", "--n-slices", "4",
             "--batch", "2", *[a for k, v in SMALL.items() for a in ("--set", f"{k}={v}")]]
    with trace.recording() as rec:
        assert infer.main(flags) == 0
    spans = rec.spans()
    roots = [s for s in spans if s.parent is None and not s.name.startswith("setup.")]
    assert [r.name for r in roots] == ["synthesis", "recon"] * 2
    for r in roots:
        mine = [s.name for s in spans if s.root == r.id and s.id != r.id]
        assert mine == ([] if r.name == "synthesis" else ["pd.dual", "pd.primal"] * 2)


@pytest.mark.parametrize("n_iters", [2, 3])
def test_lpd_recon_opens_its_unroll_spans(n_iters):
    """An ``lpd_parallel`` batch opens ``synthesis`` and ``recon`` as roots,
    and under ``recon`` its ConvNets' ``pd.dual`` and ``pd.primal`` once per
    iteration, as the PD-UNet's do."""
    sets = {**SMALL, "model.lpd_features": 8, "model.n_iters": n_iters}
    flags = ["--preset", "lpd_parallel", "--device", "cpu", "--n-slices", "2", "--batch", "2",
             *[a for k, v in sets.items() for a in ("--set", f"{k}={v}")]]
    with trace.recording() as rec:
        assert infer.main(flags) == 0
    spans = rec.spans()
    roots = [s for s in spans if s.parent is None and not s.name.startswith("setup.")]
    assert [r.name for r in roots] == ["synthesis", "recon"]
    nets = [s for s in spans if s.root == roots[1].id and s.id != roots[1].id]
    assert [s.name for s in nets] == ["pd.dual", "pd.primal"] * n_iters
    assert all(s.parent == roots[1].id for s in nets)


def test_counters_are_registered_by_the_kernel_layer():
    """The kernel layer registers its counters; a root span over a counter
    registered inside it counts from 0."""
    assert {"project_pair_group.launches_tc", "backproject_group.launches_split",
            "build_pair_tables.launches", "kernels_built", "kernels_loaded"} <= set(
                trace._COUNTERS)
    n = {"v": 0}
    try:
        with trace.recording() as rec:
            with trace.span("train.step"):
                trace.counter("test.late", lambda: n["v"])
                n["v"] = 3
    finally:
        trace._COUNTERS.pop("test.late", None)
    assert rec.spans()[0].counts == {"test.late": 3}


def test_marks_of_a_card_step_need_its_events():
    """A step on a card under a recording that records no CUDA event (here
    one on the CPU) raises rather than give host seconds as phase times."""
    task = _task()
    state = loop.build_state(task)
    card = types.SimpleNamespace(parameters=lambda: iter(
        [types.SimpleNamespace(device=torch.device("cuda"))]))
    step = loop.make_train_step(task._replace(model=card))
    with trace.recording():
        with pytest.raises(RuntimeError, match="no CUDA event"):
            step(state, torch.Generator().manual_seed(1), [])
        step(state, torch.Generator().manual_seed(2))  # no marks: nothing to raise
    with trace.recording() as rec:
        with trace.span("train.step") as s:
            pass
    assert s.mark(True) == rec.spans()[0].host_end * 1e-9
    with pytest.raises(RuntimeError, match="no CUDA event"):
        s.mark(True, cuda=True)
