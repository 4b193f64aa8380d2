"""The program's spans as ``portbench/spans.py`` and the metric files it
loads read them: on tiny CPU runs of every cell each of the cell's readers
(``read`` in ``tests/cells/<cell>.json``) gives a number, a run with no
recording gives none, ``idle_spans`` names only program spans, and the
window's spans are those before its profiled slice. On the card: every span's device start against its host start, the
root spans' launch counts as ``spans.launches`` reports them, a card step's
marks under a CPU recording, and a CUDA graph captured while recording."""

import math
import types

import pytest
import torch

from portbench import harness, spans
from portbench.tests.tiny import CELLS, SEED, cell as tiny


def test_every_reader_is_a_metric_file_read_in_some_cell():
    assert set(spans.METRICS) == {n for cell in CELLS for n in tiny(cell)["read"]}
    for name in spans.METRICS:
        assert (harness.HERE / "metrics" / f"{name}.py").is_file()


@pytest.mark.parametrize("cell", CELLS)
def test_readers_on_a_recorded_run(cell):
    from pdunet_tpu_torch.utils.trace import NAMES

    t = tiny(cell)
    out = spans.record_cell(cell, SEED, 0.3, device="cpu", config_overrides=t["config"],
                            traffic_overrides=t["traffic"])
    assert out["result"]["correct"] is True and out["spans"] > 0
    assert set(out["metrics"]) == set(t["read"])
    assert all(math.isfinite(v) and v >= 0 for v in out["metrics"].values())
    named = {n for n, _ in out["idle_spans"]}
    assert named and named <= set(NAMES) | {"(no host event)"}
    assert out["untraced_rate"] > 0
    # calls on the CPU count no launch: the roots are there, their counts empty
    assert out["launches"] == {r: {} for r in t["roots"]} and out["setup_counts"] == {}


@pytest.mark.parametrize("cell", CELLS)
def test_no_recording_no_reading(cell):
    t = tiny(cell)
    kept = []
    with spans._runs_kept(kept):
        harness.run_cell(cell, SEED, 0.2, True, device="cpu", config_overrides=t["config"],
                         traffic_overrides=t["traffic"])
    (run,) = kept
    assert run.window_ns > 0
    assert all(harness.read_metric(name, run) is None for name in spans.METRICS)
    assert spans.launches(run) == {} and spans.setup_counts(run) == {}


def _span(i, name, t0, t1, parent=None, profiled=False, counts=None):
    from pdunet_tpu_torch.utils.trace import Span

    return Span(name, i, parent, i if parent is None else parent, t0, t1, t0 + 1, t1 + 1,
                profiled, counts or {})


def test_window_spans_stop_at_the_profiled_slice():
    """Set-up's spans, the profiled slice and every span after it are left
    out; launches take the window's roots, set-up's counts its roots."""
    run = types.SimpleNamespace(window_ns=100, elapsed=1e-6, spans=[
        _span(0, "train.step", 10, 90, counts={"kernels_loaded": 2}),
        _span(1, "train.step", 100, 200, counts={"a.launches": 4}),
        _span(2, "train.backward", 150, 190, parent=1),
        _span(3, "train.step", 200, 300, counts={"a.launches": 6}),
        _span(4, "train.step", 300, 400, profiled=True, counts={"a.launches": 4}),
        _span(5, "train.step", 400, 500, counts={"a.launches": 4, "b.launches": 1}),
        _span(6, "train.step", 1100, 1200, counts={"a.launches": 9})])
    assert [s.id for s in spans.window_spans(run, "train.step")] == [1, 3]
    assert [s.id for s in spans.window_spans(run, "train.backward")] == [2]
    assert spans.median_ms(spans.window_spans(run, "train.step"), "host_start",
                           "host_end") == pytest.approx(100e-6)
    assert spans.launches(run) == {"train.step": {"a.launches": 4, "b.launches": 0}}
    assert spans.setup_counts(run) == {"kernels_loaded": 2}


# -- on the card -------------------------------------------------------------------

#: launches per warm request's synthesis and recon and per train step
#: (PERF.md's kernel table: 2 split calls of each operator in synthesis and
#: the direct recon, 8 bf16 per recon; a step 16 + 2 forward and 14 + 2
#: adjoint calls)
def _calls(names, fwd, adj):
    """{counter: n} of ``fwd`` (tc, split) forward and ``adj`` adjoint calls."""
    return {f"{f}.{k}": v for f, (tc, split) in zip(names, (fwd, adj))
            for k, v in (("launches", tc + split), ("launches_tc", tc),
                         ("launches_split", split)) if v}


PER_ROOT = {
    preset: {"synthesis": _calls(names, (0, 2), (0, 2)),
             "recon": _calls(names, (8, 0), (8, 0)),
             "train.step": _calls(names, (16, 2), (14, 2))}
    for preset, names in {"pdunet_parallel": ("project_pair_group", "backproject_pair_group"),
                          "pdunet_radial": ("project_group", "backproject_group")}.items()}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest portbench/tests -m card on the chip")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("preset", sorted(PER_ROOT))
def test_spans_on_the_card(preset):
    """Full-width requests at batch 8 and train steps at batch 4: no span
    starts on the device more than 0.05 ms before its host start, and
    ``spans.launches`` gives each root's launches."""
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.training.loop import build_state, make_train_step
    from pdunet_tpu_torch.training.tasks import build_task
    from pdunet_tpu_torch.utils import trace

    dev = _card()
    cfg = get_preset(preset)
    images = torch.rand(8, cfg.geometry.image_size, cfg.geometry.image_size, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(1))
    serve = build_task(cfg.override({"train.batch_size": 8}), device=dev)
    train = build_task(cfg.override({"train.batch_size": 4}), device=dev)
    state, step = build_state(train), make_train_step(train)

    def request():
        with torch.inference_mode():
            serve.recon_fn(serve.model, serve.batch_from_images(images))

    def gen(i):
        return torch.Generator(device=dev).manual_seed(10 + i)

    request(), step(state, gen(0))  # tables and libraries: set-up
    with trace.recording(dev) as rec:
        for i in range(3):
            request()
            marks = []
            step(state, gen(1 + i), marks)
    got = rec.spans()
    assert {s.name for s in got} == {"synthesis", "recon", "pd.dual", "pd.primal",
                                     "train.step", "train.synthesis", "train.forward",
                                     "train.backward", "train.optimizer"}
    for s in got:
        assert s.device_start >= s.host_start - 50_000, s
        assert s.device_end >= s.device_start, s
    roots = [s.name for s in got if s.parent is None]
    assert roots == ["synthesis", "recon", "train.step"] * 3
    run = types.SimpleNamespace(spans=got, window_ns=0, elapsed=math.inf)
    assert spans.launches(run) == PER_ROOT[preset]
    assert [n for n, _ in marks] == ["start", "synthesis", "forward", "backward", "optimizer"]
    assert all(isinstance(ev, torch.cuda.Event) for _, ev in marks)


@pytest.mark.card
def test_card_step_marks_under_a_cpu_recording_raise():
    """A recording on the CPU records no CUDA event: a card step asked for
    marks raises instead of timing the host's dispatch."""
    from pdunet_tpu_torch.configs import get_preset
    from pdunet_tpu_torch.training.loop import build_state, make_train_step
    from pdunet_tpu_torch.training.tasks import build_task
    from pdunet_tpu_torch.utils import trace

    dev = _card()
    task = build_task(get_preset("pdunet_parallel").override({"train.batch_size": 2}),
                      device=dev)
    state, step = build_state(task), make_train_step(task)
    with trace.recording():
        with pytest.raises(RuntimeError, match="no CUDA event"):
            step(state, torch.Generator(device=dev).manual_seed(1), [])
    marks = []
    with trace.recording(dev):
        step(state, torch.Generator(device=dev).manual_seed(2), marks)
    assert all(isinstance(ev, torch.cuda.Event) for _, ev in marks)


@pytest.mark.card
def test_a_graph_captured_while_recording():
    """A span inside a CUDA graph's capture records no event and raises
    nothing; the graph replays."""
    from pdunet_tpu_torch.utils import trace

    dev = _card()
    x = torch.arange(4096.0, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        y = x * 2
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with trace.recording(dev) as rec:
        with torch.cuda.graph(graph):
            with trace.span("recon"):
                y = x * 2 + 1
        graph.replay()
    (s,) = rec.spans()
    assert s.device_start is None and s.device_end is None
    assert torch.equal(y, x * 2 + 1)
