"""The harness: a cell's files found by name, its set-up, its loop, its
metrics and the comparison that decides ``correct``.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own under ``portbench/``:

  configs/<config>.json   the configuration as run (the program's preset,
                          every field of it, source, reduced, assumed)
  traffic/<mix>.json      a traffic mix: its ``kind`` and the parameters
                          that kind's loop reads
  kinds/<kind>.py         a kind of traffic: ``loop`` (set-up and window),
                          ``compare`` (the numbers the check compares) and
                          ``controls`` (their readings for the limits)
  metrics/<metric>.py     ``read(run) -> float | None`` for one metric
  counts/<config>.json    frozen operation counts of the configuration
  limits/<cell>.json      the limit of each number the check compares
  tests/cells/<cell>.json the cell's tiny sizes and what its CPU test runs
                          read (config and traffic overrides, span
                          readers, the window's root spans)
  reference/geometries/<kind>.py
                          the plain reference's operators
  reference/models/<kind>.py
                          the plain reference's network: ``shapes(cfg)``
                          and ``unroll``, which the counts also run

``BENCHMARK.json`` names the cells, the metrics and which cells report
which. A new cell is its entry, ``limits/<cell>.json`` and
``tests/cells/<cell>.json``; a new configuration adds its
``configs/`` and ``counts/`` files; a new model kind is one file,
``reference/models/<kind>.py``. None of them edits a file here.
"""

from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import sys
import time
from typing import Callable, Optional

import torch

from portbench import modules
from portbench import phantoms as ph
from portbench.loops import WEIGHT_STREAM

__all__ = ["ROOT", "FORBIDDEN", "load_spec", "cell_files", "cell_metrics", "Run", "run_cell",
           "forbidden_modules"]

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level modules that may not be loaded in a run: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "pdunet_tpu")


def load_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _load_json(path: pathlib.Path) -> dict:
    return json.loads(path.read_text())


def cell_files(spec: dict, cell: str, root: pathlib.Path = ROOT) -> dict:
    """The files of ``cell``, found by the names in ``spec``."""
    work = {w["name"]: w for w in spec["workloads"]}
    if cell not in work:
        raise KeyError(f"no workload {cell!r} in BENCHMARK.json: {sorted(work)}")
    w = work[cell]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "portbench"
    traffic = bench / "traffic" / f"{w['traffic']}.json"
    return {"workload": w,
            "config": root / conf["file"],
            "traffic": traffic,
            "kind": bench / "kinds" / f"{_load_json(traffic)['kind']}.py",
            "counts": bench / "counts" / f"{w['config']}.json",
            "limits": bench / "limits" / f"{cell}.json"}


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The metrics a run of ``cell`` reports: its end-to-end metrics, or
    with ``trace`` its per-layer ones."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def read_metric(name: str, run, root: pathlib.Path = ROOT) -> Optional[float]:
    path = root / "portbench" / "metrics" / f"{name}.py"
    return modules.load(path, f"reader of the metric {name!r}").read(run)


def program_config(cfg: dict, traffic: dict, overrides: Optional[dict] = None):
    """The program's ``ExperimentConfig``: the preset with every field of the
    configuration file, and the traffic's batch."""
    from pdunet_tpu_torch.configs import get_preset

    fields = {f"{sec}.{k}": v for sec in ("geometry", "model", "train")
              for k, v in cfg[sec].items()}
    fields["train.batch_size"] = traffic["batch"]
    fields.update(overrides or {})
    return get_preset(cfg["preset"]).override(fields)


def resolved(cfg: dict, config) -> dict:
    """``cfg`` with the sections of the program config as run."""
    return dict(cfg, **{sec: dataclasses.asdict(getattr(config, sec))
                        for sec in ("geometry", "model", "train")})


def make_weights(shapes: dict, seed: int, device) -> dict:
    """Weights for the parameter ``shapes`` from one standard normal draw on
    the device: convolution kernels scaled by 1/√fan-in (transposed ones,
    laid out (in, out, kh, kw), by their input), biases by 0.01."""
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=ph.generator(device, ph.derive_seed(seed, WEIGHT_STREAM)),
                    device=device)
    out, at = {}, 0
    for k, s in shapes.items():
        n = math.prod(s)
        w = z[at:at + n].reshape(s)
        at += n
        if len(s) == 4:
            fan_in = (s[0] if ".ups." in f".{k}" else s[1]) * s[2] * s[3]
            out[k] = w / math.sqrt(fan_in)
        else:
            out[k] = w * 0.01
    return out


class Run:
    """What one run measured, for the metric readers."""

    def __init__(self, cell: str, seed: int, cfg: dict, traffic: dict, counts: dict, device,
                 t_start: float):
        self.cell, self.seed, self.cfg, self.traffic, self.counts = cell, seed, cfg, traffic, counts
        self.device, self.t_start = device, t_start
        self.setup_s = self.elapsed = None
        self.units = self.attempted = 0
        self.latencies, self.trace, self.trace_units = [], None, 0
        self.untraced_rate, self.phase_ms, self.memory_peak = None, None, 0
        self.setup_phases, self._last = {}, t_start

    def mark(self, phase: str):
        """End a named phase of set-up (seconds since the last mark)."""
        now = time.perf_counter()
        self.setup_phases[phase] = now - self._last
        self._last = now

    def setup_end(self):
        self.mark("loop")
        self.setup_s = time.perf_counter() - self.t_start

    def read_memory(self):
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, config_overrides: Optional[dict] = None,
             traffic_overrides: Optional[dict] = None, root: pathlib.Path = ROOT,
             on_check: Optional[Callable] = None) -> dict:
    """One run of ``cell``: set-up, the window, the metrics, the check.
    Returns the result object (the run's last line of output). The overrides
    shrink a cell for the CPU tests. ``on_check(numbers, controls)``, where
    given, gets the numbers compared and a function that reads the
    control's (and the planted faults') numbers on the same state: the
    readings of the limits."""
    from pdunet_tpu_torch.training.tasks import build_task
    from portbench.reference.tasks import RefTask

    t_start = time.perf_counter() if t_start is None else t_start
    device = torch.device(device)
    spec = load_spec(root)
    files = cell_files(spec, cell, root)
    cfg, traffic = _load_json(files["config"]), _load_json(files["traffic"])
    traffic.update(traffic_overrides or {})
    kind = modules.load(files["kind"], f"traffic kind {traffic['kind']!r}")
    counts, limits = _load_json(files["counts"]), _load_json(files["limits"])
    config = program_config(cfg, traffic, config_overrides)
    cfg = resolved(cfg, config)
    run = Run(cell, seed, cfg, traffic, counts, device, t_start)
    run.mark("start")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    task = build_task(config, device=device)
    run.mark("build_task")
    shapes = {k: tuple(v.shape) for k, v in task.model.state_dict().items()}
    weights = make_weights(shapes, seed, device)
    task.model.load_state_dict(weights)
    run.mark("weights")
    prog = kind.loop(run, task, seed, seconds, trace)
    del task
    if device.type == "cuda":
        torch.cuda.empty_cache()

    ref = RefTask(cfg, device, root)
    numbers = kind.compare(run, ref, prog, weights)
    if on_check is not None:
        on_check(numbers, lambda: kind.controls(run, ref, prog, weights))
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = set(checks) == set(limits) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())

    metrics = {}
    for m in cell_metrics(spec, cell, trace):
        value = read_metric(m["name"], run, root)
        if value is None:
            if not trace:
                raise RuntimeError(f"end-to-end metric {m['name']} has no reading")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.memory_peak}
    result = {"correct": correct, "attempted": run.attempted, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace.busy_s, run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["setup_phases"] = run.setup_phases
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
