"""The benchmark's cells at tiny sizes, for the CPU tests.

Every cell of ``BENCHMARK.json`` has ``tests/cells/<cell>.json``:
``config`` and ``traffic``, the overrides that shrink it (its runs here
unroll in float32: a sound tiny run then reads far below the limits set
for bf16 at full size, and a broken one far above); ``read``, the span
readers that find something in its runs; ``roots``, its window's root
spans."""

import json
import pathlib

from portbench import harness

HERE = pathlib.Path(__file__).resolve().parent / "cells"
SPEC = harness.load_spec()
CELLS = sorted(w["name"] for w in SPEC["workloads"])
CONFIGS = [c["name"] for c in SPEC["configs"]]

SEED = 2 ** 33 + 17


def cell(name: str) -> dict:
    """The test data of the cell ``name``."""
    return json.loads((HERE / f"{name}.json").read_text())


def config_overrides(config: str) -> dict:
    """The tiny overrides of the configuration ``config``: those of its
    first cell in ``BENCHMARK.json``."""
    return cell(next(w["name"] for w in SPEC["workloads"] if w["config"] == config))["config"]
