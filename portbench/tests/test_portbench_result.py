"""The last line's shape, on tiny CPU runs of every cell, and the command's
refusal to run without a card."""

import json
import subprocess
import sys

import pytest

from portbench import harness
from portbench.tests.tiny import CELLS, SEED, cell as tiny

SPEC = harness.load_spec()


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell, trace):
    t = tiny(cell)
    r = harness.run_cell(cell, SEED, 0.3, bool(trace), device="cpu",
                         config_overrides=t["config"], traffic_overrides=t["traffic"])
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "checks" and r["correct"] is True and r["attempted"] >= 1
    assert json.loads(json.dumps(r)) == r
    want = {m["name"] for m in harness.cell_metrics(SPEC, cell, bool(trace))}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] == m["value"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(r["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(r["device"])
        assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in r["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "pdunet_parallel.volume", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=300,
                         cwd=harness.ROOT, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
