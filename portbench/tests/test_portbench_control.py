"""The control (the reference in the program's place, one precision below
the configuration's) comes out not correct; the program's readings pass.
At a tiny size on the CPU, and at the cells' own sizes on the card."""

import json

import pytest

from portbench import harness
from portbench.calibrate import readings
from portbench.tests.tiny import CELLS, cell as tiny


def _limits(cell):
    return json.loads(harness.cell_files(harness.load_spec(), cell)["limits"].read_text())


def _check(cell, rows):
    limits = _limits(cell)
    fails = lambda r: any(r[k] > v for k, v in limits.items())
    assert rows and not any(fails(r) for r in rows if r["reading"] == "program")
    controls = [r for r in rows if r["reading"] != "program"]
    assert controls and all(fails(r) for r in controls)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_tiny(cell):
    t = tiny(cell)
    _check(cell, readings(cell, [101], 1, 0.2, "cpu", emit=lambda _: None,
                          config_overrides=t["config"], traffic_overrides=t["traffic"]))


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: python -m pytest portbench/tests -m card on the chip")
    _check(cell, readings(cell, [101, 102, 103], 3, 1.0, "cuda", emit=lambda _: None))
