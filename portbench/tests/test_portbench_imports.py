"""Nothing of the benchmark imports JAX or the JAX package (top-level names
compared whole: ``pdunet_tpu_torch`` is not ``pdunet_tpu``), and the
reference imports nothing of the program."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from portbench import harness

FILES = sorted(p for p in harness.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: pathlib.Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(harness.HERE)))
def test_no_jax_import(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(harness.HERE)))
def test_reference_imports_nothing_of_the_program(path):
    assert "pdunet_tpu_torch" not in _imports(path)


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process leaves no forbidden module in
    ``sys.modules``."""
    code = (
        "import sys, json; sys.path.insert(0, %r)\n"
        "from portbench import harness\n"
        "from portbench.tests.tiny import SEED, cell\n"
        "t = cell('pdunet_parallel.volume')\n"
        "harness.run_cell('pdunet_parallel.volume', SEED, 0.2, True, device='cpu',"
        " config_overrides=t['config'], traffic_overrides=t['traffic'])\n"
        "print(json.dumps(harness.forbidden_modules()))\n" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
