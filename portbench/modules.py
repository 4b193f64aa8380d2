"""Loading a file of the benchmark that is found by a name.

Configurations, traffic kinds, per-layer metrics and the reference's
geometries and models each sit in a file named after them; a later change
adds such a file and a ``BENCHMARK.json`` entry, and edits nothing here.
A model kind is one file, ``reference/models/<kind>.py``, which
:func:`reference_model` loads for both the reference task and the counts.
"""

from __future__ import annotations

import importlib.util
import pathlib

__all__ = ["load", "reference_model"]

ROOT = pathlib.Path(__file__).resolve().parent.parent

_LOADED: dict = {}


def load(path: pathlib.Path, what: str):
    """The module in ``path`` (loaded once per path); ``what`` names it in
    the error when there is no such file."""
    path = pathlib.Path(path).resolve()
    if path not in _LOADED:
        if not path.is_file():
            raise FileNotFoundError(f"no {what}: {path} does not exist")
        name = "portbench_file_" + "_".join(path.with_suffix("").parts[-3:]).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reference_model(kind: str, root: pathlib.Path = ROOT):
    """The reference network of the model kind ``kind``:
    ``portbench/reference/models/<kind>.py`` under the checkout ``root``,
    with ``shapes(cfg)`` (the parameter shapes, keyed as the program's
    ``state_dict``) and ``unroll(m, P, g, f0, A, At, complex_ops, rnd)``."""
    return load(pathlib.Path(root) / "portbench" / "reference" / "models" / f"{kind}.py",
                f"reference model {kind!r}")
