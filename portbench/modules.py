"""Loading a file of the benchmark that is found by a name.

Configurations, traffic kinds, per-layer metrics and the reference's
geometries and models each sit in a file named after them; a later change
adds such a file and a ``BENCHMARK.json`` entry, and edits nothing here.
"""

from __future__ import annotations

import importlib.util
import pathlib

__all__ = ["load"]

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
