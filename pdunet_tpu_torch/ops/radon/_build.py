"""Build the CUDA sources of ``csrc/`` with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles, at first use,
into ``pdunet_tpu_torch/_build/lib<name>-<hash>.so`` (the hash is of the
source and the ``csrc/*.cuh`` headers it includes, directly or through
another header, so an edited kernel or header is rebuilt). Build or load failures raise.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

No ``--use_fast_math``: the kernels need precise ``sincosf`` on arguments
of ~10³ rad to hold their float32 tolerance.

``kernels_built`` counts the nvcc builds of this process, ``kernels_loaded``
its libraries loaded (both registered with ``utils/trace.py``, whose root
spans keep their change); a real load runs inside the span ``setup.kernels``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

from pdunet_tpu_torch.utils import trace

__all__ = ["SOURCES", "build", "build_all", "load_library"]

_CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "_build"
SOURCES = ("radon_pair_tc", "radon_pair_split", "radon_group_tc", "radon_group_split",
           "radon_proto_tc", "radon_pair_proto_tc")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}
kernels_built = kernels_loaded = 0
trace.counter("kernels_built", lambda: kernels_built)
trace.counter("kernels_loaded", lambda: kernels_loaded)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise FileNotFoundError("nvcc not found on PATH or in /usr/local/cuda/bin")


_INCLUDE = re.compile(rb'^#include "([^"]+)"', re.MULTILINE)


def _headers(text: bytes) -> list:
    """The ``csrc/`` headers that ``text`` includes, directly or through
    another header, each once, in a fixed order."""
    seen, todo = [], sorted(_INCLUDE.findall(text))
    while todo:
        header = todo.pop(0).decode()
        if header not in seen:
            seen.append(header)
            todo += sorted(_INCLUDE.findall((_CSRC / header).read_bytes()))
    return seen


def _target(name: str, defines: tuple = ()) -> tuple:
    src = _CSRC / f"{name}.cu"
    text = src.read_bytes()
    h = hashlib.sha256(text)
    for header in _headers(text):
        h.update((_CSRC / header).read_bytes())
    h.update(" ".join(defines).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, defines: tuple = ()):
    """Start nvcc for ``name`` (with ``-D`` for each of ``defines``) unless
    its library exists; returns (name, lib path, Popen or None, tmp path)."""
    src, lib = _target(name, defines)
    if lib.exists():
        return name, lib, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return name, lib, proc, tmp


def _finish(name, lib, proc, tmp) -> str:
    global kernels_built
    if proc is None:
        return ""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)  # atomic: concurrent builders never see a partial file
    kernels_built += 1
    return log


def build_all(names=SOURCES) -> dict:
    """Compile every source at once (one nvcc each, started together) and
    return {name: compiler log}; a source already built returns ""."""
    started = [_start(n) for n in names]
    return {s[0]: _finish(*s) for s in started}


def build(name: str, defines: tuple = ()) -> pathlib.Path:
    _finish(*_start(name, defines))
    return _target(name, defines)[1]


def load_library(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (with the preprocessor ``defines``, a
    test-only build of its own) if needed and load it (once per process)."""
    global kernels_loaded
    with _lock:
        key = (name, defines)
        if key not in _loaded:
            with trace.span("setup.kernels"):
                _loaded[key] = ctypes.CDLL(str(build(name, defines)))
            kernels_loaded += 1
        return _loaded[key]
