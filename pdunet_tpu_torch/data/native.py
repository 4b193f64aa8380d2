"""ctypes bindings for the native host-side data engine (a copy of
``pdunet_tpu/data/native.py``).

Multithreaded phantom rasterisation and analytic sinogram synthesis in C++
(``native/pdunet_native.cpp``), with numpy fallbacks where the library
cannot be built. The library is built at first use with the flags of
``native/Makefile``:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared -lpthread \\
        -o pdunet_tpu_torch/_build/libpdunet_native-<hash>.so native/pdunet_native.cpp

into the port's gitignored build directory (``ops/radon/_build.py``'s),
named by a hash of the source and of this CPU's feature flags
(``-march=native``), so an edited source, or a checkout moved to another
machine, is rebuilt, and ``native/`` is only read. ``available()`` says
whether it loaded; a caller that must not run the fallback (the card's
smoke test) asserts it.

The C entry points release the GIL (pure C ABI), so :class:`HostPrefetcher`
gets real parallelism between batch production and the device step.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import queue
import shutil
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

from pdunet_tpu_torch.data import phantoms
from pdunet_tpu_torch.ops.radon._build import BUILD_DIR

__all__ = [
    "available",
    "library_path",
    "rasterize_ellipses",
    "analytic_parallel_sinogram",
    "phantom_batch",
    "HostPrefetcher",
]

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "pdunet_native.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LD_FLAGS = ("-shared", "-lpthread")

_lock = threading.Lock()
_lib = None
_tried = False


def _cpu_flags() -> bytes:
    """This CPU's feature flags (what ``-march=native`` builds for)."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return platform.machine().encode()


def library_path() -> pathlib.Path:
    """Where the library of the current source is (or would be) built for
    this CPU."""
    digest = hashlib.sha256(SOURCE.read_bytes() + _cpu_flags()).hexdigest()[:12]
    return BUILD_DIR / f"libpdunet_native-{digest}.so"


def _build() -> pathlib.Path:
    lib = library_path()
    if lib.exists():
        return lib
    cxx = shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler (g++ or c++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp), *LD_FLAGS],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent build never sees a partial file
    return lib


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError):
            return None
        dp = ctypes.POINTER(ctypes.c_double)
        fp = ctypes.POINTER(ctypes.c_float)
        lib.pdunet_rasterize.argtypes = [
            dp, ctypes.c_int, fp, ctypes.c_int, ctypes.c_double, ctypes.c_int, ctypes.c_int,
        ]
        lib.pdunet_analytic_sinogram.argtypes = [
            dp, ctypes.c_int, dp, ctypes.c_int, fp, ctypes.c_int, ctypes.c_double,
            ctypes.c_int,
        ]
        lib.pdunet_phantom_batch.argtypes = [
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int, fp, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_double, ctypes.c_int,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library built and loaded."""
    return _load() is not None


def _as_c(arr, dtype):
    a = np.ascontiguousarray(arr, dtype)
    return a, a.ctypes.data_as(
        ctypes.POINTER(ctypes.c_double if dtype == np.float64 else ctypes.c_float))


def rasterize_ellipses(ellipses: np.ndarray, image_size: int, pixel_spacing: float = 1.0,
                       supersample: int = 4, n_threads: int = 0) -> np.ndarray:
    """Native rasteriser; the numpy one where the library is unavailable."""
    lib = _load()
    if lib is None:
        return phantoms.rasterize_ellipses(ellipses, image_size, pixel_spacing, supersample)
    ell, ell_p = _as_c(ellipses, np.float64)
    out = np.empty((image_size, image_size), np.float32)
    lib.pdunet_rasterize(ell_p, len(ell), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                         image_size, pixel_spacing, supersample, n_threads)
    return out


def analytic_parallel_sinogram(ellipses: np.ndarray, angles: np.ndarray, det_count: int,
                               det_spacing: float = 1.0, n_threads: int = 0) -> np.ndarray:
    """Native closed-form sinogram (A, S); numpy where the library is unavailable."""
    lib = _load()
    if lib is None:
        return phantoms.analytic_parallel_sinogram(ellipses, angles, det_count, det_spacing)
    ell, ell_p = _as_c(ellipses, np.float64)
    ang, ang_p = _as_c(angles, np.float64)
    out = np.empty((len(ang), det_count), np.float32)
    lib.pdunet_analytic_sinogram(ell_p, len(ell), ang_p, len(ang),
                                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                 det_count, det_spacing, n_threads)
    return out


def phantom_batch(seed: int, batch: int, image_size: int, n_ellipses: int = 8,
                  pixel_spacing: float = 1.0, supersample: int = 2,
                  radius_frac: float = 0.45, n_threads: int = 0) -> Optional[np.ndarray]:
    """Native random phantom batch, or None where the library is unavailable
    (its generator is the C++ one, so numpy has no identical fallback)."""
    lib = _load()
    if lib is None:
        return None
    out = np.empty((batch, image_size, image_size), np.float32)
    lib.pdunet_phantom_batch(seed, batch, n_ellipses,
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             image_size, pixel_spacing, supersample, radius_frac, n_threads)
    return out


class _ProducerError:
    """A producer-thread exception carried across the queue."""

    def __init__(self, exc: BaseException):
        self.exc = exc


class HostPrefetcher:
    """Background-thread batch producer over a bounded queue.

    ``make_batch(i)`` makes item ``i``; up to ``depth`` items wait ahead of
    the consumer. An exception in the producer is raised from ``next()``
    (as a RuntimeError from it), never lost; ``close()`` stops the thread.
    """

    def __init__(self, make_batch, depth: int = 2):
        self._make = make_batch
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._idx = 0
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            try:
                item = self._make(self._idx)
            except BaseException as exc:  # surfaced in __next__, not lost
                item = _ProducerError(exc)
            self._idx += 1
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
            if isinstance(item, _ProducerError):
                return

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        item = self._q.get()
        if isinstance(item, _ProducerError):
            raise RuntimeError("HostPrefetcher producer failed") from item.exc
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
