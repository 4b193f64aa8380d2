"""File-backed slice stores (a copy of ``pdunet_tpu/data/datasets.py`` with
a second container for the same store).

* :class:`SliceDataset`: a slice store with deterministic train/val/test
  splits;
* :func:`write_store`: slices (and phase) written as a store;
* :func:`write_phantom_dataset`: a reproducible random-ellipse store;
* :func:`convert_volume`: a 3-D volume sliced into a store;
* :func:`iterate_batches`: host batches, shuffled from a seed;
* :func:`h5_to_npy`: an HDF5 store carried into the npy container.

Layout: ``slices`` (n, N, N) float32 (+ ``phase`` of the same shape for
complex MRI data, read as magnitude·e^{i·phase}), and ``splits``, the
(train, val, test) counts, stored contiguously in that order. An optional
``domain`` declares the pixel units: ``"density"`` (the default) is the
O(1) relative-attenuation scale every task trains in; ``"hu"`` marks CT
data in Hounsfield units, converted on read to μ/μ_water = 1 + HU/1000
(water → 1, air → 0).

Two containers hold that layout, picked by the path:

* a path ending in ``.h5`` or ``.hdf5``: one HDF5 file, datasets ``slices``
  (and ``phase``), attributes ``splits`` and ``domain``, as the JAX package
  writes it. This needs ``h5py``, imported only for such a path;
* any other path: a directory with ``slices.npy`` (read memory-mapped),
  ``phase.npy`` and ``attrs.json`` (``{"splits": [...], "domain": ...}``).
  It needs numpy only.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = ["SliceDataset", "write_store", "write_phantom_dataset", "convert_volume",
           "iterate_batches", "h5_to_npy"]

DOMAINS = ("density", "hu")
SPLITS = ("train", "val", "test")


def _is_hdf5(path) -> bool:
    """Whether ``path`` names the HDF5 container (else the npy directory)."""
    return pathlib.Path(path).suffix.lower() in (".h5", ".hdf5")


def _h5py():
    try:
        import h5py
    except ImportError as exc:
        raise ImportError(
            "an .h5 / .hdf5 slice store needs h5py, which is not installed here: "
            "convert it with pdunet_tpu_torch.data.datasets.h5_to_npy where h5py "
            "is, or write an npy directory store (any path without that suffix)"
        ) from exc
    return h5py


def _split_counts(n: int, train_frac: float, val_frac: float) -> tuple:
    n_train = int(round(train_frac * n))
    n_val = int(round(val_frac * n))
    return n_train, n_val, n - n_train - n_val


class _NpyStore:
    """The npy directory container, with the h5py-like reads the dataset uses."""

    def __init__(self, path):
        root = pathlib.Path(path)
        self.attrs = json.loads((root / "attrs.json").read_text())
        self.slices = np.load(root / "slices.npy", mmap_mode="r")
        phase = root / "phase.npy"
        self.phase = np.load(phase, mmap_mode="r") if phase.exists() else None

    def close(self):
        self.slices = self.phase = None


def _write_npy(path, slices, phase, splits, domain=None):
    root = pathlib.Path(path)
    root.mkdir(parents=True, exist_ok=True)
    np.save(root / "slices.npy", np.asarray(slices, np.float32))
    if phase is not None:
        np.save(root / "phase.npy", np.asarray(phase, np.float32))
    attrs = {"splits": [int(c) for c in splits]}
    if domain is not None:
        attrs["domain"] = domain
    (root / "attrs.json").write_text(json.dumps(attrs))


@dataclasses.dataclass
class SliceDataset:
    """A slice store with named splits (either container)."""

    path: str
    split: str = "train"

    def __post_init__(self):
        if _is_hdf5(self.path):
            self._file = _h5py().File(self.path, "r")
            self._slices = self._file["slices"]
            self._phase = self._file["phase"] if "phase" in self._file else None
        else:
            self._file = _NpyStore(self.path)
            self._slices, self._phase = self._file.slices, self._file.phase
        attrs = self._file.attrs
        counts = tuple(int(c) for c in attrs["splits"])
        starts = (0, counts[0], counts[0] + counts[1])
        if self.split not in SPLITS:
            raise ValueError(f"split must be one of {SPLITS}")
        i = SPLITS.index(self.split)
        self._start = starts[i]
        self._count = counts[i]
        self._domain = str(attrs.get("domain", "density"))
        if self._domain not in DOMAINS:
            raise ValueError(f"unknown slice domain {self._domain!r}")

    def __len__(self) -> int:
        return self._count

    @property
    def image_size(self) -> int:
        return int(self._slices.shape[-1])

    @property
    def is_complex(self) -> bool:
        return self._phase is not None

    @property
    def domain(self) -> str:
        return self._domain

    def _parts(self, idx: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        if not 0 <= idx < self._count:
            raise IndexError(idx)
        mag = np.asarray(self._slices[self._start + idx], np.float32)
        if self._domain == "hu":
            mag = 1.0 + mag / 1000.0  # HU → relative attenuation μ/μ_water
        if self._phase is None:
            return mag, None
        return mag, np.asarray(self._phase[self._start + idx], np.float32)

    def __getitem__(self, idx: int) -> np.ndarray:
        mag, phase = self._parts(idx)
        if phase is not None:
            return (mag * np.exp(1j * phase)).astype(np.complex64)
        return mag

    def batch(self, indices) -> np.ndarray:
        return np.stack([self[int(i)] for i in indices])

    def parts(self, indices) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """(magnitudes, phases or None) of ``indices``, stacked float32: the
        magnitudes as ``batch`` reads them (relative attenuation for an HU
        store), the phases as stored, no complex image formed."""
        mags, phases = zip(*(self._parts(int(i)) for i in indices))
        return np.stack(mags), (None if self._phase is None else np.stack(phases))

    def close(self):
        self._file.close()


def write_store(path: str, slices: np.ndarray, phase: Optional[np.ndarray] = None,
                splits: Optional[Tuple[int, int, int]] = None, domain: Optional[str] = None) -> str:
    """Write (n, N, N) ``slices`` (and ``phase``) as a store, the container
    by ``path``, with the (train, val, test) counts ``splits`` (default: all
    test) and, when given, the ``domain`` attribute."""
    splits = (0, 0, len(slices)) if splits is None else splits
    if _is_hdf5(path):
        with _h5py().File(path, "w") as f:
            f.create_dataset("slices", data=slices)
            if phase is not None:
                f.create_dataset("phase", data=phase)
            f.attrs["splits"] = splits
            if domain is not None:
                f.attrs["domain"] = domain
    else:
        _write_npy(path, slices, phase, splits, domain)
    return path


def write_phantom_dataset(path: str, n_slices: int, image_size: int,
                          splits: Tuple[float, float, float] = (0.8, 0.1, 0.1),
                          n_ellipses: int = 8, seed: int = 0,
                          complex_phase: bool = False) -> str:
    """Write a reproducible random-ellipse store (the container by ``path``).

    Slices come from the native rasteriser where it builds (the numpy one
    otherwise); complex stores hold nonnegative magnitudes and a smooth
    random phase of four low-order harmonics."""
    from pdunet_tpu_torch.data import native
    from pdunet_tpu_torch.data.phantoms import random_ellipses

    rng = np.random.default_rng(seed)
    radius = 0.45 * image_size
    shape = (n_slices, image_size, image_size)
    slices = np.empty(shape, np.float32)
    phase = np.empty(shape, np.float32) if complex_phase else None
    for i in range(n_slices):
        slices[i] = native.rasterize_ellipses(
            random_ellipses(rng, n_ellipses, radius, nonneg=complex_phase), image_size)
        if phase is not None:
            ax = np.linspace(-1, 1, image_size)
            X, Y = np.meshgrid(ax, ax)
            c = rng.uniform(-np.pi, np.pi, 4)
            phase[i] = c[0] * X + c[1] * Y + c[2] * X * Y + c[3] * (X ** 2 - Y ** 2)
    return write_store(path, slices, phase, _split_counts(n_slices, splits[0], splits[1]))


def convert_volume(volume: np.ndarray, out_path: str, axis: int = 0,
                   domain: str = "density", **kw) -> str:
    """Slice a 3-D volume along ``axis`` into a store (the container by
    ``out_path``). ``domain="hu"`` marks CT Hounsfield data, converted to
    relative attenuation on read; ``train_frac`` / ``val_frac`` (0.8 / 0.1)
    set the splits. Other normalisation or windowing is the caller's."""
    if domain not in DOMAINS:
        raise ValueError(f"unknown slice domain {domain!r}")
    vol = np.moveaxis(np.asarray(volume, np.float32), axis, 0)
    counts = _split_counts(vol.shape[0], kw.get("train_frac", 0.8), kw.get("val_frac", 0.1))
    return write_store(out_path, vol, None, counts, domain)


def h5_to_npy(src: str, dst: str) -> str:
    """Copy the HDF5 store ``src`` (written by either package) into the npy
    directory ``dst``: the same slices, phase, splits and domain, bit for
    bit. Run it where h5py is; the npy store needs numpy only."""
    if _is_hdf5(dst):
        raise ValueError(f"h5_to_npy writes an npy directory; got {dst!r}")
    with _h5py().File(src, "r") as f:
        domain = f.attrs.get("domain")
        _write_npy(dst, f["slices"][()], f["phase"][()] if "phase" in f else None,
                   f.attrs["splits"], None if domain is None else str(domain))
    return dst


def iterate_batches(dataset: SliceDataset, batch_size: int, shuffle: bool = True,
                    seed: int = 0, drop_remainder: bool = True,
                    epochs: Optional[int] = None) -> Iterator[np.ndarray]:
    """Host batches of ``dataset``: a fresh permutation from
    ``np.random.default_rng(seed)`` per epoch (``shuffle``) or the stored
    order; endless unless ``epochs`` is given."""
    n = len(dataset)
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        stop = n - (n % batch_size) if drop_remainder else n
        for lo in range(0, stop, batch_size):
            yield dataset.batch(order[lo: lo + batch_size])
        epoch += 1
