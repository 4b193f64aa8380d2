"""The port's data modules (pdunet_tpu_torch/data/{datasets,phantoms,native}.py)
against the JAX package's, at small sizes.

Stores written by the JAX package (HDF5) read back through the port's
SliceDataset bit for bit, and carried into the npy container by h5_to_npy
bit for bit. The port's own writer matches the JAX writer bit for bit when
both rasterise natively (the same C++ source and flags), else to 1e-5 (the
native rasteriser against the numpy one, tests/test_native.py's tolerance).
Phantoms are numpy on both sides: bit-equal for the same generator.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from pdunet_tpu.data import datasets as jax_datasets
from pdunet_tpu.data import native as jax_native
from pdunet_tpu.data import phantoms as jax_phantoms
from pdunet_tpu_torch.data import datasets, native, phantoms
from pdunet_tpu_torch.ops.radon._build import BUILD_DIR

torch.set_num_threads(1)

N = 32


@pytest.fixture(scope="module")
def jax_stores(tmp_path_factory):
    """HDF5 stores written by the JAX package: real, complex and HU."""
    d = tmp_path_factory.mktemp("jax")
    real = jax_datasets.write_phantom_dataset(str(d / "real.h5"), 20, N, seed=1)
    cplx = jax_datasets.write_phantom_dataset(str(d / "cplx.h5"), 10, N, seed=2,
                                              complex_phase=True)
    hu = np.random.default_rng(3).uniform(-1000, 1000, (9, N, N)).astype(np.float32)
    hu_path = jax_datasets.convert_volume(hu, str(d / "hu.h5"), domain="hu",
                                          train_frac=0.6, val_frac=0.2)
    return {"real": real, "cplx": cplx, "hu": hu_path}


def _same_store(a_path, b_path, reader_a=datasets.SliceDataset,
                reader_b=datasets.SliceDataset):
    for split in ("train", "val", "test"):
        a, b = reader_a(a_path, split=split), reader_b(b_path, split=split)
        assert len(a) == len(b) and a.image_size == b.image_size
        assert a.is_complex == b.is_complex and a.domain == b.domain
        for i in range(len(a)):
            x, y = a[i], b[i]
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        a.close()
        b.close()


@pytest.mark.parametrize("kind", ["real", "cplx", "hu"])
def test_port_reads_jax_hdf5_bit_for_bit(jax_stores, kind):
    _same_store(jax_stores[kind], jax_stores[kind], reader_b=jax_datasets.SliceDataset)


@pytest.mark.parametrize("kind", ["real", "cplx", "hu"])
def test_h5_to_npy_round_trips_exactly(jax_stores, kind, tmp_path):
    dst = datasets.h5_to_npy(jax_stores[kind], str(tmp_path / kind))
    assert sorted(os.listdir(dst)) == sorted(
        ["attrs.json", "slices.npy"] + (["phase.npy"] if kind == "cplx" else []))
    _same_store(dst, jax_stores[kind], reader_b=jax_datasets.SliceDataset)
    attrs = json.loads((tmp_path / kind / "attrs.json").read_text())
    assert attrs.get("domain", "density") == ("hu" if kind == "hu" else "density")


def test_splits_keep_the_reference_rounding(jax_stores, tmp_path):
    for n, fr in ((20, (0.8, 0.1, 0.1)), (7, (0.7, 0.15, 0.15)), (13, (0.5, 0.25, 0.25))):
        datasets.write_phantom_dataset(str(tmp_path / f"s{n}"), n, 8, splits=fr, n_ellipses=2)
        jax_datasets.write_phantom_dataset(str(tmp_path / f"s{n}.h5"), n, 8, splits=fr,
                                           n_ellipses=2)
        got = [len(datasets.SliceDataset(str(tmp_path / f"s{n}"), s)) for s in datasets.SPLITS]
        want = [len(jax_datasets.SliceDataset(str(tmp_path / f"s{n}.h5"), s))
                for s in datasets.SPLITS]
        assert got == want and sum(got) == n


@pytest.mark.parametrize("container", ["npy", "h5"])
@pytest.mark.parametrize("complex_phase", [False, True], ids=["real", "cplx"])
def test_port_writer_matches_jax_writer(tmp_path, container, complex_phase):
    ours = str(tmp_path / ("ours.h5" if container == "h5" else "ours"))
    datasets.write_phantom_dataset(ours, 10, N, seed=4, complex_phase=complex_phase)
    ref = jax_datasets.write_phantom_dataset(str(tmp_path / "ref.h5"), 10, N, seed=4,
                                             complex_phase=complex_phase)
    if native.available() and jax_native.available():
        _same_store(ours, ref, reader_b=jax_datasets.SliceDataset)
    else:  # one side rasterised in numpy
        for split in ("train", "val", "test"):
            a = datasets.SliceDataset(ours, split)
            b = jax_datasets.SliceDataset(ref, split)
            np.testing.assert_allclose(a.batch(range(len(a))), b.batch(range(len(b))),
                                       atol=1e-5)


def test_convert_volume_axis_and_hu(tmp_path):
    vol = np.random.default_rng(5).uniform(-1000, 400, (N, 6, N)).astype(np.float32)
    ours = datasets.convert_volume(vol, str(tmp_path / "v"), axis=1, domain="hu",
                                   train_frac=0.5, val_frac=0.5)
    ref = jax_datasets.convert_volume(vol, str(tmp_path / "v.h5"), axis=1, domain="hu",
                                      train_frac=0.5, val_frac=0.5)
    _same_store(ours, ref, reader_b=jax_datasets.SliceDataset)
    ds = datasets.SliceDataset(ours, "train")
    np.testing.assert_array_equal(ds[0], 1.0 + vol[:, 0] / 1000.0)
    # water → 1, air → 0
    flat = np.stack([np.full((4, 4), v, np.float32) for v in (-1000, 0, 400)])
    ds = datasets.SliceDataset(datasets.convert_volume(flat, str(tmp_path / "f"), domain="hu",
                                                       train_frac=1.0, val_frac=0.0))
    np.testing.assert_allclose(ds.batch([0, 1, 2])[:, 0, 0], [0.0, 1.0, 1.4], atol=1e-6)


@pytest.mark.parametrize("shuffle,epochs,drop", [(True, 2, True), (False, 1, True),
                                                 (True, 1, False)],
                         ids=["shuffled", "ordered", "remainder"])
def test_iterate_batches_gives_the_jax_order(jax_stores, tmp_path, shuffle, epochs, drop):
    npy = datasets.h5_to_npy(jax_stores["real"], str(tmp_path / "r"))
    ours = datasets.iterate_batches(datasets.SliceDataset(npy), 3, shuffle=shuffle, seed=11,
                                    drop_remainder=drop, epochs=epochs)
    ref = jax_datasets.iterate_batches(jax_datasets.SliceDataset(jax_stores["real"]), 3,
                                       shuffle=shuffle, seed=11, drop_remainder=drop,
                                       epochs=epochs)
    ours, ref = list(ours), list(ref)
    assert len(ours) == len(ref) > 0
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", phantoms.OOD_KINDS)
@pytest.mark.parametrize("nonneg", [False, True], ids=["signed", "nonneg"])
def test_ood_phantoms_match_jax(kind, nonneg):
    assert phantoms.OOD_KINDS == jax_phantoms.OOD_KINDS
    for seed in (0, 1):
        a = phantoms.ood_phantom(kind, np.random.default_rng(seed), N, nonneg=nonneg)
        b = jax_phantoms.ood_phantom(kind, np.random.default_rng(seed), N, nonneg=nonneg)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="unknown OOD kind"):
        phantoms.ood_phantom("spirals", np.random.default_rng(0), N)


def test_ellipse_phantoms_match_jax():
    np.testing.assert_array_equal(phantoms.shepp_logan_ellipses(14.4),
                                  jax_phantoms.shepp_logan_ellipses(14.4))
    ell = phantoms.random_ellipses(np.random.default_rng(6), 5, 14.4)
    np.testing.assert_array_equal(
        ell, jax_phantoms.random_ellipses(np.random.default_rng(6), 5, 14.4))
    np.testing.assert_array_equal(phantoms.rasterize_ellipses(ell, N, supersample=2),
                                  jax_phantoms.rasterize_ellipses(ell, N, supersample=2))
    angles = np.linspace(0, np.pi, 12, endpoint=False)
    np.testing.assert_array_equal(phantoms.analytic_parallel_sinogram(ell, angles, 40),
                                  jax_phantoms.analytic_parallel_sinogram(ell, angles, 40))


needs_native = pytest.mark.skipif(not native.available(),
                                  reason="native library did not build (no C++ compiler)")


@needs_native
def test_native_builds_into_the_port_build_directory():
    lib = native.library_path()
    assert lib.parent == BUILD_DIR and lib.exists()
    assert lib.name.startswith("libpdunet_native-")


@needs_native
def test_native_matches_the_numpy_path():
    ell = phantoms.random_ellipses(np.random.default_rng(7), 6, 28.0)
    np.testing.assert_allclose(native.rasterize_ellipses(ell, 64, supersample=4),
                               phantoms.rasterize_ellipses(ell, 64, supersample=4), atol=1e-5)
    angles = np.linspace(0, np.pi, 37, endpoint=False)
    np.testing.assert_allclose(native.analytic_parallel_sinogram(ell, angles, 64),
                               phantoms.analytic_parallel_sinogram(ell, angles, 64),
                               atol=1e-4, rtol=1e-5)
    a = native.phantom_batch(seed=7, batch=3, image_size=N)
    assert a.shape == (3, N, N) and np.isfinite(a).all() and a.std() > 0
    np.testing.assert_array_equal(a, native.phantom_batch(seed=7, batch=3, image_size=N))
    assert not np.array_equal(a, native.phantom_batch(seed=8, batch=3, image_size=N))
    if jax_native.available():  # the same source and flags: the same bits
        np.testing.assert_array_equal(native.rasterize_ellipses(ell, 64),
                                      jax_native.rasterize_ellipses(ell, 64))
        np.testing.assert_array_equal(a, jax_native.phantom_batch(seed=7, batch=3,
                                                                  image_size=N))


def test_prefetcher_keeps_order_and_surfaces_errors():
    pf = native.HostPrefetcher(lambda i: i * i, depth=2)
    assert [next(pf) for _ in range(5)] == [0, 1, 4, 9, 16]
    pf.close()

    def make(i):
        if i == 1:
            raise ValueError("boom at 1")
        return i

    pf = native.HostPrefetcher(make, depth=2)
    assert next(pf) == 0
    with pytest.raises(RuntimeError, match="producer failed"):
        next(pf)
    pf.close()


def test_index_and_value_errors(jax_stores, tmp_path):
    npy = datasets.h5_to_npy(jax_stores["real"], str(tmp_path / "r"))
    for path in (npy, jax_stores["real"]):
        ds = datasets.SliceDataset(path, split="val")
        with pytest.raises(IndexError):
            ds[len(ds)]
        with pytest.raises(IndexError):
            ds[-1]
        with pytest.raises(ValueError, match="split must be one of"):
            datasets.SliceDataset(path, split="holdout")
    vol = np.zeros((3, 4, 4), np.float32)
    for out in (str(tmp_path / "bad"), str(tmp_path / "bad.h5")):
        with pytest.raises(ValueError, match="unknown slice domain"):
            datasets.convert_volume(vol, out, domain="parsecs")
    bad = tmp_path / "baddomain"
    datasets.convert_volume(vol, str(bad))
    (bad / "attrs.json").write_text(json.dumps({"splits": [3, 0, 0], "domain": "parsecs"}))
    with pytest.raises(ValueError, match="unknown slice domain"):
        datasets.SliceDataset(str(bad))
    with pytest.raises(ValueError, match="npy directory"):
        datasets.h5_to_npy(jax_stores["real"], str(tmp_path / "again.h5"))


def test_missing_h5py_is_a_clear_error(monkeypatch, tmp_path):
    """Without h5py an .h5 store names the way out; the npy container needs
    numpy only."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5_to_npy"):
        datasets.SliceDataset(str(tmp_path / "x.h5"))
    path = datasets.write_phantom_dataset(str(tmp_path / "plain"), 4, 8, n_ellipses=2)
    assert len(datasets.SliceDataset(path, "train")) == 3
