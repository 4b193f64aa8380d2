"""The port's CUDA sources and the ctypes bindings that call them.

Every C entry point a wrapper binds (``cuda_kernels._ARGTYPES`` and
``proto_kernels._ARGTYPES``) is an ``extern "C"`` function of the library
the binding loads, ``csrc/<name without its last _part>.cu``, which is one
of ``_build.SOURCES``, with the declared pointer, int and float parameters
in the same order; and ``_build.SOURCES`` are exactly the ``csrc/*.cu``
files. No card is needed: the sources are read as text.
"""

import re

import pytest

from pdunet_tpu_torch.ops.radon import _build, cuda_kernels, proto_kernels

CSRC = _build._CSRC
_ENTRY = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
_BINDINGS = {**cuda_kernels._ARGTYPES, **proto_kernels._ARGTYPES}
_KIND = {cuda_kernels._P: "p", cuda_kernels._I: "i", cuda_kernels._F: "f"}


def _entry_points(source):
    """{entry point: its (pointer, int, float) parameter kinds} of
    ``csrc/<source>.cu``."""
    out = {}
    for name, params in _ENTRY.findall((CSRC / f"{source}.cu").read_text()):
        out[name] = ["p" if "*" in prm else ("f" if prm.strip().startswith("float") else "i")
                     for prm in params.split(",")]
    return out


def test_sources_are_the_csrc_files():
    assert sorted(_build.SOURCES) == sorted(p.stem for p in CSRC.glob("*.cu"))
    assert len(set(_build.SOURCES)) == len(_build.SOURCES)


@pytest.mark.parametrize("name", sorted(_BINDINGS))
def test_binding_names_an_entry_point_of_a_built_source(name):
    source = name.rsplit("_", 1)[0]  # the library _fn loads for it
    assert source in _build.SOURCES
    entries = _entry_points(source)
    assert name in entries, f"no extern \"C\" {name} in csrc/{source}.cu"
    assert [_KIND[t] for t in _BINDINGS[name]] == entries[name]
