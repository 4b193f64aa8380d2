"""8-bit greyscale PNG files with the standard library only (``zlib``,
``struct``, ``binascii.crc32``), for machines without PIL.

:func:`write_gray_png` writes one IHDR (colour type 0, bit depth 8, no
interlace), one IDAT of the rows each behind filter byte 0, and IEND;
decoders read the same pixels PIL would have written. :func:`read_gray_png`
reads such a file back (and any single-IDAT-stream greyscale PNG whose rows
use filter 0).
"""

from __future__ import annotations

import binascii
import struct
import zlib

import numpy as np

__all__ = ["write_gray_png", "read_gray_png"]

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", binascii.crc32(kind + data) & 0xFFFFFFFF))


def write_gray_png(path, pixels: np.ndarray) -> None:
    """Write the (H, W) uint8 array ``pixels`` as an 8-bit greyscale PNG."""
    a = np.ascontiguousarray(pixels)
    if a.ndim != 2 or a.dtype != np.uint8:
        raise ValueError(f"need an (H, W) uint8 array, got {a.shape} {a.dtype}")
    h, w = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a], axis=1)  # filter 0 per row
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        f.write(_chunk(b"IEND", b""))


def read_gray_png(path) -> np.ndarray:
    """The (H, W) uint8 pixels of an 8-bit greyscale PNG with filter-0 rows."""
    data = open(path, "rb").read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, shape = 8, b"", None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        if binascii.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            w, h, depth, colour = struct.unpack(">IIBB", body[:10])
            if (depth, colour) != (8, 0):
                raise ValueError(f"{path}: not 8-bit greyscale (depth {depth}, "
                                 f"colour type {colour})")
            shape = (h, w)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(shape[0], shape[1] + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: rows use a PNG filter other than 0")
    return rows[:, 1:].copy()
