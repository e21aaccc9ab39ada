"""8-bit RGB PNG files with the standard library alone.

The render subcommand writes its frames with `write_png`, so that it needs
no image package; `read_png` reads back what `write_png` wrote (8-bit RGB,
no interlace, filter 0 on every row) for checks of those files.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image) -> None:
    """Write an (H, W, 3) uint8 array as an RGB PNG."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3) uint8, got "
                         f"{img.shape} {img.dtype}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),      # filter 0
                           img.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def read_png(path: str) -> np.ndarray:
    """Read a PNG that `write_png` wrote → (H, W, 3) uint8. Raises
    ValueError on any other kind of PNG."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, data = 8, None, b""
    while pos < len(blob):
        n = struct.unpack(">I", blob[pos:pos + 4])[0]
        kind = blob[pos + 4:pos + 8]
        body = blob[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", blob[pos + 8 + n:pos + 12 + n])
        if crc != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad checksum in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            data += body
        pos += 12 + n
    if header is None or header[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit RGB PNG without interlace")
    w, h = header[:2]
    rows = np.frombuffer(zlib.decompress(data), np.uint8).reshape(
        h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not supported")
    return rows[:, 1:].reshape(h, w, 3).copy()
