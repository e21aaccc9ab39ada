"""8-bit PNG files with the standard library alone.

The render and preprocess subcommands write their images with `write_png`
(8-bit RGB or RGBA, or greyscale from a 2-D array), so that they need no
image package. `read_png` reads palette-free 8-bit PNGs without interlace:
greyscale, greyscale + alpha, RGB and RGBA, with any of the five row
filters, which is what `write_png` and the common image libraries write.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}     # colour type → samples a pixel


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path: str, image) -> None:
    """Write an (H, W, 3) or (H, W, 4) uint8 array as an RGB or RGBA PNG,
    or an (H, W) one as a greyscale PNG."""
    img = np.ascontiguousarray(image)
    grey = img.ndim == 2
    if img.dtype != np.uint8 or not (grey or (img.ndim == 3
                                             and img.shape[2] in (3, 4))):
        raise ValueError(f"write_png takes (H, W, 3), (H, W, 4) or (H, W) "
                         f"uint8, got {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    c = 1 if grey else img.shape[2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),      # filter 0
                           img.reshape(h, w * c)], axis=1)
    with open(path, "wb") as f:
        f.write(_SIGNATURE
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                              {1: 0, 3: 2, 4: 6}[c], 0, 0,
                                              0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of the PNG spec → (h, stride) uint8."""
    rows = raw.reshape(h, 1 + stride)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        kind, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 2:
            cur = (line + prev) & 0xFF
        elif kind == 1:
            # Sub: a running sum over each of the bpp interleaved lanes
            pad = (-stride) % bpp
            lanes = np.pad(line, (0, pad)).reshape(-1, bpp)
            cur = (np.cumsum(lanes, axis=0) & 0xFF).reshape(-1)[:stride]
        elif kind in (3, 4):
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG row filter {kind}")
        out[y] = cur
        prev = cur
    return out


def read_png(path: str) -> np.ndarray:
    """Read an 8-bit palette-free PNG → (H, W) uint8 for greyscale, (H, W,
    C) uint8 otherwise (C = 2, 3 or 4). Raises ValueError, naming the file,
    on any other kind."""
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
    if (header is None or header[2] != 8 or header[3] not in _CHANNELS
            or header[4:] != (0, 0, 0)):
        raise ValueError(f"{path}: not an 8-bit palette-free PNG without "
                         "interlace")
    w, h, c = header[0], header[1], _CHANNELS[header[3]]
    px = _unfilter(np.frombuffer(zlib.decompress(data), np.uint8), h, w * c,
                   c)
    return px.reshape(h, w) if c == 1 else px.reshape(h, w, c)
