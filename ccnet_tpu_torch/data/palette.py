"""Prediction PNG palettes and writers.

The reference writes palette-indexed PNGs for predictions
(``evaluate.py:71-93,253-256``) using the VOC bit-interleave colormap
generator: colour channel bit b of entry j is built from label bits
3k+channel, reversed into the high bits. Reproduced here from that
algorithm's definition. :func:`save_grey_png` writes the 8-bit greyscale
labelId PNGs of test-server submissions. Both use the standard library
only, as does :func:`read_png`, which reads their files back.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np


def voc_colormap(n: int = 256) -> np.ndarray:
    """(n, 3) uint8 VOC bit-interleave colormap."""
    cmap = np.zeros((n, 3), np.uint8)
    for j in range(n):
        lab = j
        r = g = b = 0
        for i in range(8):
            r |= ((lab >> 0) & 1) << (7 - i)
            g |= ((lab >> 1) & 1) << (7 - i)
            b |= ((lab >> 2) & 1) << (7 - i)
            lab >>= 3
        cmap[j] = (r, g, b)
    return cmap


def cityscapes_palette(num_classes: int = 19) -> list:
    """Flat [r,g,b,...] palette list, VOC colormap (reference parity)."""
    return voc_colormap(256).reshape(-1).tolist()


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _png(path: str, pred: np.ndarray, colour_type: int, plte: bytes | None = None) -> None:
    """One 8-bit PNG of ``colour_type``: IHDR, PLTE if given, one IDAT of
    filter-0 scanlines, IEND."""
    h, w = pred.shape
    scanlines = np.zeros((h, w + 1), np.uint8)  # column 0: filter type 0 (None)
    scanlines[:, 1:] = pred
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour_type, 0, 0, 0))
           + (_png_chunk(b"PLTE", plte) if plte is not None else b"")
           + _png_chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _as_map(pred) -> np.ndarray:
    pred = np.asarray(pred).astype(np.uint8)
    if pred.ndim != 2:
        raise ValueError(f"a prediction map is (H, W); got shape {pred.shape}")
    return pred


def save_grey_png(path: str, pred: np.ndarray) -> None:
    """Write an (H, W) map of values 0–255 as an 8-bit greyscale PNG (colour
    type 0), as PIL's ``Image.fromarray(uint8 map).save`` does: PIL reads it
    back as mode ``L`` with the same values."""
    _png(path, _as_map(pred), 0)


def save_indexed_png(path: str, pred: np.ndarray, palette: Sequence[int] | None = None):
    """Write a palette-indexed PNG of integer predictions.

    The standard library only (the card's machine has no PIL): 8-bit colour
    type 3, a PLTE chunk of the flat ``[r, g, b, ...]`` palette (the VOC
    colormap by default) and one IDAT of filter-0 scanlines. PIL reads it
    back with the same pixels and palette as its own ``mode="P"`` save."""
    pred = _as_map(pred)
    pal = np.asarray(list(palette) if palette is not None else cityscapes_palette(), np.uint8)
    if pal.size % 3 or not 3 <= pal.size <= 768:
        raise ValueError(f"palette must hold 1 to 256 rgb triples; got {pal.size} values")
    _png(path, pred, 3, pal.tobytes())


def read_png(path: str, colour_type: int) -> tuple:
    """``(pixels, palette)`` of a PNG that :func:`save_grey_png`
    (``colour_type`` 0) or :func:`save_indexed_png` (3) wrote: the (H, W)
    uint8 values or palette indices and the flat uint8 ``[r, g, b, ...]``
    palette (empty for 0). 8 bits, filter-0 scanlines, a PLTE chunk exactly
    when the colour type is 3; raises ``ValueError`` on any other PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    chunks, pos = {}, 8
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, ctype) != (8, colour_type) or (b"PLTE" in chunks) != (colour_type == 3):
        raise ValueError(f"{path}: depth {depth}, colour type {ctype}, PLTE "
                         f"{len(chunks.get(b'PLTE', b''))} bytes; expected 8-bit colour type "
                         f"{colour_type}")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, w + 1)
    if (rows[:, 0] != 0).any():
        raise ValueError(f"{path}: a scanline filter other than 0")
    return rows[:, 1:].copy(), np.frombuffer(chunks.get(b"PLTE", b""), np.uint8).copy()
