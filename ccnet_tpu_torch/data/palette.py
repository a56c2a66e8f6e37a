"""Prediction PNG palettes and writers.

The reference writes palette-indexed PNGs for predictions
(``evaluate.py:71-93,253-256``) using the VOC bit-interleave colormap
generator: colour channel bit b of entry j is built from label bits
3k+channel, reversed into the high bits. Reproduced here from that
algorithm's definition.
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


def save_indexed_png(path: str, pred: np.ndarray, palette: Sequence[int] | None = None):
    """Write a palette-indexed PNG of integer predictions.

    The standard library only (the card's machine has no PIL): 8-bit colour
    type 3, a PLTE chunk of the flat ``[r, g, b, ...]`` palette (the VOC
    colormap by default) and one IDAT of filter-0 scanlines. PIL reads it
    back with the same pixels and palette as its own ``mode="P"`` save."""
    pred = np.asarray(pred).astype(np.uint8)
    if pred.ndim != 2:
        raise ValueError(f"a prediction map is (H, W); got shape {pred.shape}")
    pal = np.asarray(list(palette) if palette is not None else cityscapes_palette(), np.uint8)
    if pal.size % 3 or not 3 <= pal.size <= 768:
        raise ValueError(f"palette must hold 1 to 256 rgb triples; got {pal.size} values")
    h, w = pred.shape
    scanlines = np.zeros((h, w + 1), np.uint8)  # column 0: filter type 0 (None)
    scanlines[:, 1:] = pred
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 3, 0, 0, 0))
           + _png_chunk(b"PLTE", pal.tobytes())
           + _png_chunk(b"IDAT", zlib.compress(scanlines.tobytes(), 6))
           + _png_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)
