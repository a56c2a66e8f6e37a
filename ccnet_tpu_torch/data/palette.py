"""Prediction PNG palettes and writers.

The reference writes palette-indexed PNGs for predictions
(``evaluate.py:71-93,253-256``) using the VOC bit-interleave colormap
generator: colour channel bit b of entry j is built from label bits
3k+channel, reversed into the high bits. Reproduced here from that
algorithm's definition.
"""

from __future__ import annotations

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
    """Flat [r,g,b,...] palette list for PIL, VOC colormap (reference parity)."""
    return voc_colormap(256).reshape(-1).tolist()


def save_indexed_png(path: str, pred: np.ndarray, palette: Sequence[int] | None = None):
    """Write a palette-indexed PNG of integer predictions."""
    from PIL import Image

    im = Image.fromarray(pred.astype(np.uint8), mode="P")
    im.putpalette(list(palette) if palette is not None else cityscapes_palette())
    im.save(path)
