"""Cityscapes dataset: file lists, labelId↔trainId maps, raw sample IO.

Capability parity with the reference's ``CSDataSet``/``CSDataTestSet``
(``dataset/datasets.py:121-288``): ``.lst`` file lists (relative
``image_path label_path`` pairs), the 34-entry labelId→trainId map
(``datasets.py:146-151``), ``max_iters`` replication, and the reverse
trainId→labelId map for test-server submission (``test.py:141-149``).
Also supports discovering the standard Cityscapes directory layout directly
(no ``.lst`` needed).

This module only does host IO and returns raw arrays. It is a copy of
:mod:`ccnet_tpu.data.cityscapes`, which is numpy-only itself but cannot be
imported without jax (``ccnet_tpu/data/__init__.py`` imports the device
augmenter).
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from typing import List, Optional, Tuple

import numpy as np

IGNORE_LABEL = 255

# labelId -> trainId (34 classes -> 19), reference datasets.py:146-151
CITYSCAPES_ID_TO_TRAINID = {
    -1: IGNORE_LABEL, 0: IGNORE_LABEL, 1: IGNORE_LABEL, 2: IGNORE_LABEL,
    3: IGNORE_LABEL, 4: IGNORE_LABEL, 5: IGNORE_LABEL, 6: IGNORE_LABEL,
    7: 0, 8: 1, 9: IGNORE_LABEL, 10: IGNORE_LABEL, 11: 2, 12: 3, 13: 4,
    14: IGNORE_LABEL, 15: IGNORE_LABEL, 16: IGNORE_LABEL, 17: 5,
    18: IGNORE_LABEL, 19: 6, 20: 7, 21: 8, 22: 9, 23: 10, 24: 11, 25: 12,
    26: 13, 27: 14, 28: 15, 29: IGNORE_LABEL, 30: IGNORE_LABEL,
    31: 16, 32: 17, 33: 18,
}

# trainId -> labelId for submission PNGs (reference test.py:178-183)
CITYSCAPES_TRAINID_TO_ID = {
    0: 7, 1: 8, 2: 11, 3: 12, 4: 13, 5: 17, 6: 19, 7: 20, 8: 21, 9: 22,
    10: 23, 11: 24, 12: 25, 13: 26, 14: 27, 15: 28, 16: 31, 17: 32, 18: 33,
}

CITYSCAPES_CLASS_NAMES = (
    "road", "sidewalk", "building", "wall", "fence", "pole", "traffic light",
    "traffic sign", "vegetation", "terrain", "sky", "person", "rider", "car",
    "truck", "bus", "train", "motorcycle", "bicycle",
)


def trainid_lut() -> np.ndarray:
    """256-entry uint8 LUT mapping raw labelId PNG values to trainIds."""
    lut = np.full(256, IGNORE_LABEL, np.uint8)
    for k, v in CITYSCAPES_ID_TO_TRAINID.items():
        if k >= 0:
            lut[k] = v
    return lut


def trainid_to_labelid(pred: np.ndarray) -> np.ndarray:
    """Map trainId predictions back to labelIds for server submission."""
    lut = np.zeros(256, np.uint8)
    for t, l in CITYSCAPES_TRAINID_TO_ID.items():
        lut[t] = l
    return lut[pred.astype(np.uint8)]


class CityscapesDataset:
    """Host-side Cityscapes sample reader (images BGR f32, labels trainId).

    Args:
      root: dataset root.
      list_path: optional ``.lst`` with ``image_path [label_path]`` lines
        (relative to root). If None, the standard layout
        ``leftImg8bit/<split>/*/*_leftImg8bit.png`` +
        ``gtFine/<split>/*/*_gtFine_labelIds.png`` is discovered.
      split: train | val | test (used only for discovery).
      max_iters: replicate the id list to cover this many samples
        (reference ``datasets.py:132-133``).
      raw_dtype: 'float32' (reference semantics) or 'uint8' — uint8 keeps the
        decoded sample in its native byte layout so the host→device transfer
        is 4× smaller; the device augmenter widens on chip (exact: raw pixels
        are integers).
    """

    def __init__(
        self,
        root: str,
        list_path: Optional[str] = None,
        split: str = "train",
        max_iters: Optional[int] = None,
        raw_dtype: str = "float32",
    ):
        self.root = root
        self.raw_dtype = raw_dtype
        self.lut = trainid_lut()
        items: List[Tuple[str, Optional[str]]] = []
        if list_path:
            for line in open(list_path):
                parts = line.strip().split()
                if not parts:
                    continue
                img = osp.join(root, parts[0])
                lbl = osp.join(root, parts[1]) if len(parts) > 1 else None
                items.append((img, lbl))
        else:
            pattern = osp.join(root, "leftImg8bit", split, "*", "*_leftImg8bit.png")
            for img in sorted(glob.glob(pattern)):
                lbl = img.replace(osp.sep + "leftImg8bit" + osp.sep,
                                  osp.sep + "gtFine" + osp.sep)
                lbl = lbl.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                items.append((img, lbl if osp.exists(lbl) else None))
        if not items:
            raise FileNotFoundError(f"no Cityscapes samples under {root} (list={list_path})")
        if max_iters is not None:
            reps = int(np.ceil(max_iters / len(items)))
            items = items * reps
        self.items = items

    def __len__(self):
        return len(self.items)

    def name(self, index: int) -> str:
        img, lbl = self.items[index]
        base = osp.splitext(osp.basename(lbl if lbl else img))[0]
        return base

    def __getitem__(self, index: int):
        import cv2

        img_path, lbl_path = self.items[index]
        image = cv2.imread(img_path, cv2.IMREAD_COLOR)  # BGR, matches reference
        if image is None:
            raise IOError(f"failed to read {img_path}")
        if lbl_path is None:
            label = np.full(image.shape[:2], IGNORE_LABEL, np.uint8)
        else:
            raw = cv2.imread(lbl_path, cv2.IMREAD_GRAYSCALE)
            if raw is None:
                raise IOError(f"failed to read {lbl_path}")
            label = self.lut[raw]
        if self.raw_dtype == "uint8":
            return image, label, self.name(index)
        return image.astype(np.float32), label.astype(np.int32), self.name(index)
