"""PASCAL VOC dataset plumbing.

Counterpart of :mod:`ccnet_tpu.data.voc` (the reference's
``VOCDataSet``/``VOCDataTestSet``, ``dataset/datasets.py:12-118``):
``JPEGImages/<id>.jpg`` + ``SegmentationClassAug/<id>.png``, an id list
file, mean (128, 128, 128), scale range 0.5–1.6 in steps of 0.1, 21
classes. cv2 is imported only when a file is read.

VOC images vary in size, so training augments them on the host
(:func:`ccnet_tpu_torch.data.preprocess.host_augment`, which needs no cv2)
and evaluation pads them to a bucket.
"""

from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np

VOC_MEAN = (128.0, 128.0, 128.0)
VOC_SCALE_MIN, VOC_SCALE_STEPS = 0.5, 12  # 0.5 … 1.6

VOC_CLASS_NAMES = (
    "background", "aeroplane", "bicycle", "bird", "boat", "bottle", "bus",
    "car", "cat", "chair", "cow", "diningtable", "dog", "horse", "motorbike",
    "person", "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


class VOCDataset:
    """``(image (H, W, 3) BGR, label (H, W), id)`` of each id in ``list_path``:
    f32/int32, or uint8/uint8 with ``raw_dtype="uint8"``. ``max_iters``
    repeats the list to at least that many samples; ``with_labels=False``
    gives all-ignore labels (the test set)."""

    def __init__(self, root: str, list_path: str, max_iters: Optional[int] = None,
                 with_labels: bool = True, raw_dtype: str = "float32"):
        self.root = root
        self.with_labels = with_labels
        self.raw_dtype = raw_dtype
        ids = [line.strip() for line in open(list_path) if line.strip()]
        if max_iters is not None:
            ids = ids * int(np.ceil(max_iters / len(ids)))
        self.ids = ids

    def __len__(self):
        return len(self.ids)

    def name(self, index: int) -> str:
        return self.ids[index]

    def __getitem__(self, index: int):
        import cv2

        name = self.ids[index]
        image = cv2.imread(osp.join(self.root, f"JPEGImages/{name}.jpg"), cv2.IMREAD_COLOR)
        if image is None:
            raise IOError(f"failed to read VOC image {name}")
        if self.with_labels:
            label = cv2.imread(osp.join(self.root, f"SegmentationClassAug/{name}.png"),
                               cv2.IMREAD_GRAYSCALE)
            if label is None:
                raise IOError(f"failed to read VOC label {name}")
        else:
            label = np.full(image.shape[:2], 255, np.uint8)
        if self.raw_dtype == "uint8":
            return image, label, name
        return image.astype(np.float32), label.astype(np.int32), name
