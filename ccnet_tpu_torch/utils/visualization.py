"""Label/prediction visualization.

A copy of :mod:`ccnet_tpu.utils.visualization` (the reference's
``utils/pyt_utils.py:141-217`` ``decode_labels`` / ``decode_predictions`` /
``inv_preprocess``, as a vectorised colour lookup), numpy only.
"""

from __future__ import annotations

import numpy as np

from ccnet_tpu_torch.data.palette import voc_colormap
from ccnet_tpu_torch.data.preprocess import CITYSCAPES_MEAN_BGR


def decode_labels(labels: np.ndarray, num_classes: int = 19,
                  ignore_label: int = 255) -> np.ndarray:
    """(B, H, W) int labels → (B, H, W, 3) uint8 RGB color images."""
    cmap = voc_colormap(256)
    cmap[ignore_label] = 0
    return cmap[np.clip(labels, 0, 255).astype(np.int32)]


def decode_predictions(logits: np.ndarray, num_classes: int = 19) -> np.ndarray:
    """(B, H, W, C) logits → color images of the argmax prediction."""
    return decode_labels(np.argmax(logits, axis=-1), num_classes)


def inv_preprocess(images: np.ndarray, mean=CITYSCAPES_MEAN_BGR) -> np.ndarray:
    """Undo preprocessing for display: add mean back, BGR→RGB, uint8.

    images: (B, H, W, 3) mean-subtracted BGR floats.
    """
    x = images + np.asarray(mean, np.float32)
    x = x[..., ::-1]  # BGR -> RGB
    return np.clip(x, 0, 255).astype(np.uint8)
