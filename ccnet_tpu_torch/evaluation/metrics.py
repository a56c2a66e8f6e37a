"""Segmentation metrics: confusion matrix and IoU.

Counterpart of :mod:`ccnet_tpu.evaluation.metrics`: the reference's bincount
trick (``evaluate.py:177-195``) on the device, and the IoU formula
``tp / (pos + res − tp)`` with the mean over classes present in the ground
truth. Over N ranks each rank accumulates the confusion of its own images
and :func:`cross_process_sum` adds the ranks' matrices once, at the end.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ccnet_tpu_torch.parallel.mesh import all_reduce_sum


def confusion_matrix(labels: torch.Tensor, preds: torch.Tensor, num_classes: int,
                     ignore_label: int = 255) -> torch.Tensor:
    """(C, C) int64 confusion matrix [gt, pred] over non-ignored pixels."""
    # int64 BEFORE the index arithmetic: uint8 labels would overflow
    # labels * num_classes + preds
    labels = labels.reshape(-1).to(torch.int64)
    preds = preds.reshape(-1).to(torch.int64)
    n2 = num_classes * num_classes
    idx = torch.where(labels != ignore_label, labels * num_classes + preds,
                      torch.full_like(labels, n2))
    # indices past n2 (a label >= num_classes) are dropped, as jnp.bincount's length drops them
    return torch.bincount(idx, minlength=n2 + 1)[:n2].reshape(num_classes, num_classes)


def iou_from_confusion(cm) -> Tuple[np.ndarray, float]:
    """Per-class IoU and mean IoU from a confusion matrix [gt, pred]."""
    cm = np.asarray(cm, np.float64)
    pos = cm.sum(1)
    res = cm.sum(0)
    tp = np.diag(cm)
    denom = np.maximum(pos + res - tp, 1.0)
    iu = tp / denom
    present = pos > 0
    mean_iu = float(iu[present].mean()) if present.any() else 0.0
    return iu, mean_iu


def cross_process_sum(cm: torch.Tensor) -> torch.Tensor:
    """The (C, C) int64 confusion ``cm`` summed over the ranks of the live
    group: one ``all_reduce``, which every rank must call; ``cm`` itself in
    a single process. The counterpart of the JAX package's
    ``cross_process_sum`` and the reference's one NCCL all-reduce of the
    evaluation's confusion matrix."""
    return all_reduce_sum(cm, "confusion")


class ConfusionAccumulator:
    """Accumulates a confusion matrix across batches on ``device``."""

    def __init__(self, num_classes: int, ignore_label: int = 255,
                 device: torch.device | str = "cpu"):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.cm = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)

    def update(self, labels: torch.Tensor, preds: torch.Tensor) -> None:
        self.cm += confusion_matrix(labels, preds, self.num_classes, self.ignore_label)

    def matrix(self) -> np.ndarray:
        return self.cm.cpu().numpy()

    def result(self) -> Tuple[np.ndarray, float]:
        return iou_from_confusion(self.matrix())
