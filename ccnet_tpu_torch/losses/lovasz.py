"""Lovász losses (Jaccard surrogates) and the IoU metrics, in plain torch.

Counterpart of :mod:`ccnet_tpu.losses.lovasz` (Berman et al., CVPR 2018;
reference ``loss/lovasz_losses.py``): sort the pixel errors in descending
order and take their dot product with the gradient of the Lovász extension,
``g_i = J(i) − J(i−1)``, where ``J(i) = 1 − intersection_i / union_i`` over
the first ``i`` sorted pixels.

* :func:`lovasz_softmax` — multi-class, over the classes present in the
  labels (``'present'``, the only mode the JAX package has), ``per_image``,
  an ignore label; probabilities NCHW ``(B, C, H, W)`` as the port's other
  losses take them.
* :func:`lovasz_hinge`, :func:`lovasz_hinge_flat`,
  :func:`flatten_binary_scores` — the binary family; :func:`binary_xloss`,
  the stable binary cross-entropy; :func:`iou_binary`, :func:`iou` — the
  metrics (numpy).

Where the JAX package keeps static shapes by folding ignored pixels in as
sentinel errors that sort to the tail, the port gathers the valid pixels
first. The results are the same: only the prefix statistics of errors
ahead of the tail enter the loss, and the sentinels contribute nothing.
:func:`flatten_binary_scores` keeps the JAX surface (scores, labels and a
validity mask). Everything is differentiable in the scores through
``torch.sort``'s values.

Over N ranks (a live process group, every rank holding an equal share of
the global batch, in rank order) each function returns this rank's share
of the loss of the global batch, as the JAX functions sort the global
batch's pixels under the mesh; the shares sum to the one-process loss and
each rank's gradient is its rows of the global gradient (the train step
back-propagates N × the share, which DDP averages). The sorted losses
gather every rank's errors and ground truth in rank order (one
``all_reduce`` of zero-filled slots, :func:`~ccnet_tpu_torch.parallel.mesh.
rank_gather`, with ignored pixels folded in as the JAX package folds them),
sort them stably on every rank, and dot this rank's own errors with the
global Lovász gradient at their sorted positions; ``'present'`` means
present in the global batch. ``per_image=True`` needs no gather: this
rank's images' losses over the global image count. :func:`binary_xloss`
is a mean and returns this rank's share of the global one.
"""

from __future__ import annotations

import numpy as np
import torch

from ccnet_tpu_torch.parallel.distributed import world
from ccnet_tpu_torch.parallel.mesh import all_reduce_sum, rank_gather


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension along dim 0 of errors sorted in
    descending order, given their ground truth in that order."""
    gts = gt_sorted.sum(dim=0)
    intersection = gts - gt_sorted.cumsum(dim=0)
    union = gts + (1.0 - gt_sorted).cumsum(dim=0)
    jaccard = 1.0 - intersection / union.clamp_min(1.0)
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]], dim=0)


def _global_grad(errors: torch.Tensor, gt: torch.Tensor):
    """Over N ranks: the Lovász gradient of the global batch at this rank's
    pixels, along dim 0 of this rank's ``errors`` (their ground truth
    ``gt``), and the global ground truth. Every rank's errors and ground
    truth are gathered in rank order and sorted stably in descending
    order."""
    rank, n = world()[0], errors.shape[0]
    both = rank_gather(torch.cat([errors, gt], dim=1))
    k = errors.shape[1]
    order = both[:, :k].sort(dim=0, descending=True, stable=True).indices
    grad = torch.empty_like(order, dtype=errors.dtype).scatter_(
        0, order, _lovasz_grad(both[:, k:].gather(0, order)))
    return grad[rank * n:(rank + 1) * n], both[:, k:]


def _lovasz_softmax_ranks(probas: torch.Tensor, labels: torch.Tensor,
                          ignore_label: int) -> torch.Tensor:
    """This rank's share of the Lovász-softmax of the global batch over N
    ranks; ignored pixels have error 0 and no class, as in the JAX
    package, and sort behind every error that counts."""
    C = probas.shape[1]
    flat = probas.permute(0, 2, 3, 1).reshape(-1, C)
    labels = labels.reshape(-1)
    valid = (labels != ignore_label)[:, None]
    fg = ((labels[:, None] == torch.arange(C, device=labels.device)) & valid).to(flat.dtype)
    errors = (fg - flat).abs() * valid
    grad, fg_all = _global_grad(errors, fg)
    present = (fg_all.sum(dim=0) > 0).to(flat.dtype)
    return ((errors * grad).sum(dim=0) * present).sum() / present.sum().clamp_min(1.0)


def _lovasz_softmax_flat(probas: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """probas ``(P, C)``, labels ``(P,)`` of the valid pixels: the mean over
    present classes (0 when none is present)."""
    C = probas.shape[1]
    fg = (labels[:, None] == torch.arange(C, device=labels.device)).to(probas.dtype)
    errors_sorted, order = (fg - probas).abs().sort(dim=0, descending=True)
    losses = (errors_sorted * _lovasz_grad(fg.gather(0, order))).sum(dim=0)
    present = (fg.sum(dim=0) > 0).to(probas.dtype)
    return (losses * present).sum() / present.sum().clamp_min(1.0)


def _valid_pixels(probas: torch.Tensor, labels: torch.Tensor, ignore_label: int):
    """NCHW probas and (B, H, W) labels → ``(P, C)``, ``(P,)`` of the unignored pixels."""
    keep = (labels != ignore_label).reshape(-1)
    flat = probas.permute(0, 2, 3, 1).reshape(-1, probas.shape[1])
    return flat[keep], labels.reshape(-1)[keep]


def lovasz_softmax(probas: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255,
                   per_image: bool = False) -> torch.Tensor:
    """Lovász-softmax over present classes.

    probas ``(B, C, H, W)`` softmax probabilities, labels ``(B, H, W)`` int.
    Over N ranks, this rank's share of the global batch's loss."""
    size = world()[1]
    if per_image:
        return torch.stack([
            _lovasz_softmax_flat(*_valid_pixels(p[None], l[None], ignore_label))
            for p, l in zip(probas, labels)]).sum() / (probas.shape[0] * size)
    if size > 1:
        return _lovasz_softmax_ranks(probas, labels, ignore_label)
    return _lovasz_softmax_flat(*_valid_pixels(probas, labels, ignore_label))


# ------------------------------------------------------- binary (hinge) ---


def flatten_binary_scores(scores: torch.Tensor, labels: torch.Tensor,
                          ignore: int | None = None):
    """Flat scores and {0, 1} labels with a validity mask (the JAX surface)."""
    scores, labels = scores.reshape(-1), labels.reshape(-1)
    valid = torch.ones_like(labels, dtype=torch.bool) if ignore is None else labels != ignore
    return scores, labels, valid


def lovasz_hinge_flat(logits: torch.Tensor, labels: torch.Tensor,
                      valid: torch.Tensor | None = None) -> torch.Tensor:
    """Binary Lovász hinge on flat ``(P,)`` logits and {0, 1} labels; 0 when
    no pixel is valid (the reference's empty-image guard). Over N ranks,
    this rank's share of the hinge of the global flat arrays (invalid
    pixels get error −∞, as in the JAX package, and sort to the tail)."""
    if world()[1] == 1:
        return _hinge_flat(logits, labels, valid)
    logits = logits.float()
    valid = torch.ones_like(logits, dtype=torch.bool) if valid is None else valid
    gt = labels.float() * valid
    errors = torch.where(valid, 1.0 - logits * (2.0 * labels.float() - 1.0),
                         torch.full_like(logits, float("-inf")))
    grad, _ = _global_grad(errors[:, None], gt[:, None])
    return (errors.clamp_min(0.0) * grad[:, 0]).sum()


def _hinge_flat(logits: torch.Tensor, labels: torch.Tensor,
                valid: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`lovasz_hinge_flat` of this rank's pixels alone."""
    logits = logits.float()
    if valid is not None:
        logits, labels = logits[valid], labels[valid]
    if logits.numel() == 0:
        return logits.sum() * 0.0
    gt = labels.float()
    errors_sorted, order = (1.0 - logits * (2.0 * gt - 1.0)).sort(descending=True)
    return (errors_sorted.clamp_min(0.0) * _lovasz_grad(gt[order])).sum()


def lovasz_hinge(logits: torch.Tensor, labels: torch.Tensor, per_image: bool = True,
                 ignore: int | None = None) -> torch.Tensor:
    """Binary Lovász hinge over ``(B, H, W)`` logits and {0, 1} labels. Over
    N ranks, this rank's share of the global batch's loss."""
    if per_image:
        return torch.stack([_hinge_flat(*flatten_binary_scores(lg, lb, ignore))
                            for lg, lb in zip(logits, labels)]).sum() / (
                                logits.shape[0] * world()[1])
    return lovasz_hinge_flat(*flatten_binary_scores(logits, labels, ignore))


def binary_xloss(logits: torch.Tensor, labels: torch.Tensor,
                 ignore: int | None = None) -> torch.Tensor:
    """Numerically stable binary cross-entropy with logits, mean over valid
    pixels (over N ranks, this rank's share of the global mean)."""
    logits, labels, valid = flatten_binary_scores(logits, labels, ignore)
    x, y = logits.float(), labels.float()
    per = x.clamp_min(0.0) - x * y + torch.log1p(torch.exp(-x.abs()))
    vf = valid.float()
    return (per * vf).sum() / all_reduce_sum(vf.sum()).clamp_min(1.0)


# ------------------------------------------------------------ IoU metrics ---


def iou_binary(preds, labels, EMPTY: float = 1.0, ignore: int | None = None,
               per_image: bool = True) -> float:
    """Binary IoU × 100 (reference ``loss/lovasz_losses.py:31-44``)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    if not per_image:
        preds, labels = preds[None], labels[None]
    ious = []
    for p, l in zip(preds, labels):
        v = np.ones(l.shape, bool) if ignore is None else l != ignore
        inter = np.sum((l == 1) & (p == 1) & v)
        union = np.sum(((l == 1) | (p == 1)) & v)
        ious.append(EMPTY if union == 0 else inter / union)
    return 100.0 * float(np.mean(ious))


def iou(preds, labels, C: int, EMPTY: float = 1.0, ignore: int | None = None,
        per_image: bool = False):
    """Mean per-class IoU × 100 (reference ``loss/lovasz_losses.py:46-60``)."""
    preds, labels = np.asarray(preds), np.asarray(labels)
    if not per_image:
        preds, labels = preds[None], labels[None]
    per = []
    for p, l in zip(preds, labels):
        v = np.ones(l.shape, bool) if ignore is None else l != ignore
        row = []
        for c in range(C):
            if ignore is not None and c == ignore:
                continue
            inter = np.sum((l == c) & (p == c) & v)
            union = np.sum(((l == c) | (p == c)) & v)
            row.append(EMPTY if union == 0 else inter / union)
        per.append(row)
    return [100.0 * float(x) for x in np.mean(np.asarray(per), axis=0)]
