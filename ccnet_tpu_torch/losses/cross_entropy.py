"""Pixel cross-entropy with an ignore label.

Counterpart of :mod:`ccnet_tpu.losses.cross_entropy`: the mean per-pixel NLL
over non-ignored pixels, as ``torch.nn.CrossEntropyLoss(ignore_index=255)``
computes it. Logits are NCHW ``(B, C, H, W)``.

Over N ranks (a live process group) each function returns this rank's
share of the mean over the global batch: its own sum over the global count
of selected pixels (summed over the ranks, not differentiated). The shares
sum to the one-process mean of the global batch, and so do their gradients.
"""

from __future__ import annotations

import torch

from ccnet_tpu_torch.parallel.mesh import all_reduce_sum


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over ``mask`` (0 if nothing is selected); over N
    ranks, this rank's share of the global mean."""
    mask = mask.float()
    total = (values * mask).sum()
    count = all_reduce_sum(mask.sum().detach(), "loss")
    return torch.where(count > 0, total / count.clamp_min(1.0), torch.zeros_like(total))


def softmax_cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                                 ignore_label: int = 255,
                                 weights: torch.Tensor | None = None) -> torch.Tensor:
    """Mean masked CE. logits ``(B, C, ...)`` float; labels ``(B, ...)`` int.

    ``weights``: an extra per-pixel weight or mask multiplied into the
    validity mask. Returns a scalar f32 loss (0 if nothing is valid)."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    logp = torch.log_softmax(logits.float(), dim=1)
    nll = -logp.gather(1, safe[:, None])[:, 0]
    mask = valid.float()
    if weights is not None:
        mask = mask * weights.float()
    return masked_mean(nll, mask)
