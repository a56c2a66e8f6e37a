"""Pixel cross-entropy with an ignore label.

Counterpart of :mod:`ccnet_tpu.losses.cross_entropy`: the mean per-pixel NLL
over non-ignored pixels, as ``torch.nn.CrossEntropyLoss(ignore_index=255)``
computes it. Logits are NCHW ``(B, C, H, W)``.
"""

from __future__ import annotations

import torch


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean of ``values`` over ``mask`` (0 if nothing is selected)."""
    mask = mask.float()
    total = (values * mask).sum()
    count = mask.sum()
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
