"""Online hard example mining (OHEM) cross-entropy.

Counterpart of :mod:`ccnet_tpu.losses.ohem`, with the same selection rule:
keep the valid pixels whose probability for their correct class is ``<=
max(thresh, p_k)``, where ``p_k`` is the k-th smallest such probability
over the valid pixels, ``k = min_kept``; keep every valid pixel when no
more than ``min_kept`` are valid. The JAX package finds ``p_k`` by count
bisection to avoid a sort on the TPU; here it is an exact
``torch.kthvalue`` over the flat map with the invalid pixels at +inf, and
the keep masks are equal.
"""

from __future__ import annotations

import torch

from ccnet_tpu_torch.losses.cross_entropy import masked_mean


def ohem_keep_mask(p_correct: torch.Tensor, valid: torch.Tensor, thresh: float,
                   min_kept: int) -> torch.Tensor:
    """The selection rule on precomputed correct-class probabilities."""
    flat = torch.where(valid, p_correct.float(), torch.full_like(p_correct.float(), float("inf")))
    flat = flat.reshape(-1)
    k = min(min_kept, flat.numel())
    t = torch.tensor(thresh, dtype=torch.float32, device=flat.device)
    if k <= 0:
        threshold = t
    else:
        kth = torch.kthvalue(flat, k).values
        threshold = torch.where(valid.sum() <= min_kept, torch.ones_like(t),
                                torch.maximum(t, kth))
    return valid & (p_correct <= threshold)


def ohem_mask(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255,
              thresh: float = 0.7, min_kept: int = 100000) -> torch.Tensor:
    """Boolean keep-mask over pixels. logits ``(B, C, ...)``, labels ``(B, ...)``."""
    logits = logits.detach().float()  # selection is not differentiated
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    p_correct = torch.softmax(logits, dim=1).gather(1, safe[:, None])[:, 0]
    return ohem_keep_mask(p_correct, valid, thresh, min_kept)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255,
                       thresh: float = 0.7, min_kept: int = 100000) -> torch.Tensor:
    """OHEM-masked mean CE (scalar f32); selection on ``exp(−nll)`` of the
    same log-softmax the loss uses, as the JAX package does."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.log_softmax(logits.float(), dim=1).gather(1, safe[:, None])[:, 0]
    p_correct = torch.exp(-nll.detach())
    return masked_mean(nll, ohem_keep_mask(p_correct, valid, thresh, min_kept))
