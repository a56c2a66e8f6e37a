"""DSN training criteria: main + 0.4·aux deep supervision.

Counterpart of :mod:`ccnet_tpu.losses.criterion`. Each criterion upsamples
the OS-8 logits (NCHW, as the model returns them) to the label size with
align_corners=True before the pixel loss. The per-pixel NLL routes by
``impl``, as the model's criss-cross attention does:

* ``"auto"`` — a CUDA tensor with one integer align-corners ratio takes the
  fused kernels (:class:`~ccnet_tpu_torch.ops.upsampled_ce.UpsampledNLLFn`,
  K5 forward and K6 backward); a CPU tensor or another ratio takes the
  plain :func:`~ccnet_tpu_torch.ops.upsampled_ce.upsampled_nll_reference`;
* ``"kernel"`` — the fused kernels (raises on a CPU tensor);
* ``"torch"`` — the plain version.

The JAX package's ``CCNET_TPU_FUSED_NLL`` switch is not carried over.
``criterion_ohem_dsn2`` (CE + Lovász-softmax) needs the full-resolution
softmax anyway, so it keeps the materialised upsample and takes no ``impl``.

Over N ranks (a live process group) ``criterion_dsn`` and
``criterion_ohem_dsn`` return this rank's share of the loss of the global
batch: the OHEM threshold is the global one and each masked mean divides
by the global count (:mod:`~ccnet_tpu_torch.losses.ohem`,
:func:`~ccnet_tpu_torch.losses.cross_entropy.masked_mean`), so the ranks'
shares sum to the one-process loss of the global batch. So does
``criterion_ohem_dsn2``: its Lovász term sorts the errors of the global
batch, gathered from every rank (:mod:`~ccnet_tpu_torch.losses.lovasz`).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Dict

import torch

from ccnet_tpu_torch.losses.cross_entropy import masked_mean, softmax_cross_entropy_ignore
from ccnet_tpu_torch.losses.lovasz import lovasz_softmax
from ccnet_tpu_torch.losses.ohem import ohem_keep_mask
from ccnet_tpu_torch.ops.resize import resize_bilinear_align_corners
from ccnet_tpu_torch.ops.upsampled_ce import (
    UpsampledNLLFn,
    integer_upsample_ratio,
    upsampled_nll_reference,
)

NLL_IMPLS = ("torch", "kernel", "auto")


def _nll(logits: torch.Tensor, labels: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """(B, H, W) f32 per-pixel NLL of the upsampled logits."""
    if impl not in NLL_IMPLS:
        raise ValueError(f"impl must be one of {NLL_IMPLS}, got {impl!r}")
    h, w = logits.shape[2:]
    H, W = labels.shape[1:]
    r = integer_upsample_ratio(h, H)
    fusable = r is not None and r == integer_upsample_ratio(w, W)
    if impl == "auto":
        impl = "kernel" if logits.device.type == "cuda" and fusable else "torch"
    if impl == "kernel":
        if logits.device.type != "cuda":
            raise ValueError(f"impl='kernel' needs a CUDA tensor, got one on {logits.device}")
        if labels.dtype not in (torch.int32, torch.uint8):
            labels = labels.int()
        return UpsampledNLLFn.apply(logits.float().contiguous(), labels.contiguous())
    return upsampled_nll_reference(logits, labels)


def criterion_dsn(outputs: Dict[str, torch.Tensor], labels: torch.Tensor,
                  ignore_label: int = 255, impl: str = "auto") -> torch.Tensor:
    """CE(main) + 0.4·CE(aux)."""
    valid = labels != ignore_label
    loss1 = masked_mean(_nll(outputs["main"], labels, impl), valid)
    loss2 = masked_mean(_nll(outputs["aux"], labels, impl), valid)
    return loss1 + 0.4 * loss2


def criterion_ohem_dsn(outputs: Dict[str, torch.Tensor], labels: torch.Tensor,
                       ignore_label: int = 255, thresh: float = 0.7,
                       min_kept: int = 100000, impl: str = "auto") -> torch.Tensor:
    """OHEM-CE(main) + 0.4·CE(aux); selection on ``exp(−nll)`` of the main
    head's NLL, not differentiated."""
    valid = labels != ignore_label
    nll_main = _nll(outputs["main"], labels, impl)
    keep = ohem_keep_mask(torch.exp(-nll_main.detach()), valid, thresh, min_kept)
    loss1 = masked_mean(nll_main, keep)
    loss2 = masked_mean(_nll(outputs["aux"], labels, impl), valid)
    return loss1 + 0.4 * loss2


def criterion_ohem_dsn2(outputs: Dict[str, torch.Tensor], labels: torch.Tensor,
                        ignore_label: int = 255) -> torch.Tensor:
    """CE(main) + Lovász-softmax(main), on the materialised f32 upsample
    (over N ranks, this rank's share of the global batch's loss)."""
    up = resize_bilinear_align_corners(outputs["main"], labels.shape[1:])
    loss1 = softmax_cross_entropy_ignore(up, labels, ignore_label)
    loss2 = lovasz_softmax(torch.softmax(up, dim=1), labels, ignore_label)
    return loss1 + loss2


def build_criterion(ohem: bool = False, use_lovasz: bool = False, ignore_label: int = 255,
                    thresh: float = 0.7, min_kept: int = 100000,
                    impl: str = "auto") -> Callable:
    """Criterion factory with the reference's train-time selection."""
    if impl not in NLL_IMPLS:
        raise ValueError(f"impl must be one of {NLL_IMPLS}, got {impl!r}")
    if use_lovasz:
        return partial(criterion_ohem_dsn2, ignore_label=ignore_label)
    if ohem:
        return partial(criterion_ohem_dsn, ignore_label=ignore_label, thresh=thresh,
                       min_kept=min_kept, impl=impl)
    return partial(criterion_dsn, ignore_label=ignore_label, impl=impl)
