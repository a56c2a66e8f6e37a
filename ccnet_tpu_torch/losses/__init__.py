from ccnet_tpu_torch.losses.criterion import (
    build_criterion,
    criterion_dsn,
    criterion_ohem_dsn,
    criterion_ohem_dsn2,
)
from ccnet_tpu_torch.losses.cross_entropy import masked_mean, softmax_cross_entropy_ignore
from ccnet_tpu_torch.losses.lovasz import (
    binary_xloss,
    flatten_binary_scores,
    iou,
    iou_binary,
    lovasz_hinge,
    lovasz_hinge_flat,
    lovasz_softmax,
)
from ccnet_tpu_torch.losses.ohem import ohem_cross_entropy, ohem_keep_mask, ohem_mask

__all__ = [
    "binary_xloss",
    "build_criterion",
    "criterion_dsn",
    "criterion_ohem_dsn",
    "criterion_ohem_dsn2",
    "flatten_binary_scores",
    "iou",
    "iou_binary",
    "lovasz_hinge",
    "lovasz_hinge_flat",
    "lovasz_softmax",
    "masked_mean",
    "ohem_cross_entropy",
    "ohem_keep_mask",
    "ohem_mask",
    "softmax_cross_entropy_ignore",
]
