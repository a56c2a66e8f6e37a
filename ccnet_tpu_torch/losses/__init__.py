from ccnet_tpu_torch.losses.criterion import (
    build_criterion,
    criterion_dsn,
    criterion_ohem_dsn,
    criterion_ohem_dsn2,
)
from ccnet_tpu_torch.losses.cross_entropy import masked_mean, softmax_cross_entropy_ignore
from ccnet_tpu_torch.losses.ohem import ohem_cross_entropy, ohem_keep_mask, ohem_mask

__all__ = [
    "build_criterion",
    "criterion_dsn",
    "criterion_ohem_dsn",
    "criterion_ohem_dsn2",
    "masked_mean",
    "ohem_cross_entropy",
    "ohem_keep_mask",
    "ohem_mask",
    "softmax_cross_entropy_ignore",
]
