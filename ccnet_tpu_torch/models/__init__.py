from ccnet_tpu_torch.models.backbone import Bottleneck, DilatedResNet
from ccnet_tpu_torch.models.ccnet import CCNet, CrissCrossAttention, DSNHead, RCCAModule
from ccnet_tpu_torch.models.registry import build_model

__all__ = [
    "Bottleneck",
    "DilatedResNet",
    "CCNet",
    "CrissCrossAttention",
    "DSNHead",
    "RCCAModule",
    "build_model",
]
