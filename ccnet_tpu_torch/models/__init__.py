from ccnet_tpu_torch.models.backbone import Bottleneck, DilatedResNet
from ccnet_tpu_torch.models.ccnet import CCNet, CrissCrossAttention, DSNHead, RCCAModule
from ccnet_tpu_torch.models.deeplabv3 import ASPPModule, DeepLabV3
from ccnet_tpu_torch.models.pspnet import PSPModule, PSPNet
from ccnet_tpu_torch.models.registry import build_model, randomize_

__all__ = [
    "ASPPModule",
    "DeepLabV3",
    "PSPModule",
    "PSPNet",
    "Bottleneck",
    "DilatedResNet",
    "CCNet",
    "CrissCrossAttention",
    "DSNHead",
    "RCCAModule",
    "build_model",
    "randomize_",
]
