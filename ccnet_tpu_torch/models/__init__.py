from ccnet_tpu_torch.models.backbone import Bottleneck, DilatedResNet
from ccnet_tpu_torch.models.ccnet import CCNet, CrissCrossAttention, DSNHead, RCCAModule
from ccnet_tpu_torch.models.danet import CAMModule, DANet, DANetHead, PAMModule
from ccnet_tpu_torch.models.deeplabv3 import ASPPModule, DeepLabV3
from ccnet_tpu_torch.models.pspnet import PSPModule, PSPNet
from ccnet_tpu_torch.models.registry import MODELS, build_model, randomize_

__all__ = [
    "ASPPModule",
    "CAMModule",
    "DANet",
    "DANetHead",
    "PAMModule",
    "DeepLabV3",
    "PSPModule",
    "PSPNet",
    "Bottleneck",
    "DilatedResNet",
    "CCNet",
    "CrissCrossAttention",
    "DSNHead",
    "RCCAModule",
    "MODELS",
    "build_model",
    "randomize_",
]
