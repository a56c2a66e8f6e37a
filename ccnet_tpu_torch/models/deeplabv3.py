"""DeepLabv3: atrous spatial pyramid pooling (ASPP) over the dilated trunk, NCHW.

Counterpart of :mod:`ccnet_tpu.models.deeplabv3` (reference
``networks/deeplabv3.py:62-126``): an image-pool branch (global average pool
→ 1×1 conv 2048→256 + ABN → align-corners upsample), a 1×1 branch and three
3×3 branches at dilations (12, 24, 36), each 2048→256 without bias + ABN
(leaky 0.01); their concat (5·256) → 1×1 bottleneck to 512 + ABN + dropout,
then the 1×1 classifier. The auxiliary head is CCNet's :class:`DSNHead`.

State-dict names are the reference's, as the JAX package's ``.pth`` export
writes them: ``head.0.conv1.1`` / ``.2`` (image-pool conv / ABN; ``.0`` is
the pool), ``head.0.conv2`` … ``conv5`` (``.0`` conv, ``.1`` ABN),
``head.0.bottleneck.0`` / ``.1``, ``head.1`` (classifier), ``dsn.*``. In
train mode the image-pool ABN sees B values per channel; at B = 1 it
follows the JAX package (zero variance, output β), see :class:`ABN`.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ccnet_tpu_torch.models.ccnet import DSNHead, DSNSegmenter
from ccnet_tpu_torch.nn.layers import ABN, Conv, Dropout
from ccnet_tpu_torch.ops.pooling import AdaptiveAvgPool
from ccnet_tpu_torch.ops.resize import upsample_small_align_corners


class ASPPModule(nn.Module):
    """The ASPP module (``head.0``)."""

    def __init__(self, in_channels: int = 2048, inner_features: int = 256,
                 out_features: int = 512, dilations: Sequence[int] = (12, 24, 36),
                 drop_rate: float = 0.1, dtype=torch.float32):
        super().__init__()
        ic = inner_features
        self.conv1 = nn.Sequential(AdaptiveAvgPool(1),
                                   Conv(in_channels, ic, 1, bias=False, dtype=dtype), ABN(ic))
        self.conv2 = nn.Sequential(Conv(in_channels, ic, 1, bias=False, dtype=dtype), ABN(ic))
        self.conv3, self.conv4, self.conv5 = (
            nn.Sequential(Conv(in_channels, ic, 3, padding=d, dilation=d, bias=False,
                               dtype=dtype), ABN(ic))
            for d in dilations)
        self.bottleneck = nn.Sequential(
            Conv(5 * ic, out_features, 1, bias=False, dtype=dtype),
            ABN(out_features),
            Dropout(drop_rate),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feats = [upsample_small_align_corners(self.conv1(x), x.shape[2:])]
        feats += [branch(x) for branch in (self.conv2, self.conv3, self.conv4, self.conv5)]
        return self.bottleneck(torch.cat(feats, dim=1))


class DeepLabV3(DSNSegmenter):
    """Dilated ResNet + ASPP head. Returns {'main', 'aux'} f32 logits at OS 8."""

    def __init__(self, num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                 drop_rate: float = 0.1, dtype=torch.float32, remat: Any = False):
        super().__init__(layers, dtype=dtype, remat=remat)
        self.head = nn.Sequential(ASPPModule(drop_rate=drop_rate, dtype=dtype),
                                  Conv(512, num_classes, 1, bias=True, dtype=dtype))
        self.dsn = DSNHead(num_classes, drop_rate=drop_rate, dtype=dtype)
