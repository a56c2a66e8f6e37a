"""PSPNet: pyramid scene parsing pooling over the dilated trunk, NCHW.

Counterpart of :mod:`ccnet_tpu.models.pspnet` (reference
``networks/pspnet.py:62-113``): adaptive average pools to (1, 2, 3, 6), each
stage a 1×1 conv 2048→512 (no bias) + ABN(leaky 0.01), upsampled back to the
feature size (bilinear, align_corners=True) and concatenated before the
trunk feature; a 3×3 bottleneck 2048 + 4·512 → 512 + ABN + dropout, then the
1×1 classifier. The auxiliary head is CCNet's :class:`DSNHead`. The priors
are upsampled by :func:`upsample_small_align_corners` (matrix products, no
atomics in the backward).

State-dict names are the reference's, as the JAX package's ``.pth`` export
writes them: ``head.0.stages.{i}.1`` / ``.2`` (stage conv / ABN; ``.0`` is
the pool), ``head.0.bottleneck.0`` / ``.1``, ``head.1`` (classifier),
``dsn.*``. The head has no criss-cross attention and no kernel of its own;
training sends its logits through the K5/K6 criterion as CCNet's.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ccnet_tpu_torch.models.ccnet import DSNHead, DSNSegmenter
from ccnet_tpu_torch.nn.layers import ABN, Conv, Dropout
from ccnet_tpu_torch.ops.pooling import AdaptiveAvgPool
from ccnet_tpu_torch.ops.resize import upsample_small_align_corners


class PSPModule(nn.Module):
    """The pyramid pooling module (``head.0``)."""

    def __init__(self, in_channels: int = 2048, out_channels: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6), drop_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        self.stages = nn.ModuleList(
            nn.Sequential(AdaptiveAvgPool(s),
                          Conv(in_channels, out_channels, 1, bias=False, dtype=dtype),
                          ABN(out_channels))
            for s in sizes)
        self.bottleneck = nn.Sequential(
            Conv(in_channels + len(sizes) * out_channels, out_channels, 3, padding=1,
                 bias=False, dtype=dtype),
            ABN(out_channels),
            Dropout(drop_rate),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        hw = x.shape[2:]
        priors = [upsample_small_align_corners(stage(x), hw) for stage in self.stages]
        return self.bottleneck(torch.cat(priors + [x], dim=1))


class PSPNet(DSNSegmenter):
    """Dilated ResNet + PSP head. Returns {'main', 'aux'} f32 logits at OS 8."""

    def __init__(self, num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                 drop_rate: float = 0.1, dtype=torch.float32, remat: Any = False):
        super().__init__(layers, dtype=dtype, remat=remat)
        self.head = nn.Sequential(PSPModule(drop_rate=drop_rate, dtype=dtype),
                                  Conv(512, num_classes, 1, bias=True, dtype=dtype))
        self.dsn = DSNHead(num_classes, drop_rate=drop_rate, dtype=dtype)
