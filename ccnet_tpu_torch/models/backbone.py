"""Deep-stem dilated ResNet backbone (output stride 8), NCHW.

Counterpart of :mod:`ccnet_tpu.models.backbone`, with the same geometry:

* deep stem: three 3×3 convs (3→64 s2, 64→64, 64→128), BN(identity)+ReLU
  each, then the 3×3/s2 ceil-mode maxpool;
* layers of ``Bottleneck`` (expansion 4);
* layer3 at stride 1 / dilation 2, layer4 at stride 1 / dilation 4 with
  multi_grid (1, 1, 1) → output stride 8;
* the layer3 feature is returned for the DSN auxiliary head.

Module names are the reference's torch names (``conv1``, ``layer1.0``,
``downsample.0``), which the JAX package's ``.pth`` export writes. The JAX
package's remat policies (``checkpoint_name``) are not carried over.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ccnet_tpu_torch.nn.layers import ABN, Conv
from ccnet_tpu_torch.ops.pooling import max_pool_ceil


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4, optional dilation + multi-grid."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 multi_grid: int = 1, has_downsample: bool = False, dtype=torch.float32):
        super().__init__()
        d = dilation * multi_grid
        self.conv1 = Conv(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = ABN(planes, "identity")
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=d, dilation=d,
                          bias=False, dtype=dtype)
        self.bn2 = ABN(planes, "identity")
        self.conv3 = Conv(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = ABN(planes * 4, "identity")
        self.downsample = (
            nn.Sequential(Conv(inplanes, planes * 4, 1, stride=stride, bias=False, dtype=dtype),
                          ABN(planes * 4, "identity"))
            if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + residual)


class DilatedResNet(nn.Module):
    """Deep-stem dilated ResNet trunk; :meth:`forward` returns (layer3, layer4)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(3, 64, 3, stride=2, padding=1, bias=False, dtype=dtype)
        self.bn1 = ABN(64, "identity")
        self.conv2 = Conv(64, 64, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = ABN(64, "identity")
        self.conv3 = Conv(64, 128, 3, padding=1, bias=False, dtype=dtype)
        self.bn3 = ABN(128, "identity")
        specs = [  # (planes, stride, dilation, multi_grid tuple)
            (64, 1, 1, None),
            (128, 2, 1, None),
            (256, 1, 2, None),
            (512, 1, 4, (1, 1, 1)),
        ]
        inplanes = 128
        for li, ((planes, stride, dilation, grids), blocks) in enumerate(zip(specs, layers), 1):
            mods = []
            for bi in range(blocks):
                mods.append(Bottleneck(
                    inplanes, planes, stride=stride if bi == 0 else 1, dilation=dilation,
                    multi_grid=grids[bi % len(grids)] if grids else 1,
                    has_downsample=bi == 0 and (stride != 1 or inplanes != planes * 4),
                    dtype=dtype))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = max_pool_ceil(x, 3, 2, 1)
        x = self.layer2(self.layer1(x))
        x3 = self.layer3(x)
        return x3, self.layer4(x3)
