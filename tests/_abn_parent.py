"""ABN, the bottleneck and the stem as they were before ABN took the
residual and the ReLU into its own call: each BN output a tensor of its
own, then ``F.relu`` and ``out + residual`` as separate torch ops, and eval
BN as ``x * scale + shift`` with scale and shift cast to x's dtype.

:func:`parent_forwards` puts these forwards on the port's classes (through
pytest's ``monkeypatch``), so a test can run the same model both ways. No
JAX here: the card's tests import it too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ccnet_tpu_torch.models.backbone import Bottleneck, DilatedResNet, _remat_block
from ccnet_tpu_torch.nn import layers
from ccnet_tpu_torch.ops.pooling import max_pool_ceil
from ccnet_tpu_torch.parallel import spatial
from ccnet_tpu_torch.parallel.distributed import world


def abn_forward(self, x: torch.Tensor) -> torch.Tensor:
    if self.training and spatial.current() is not None:
        raise RuntimeError("a height-sharded forward is inference only")
    momentum = 0.0 if getattr(layers._STATE, "recomputing", False) else self.momentum
    if self.training and world()[1] > 1:
        y = layers._GlobalBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                          self.running_var, momentum, self.eps)
    elif self.training and x.numel() == x.shape[1]:
        y = self._train_one_value(x, momentum)
    elif self.training:
        y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                         training=True, momentum=momentum, eps=self.eps)
    else:
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        y = x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
    if self.activation == "leaky_relu":
        y = torch.where(y >= 0, y, y * self.slope)
    return y


def bottleneck_forward(self, x: torch.Tensor) -> torch.Tensor:
    out = F.relu(self.bn1(self.conv1(x)))
    out = F.relu(self.bn2(self.conv2(out)))
    out = self.bn3(self.conv3(out))
    residual = self.downsample(x) if self.downsample is not None else x
    return F.relu(out + residual)


def trunk_forward(self, x: torch.Tensor):
    x = x.to(self.dtype)
    x = F.relu(self.bn1(self.conv1(x)))
    x = F.relu(self.bn2(self.conv2(x)))
    x = F.relu(self.bn3(self.conv3(x)))
    x = max_pool_ceil(x, 3, 2, 1)
    feats = []
    for li in (1, 2, 3, 4):
        remat = li in self.remat_layers and self.training and torch.is_grad_enabled()
        for block in getattr(self, f"layer{li}"):
            x = _remat_block(block, x, self.remat_kept) if remat else block(x)
        feats.append(x)
    return feats[2], feats[3]


def parent_forwards(monkeypatch) -> None:
    """Run ABN, ``Bottleneck`` and the trunk's stem as before, until the
    ``monkeypatch`` fixture undoes it."""
    monkeypatch.setattr(layers.ABN, "forward", abn_forward)
    monkeypatch.setattr(Bottleneck, "forward", bottleneck_forward)
    monkeypatch.setattr(DilatedResNet, "forward", trunk_forward)
