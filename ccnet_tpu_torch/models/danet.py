"""DANet: dual attention (position and channel) over the dilated trunk, NCHW.

Fu et al., "Dual Attention Network for Scene Segmentation", CVPR 2019
(arXiv:1809.02983), as junfu1115/DANet's ``DANetHead``, ``PAM_Module`` and
``CAM_Module``. Neither the JAX package nor the reference network builds
it; the port has it on the shared trunk, DSN head and train step.

On layer4 (2048 channels, output stride 8) two branches run side by side:

* ``conv5a`` (3×3 2048→512, no bias, + ABN with ReLU) → position attention
  ``sa`` (1×1 convs with bias to q, k of 64 channels and v of 512,
  ``softmax_j(q_i·k_j)`` over every position with no 1/√64 scale, the
  ``gamma``-gated residual) → ``conv51`` (3×3 512→512 + ABN with ReLU);
* ``conv5c`` → channel attention ``sc`` (``softmax_j(max_k E_ik − E_ij)``
  over ``E = x·xᵀ``, the ``gamma``-gated residual) → ``conv52``.

Their sum goes through ``conv8``: dropout 0.1 and the 1×1 classifier with
bias. ``gamma`` is zero-initialised, as published, so at init both
attentions are identities. The published auxiliary outputs ``conv6`` and
``conv7`` feed only DANet's own three-term loss; the port trains every
model with its one criterion (OHEM + DSN), so they are left out. The head's
ABN activation is ReLU as published (slope 0), the trunk's and DSN's are
CCNet's. The attentions are :mod:`ccnet_tpu_torch.ops.dual_attention`'s
ops; their spans are ``danet.pam`` and ``danet.cam``.

Both attentions read every position of the map, so a height-sharded
forward (``--space``) cannot run them on a shard's rows: ``DANet`` is not
``height_shardable``, and such a forward raises.

State-dict names are the published ones under ``head.``: ``conv5a.0``
(conv), ``conv5a.1`` (ABN), likewise ``conv5c``, ``conv51``, ``conv52``;
``sa.{query_conv,key_conv,value_conv,gamma}``, ``sc.gamma``; ``conv8.1``
(the classifier after the dropout ``conv8.0``); ``dsn.*``.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
from torch import nn

from ccnet_tpu_torch.models.ccnet import DSNHead, DSNSegmenter
from ccnet_tpu_torch.nn.layers import ABN, Conv, Dropout
from ccnet_tpu_torch.ops.dual_attention import channel_attention, position_attention
from ccnet_tpu_torch.utils import trace


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, H·W, C) contiguous."""
    return x.flatten(2).transpose(1, 2).contiguous()


class PAMModule(nn.Module):
    """Position attention (``head.sa``): q, k of ``features // 8`` channels,
    v of ``features``, softmax over every position at scale 1."""

    def __init__(self, features: int, dtype=torch.float32):
        super().__init__()
        self.query_conv = Conv(features, features // 8, 1, dtype=dtype)
        self.key_conv = Conv(features, features // 8, 1, dtype=dtype)
        self.value_conv = Conv(features, features, 1, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = (_tokens(conv(x)) for conv in (self.query_conv, self.key_conv,
                                                  self.value_conv))
        # NCHW-contiguous, as every feature of the port: a dropout draws its
        # mask in memory order
        out = position_attention(q, k, v).transpose(1, 2).contiguous().view(x.shape)
        return self.gamma.to(x.dtype) * out + x


class CAMModule(nn.Module):
    """Channel attention (``head.sc``): a C×C softmax over ``x·xᵀ``."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = channel_attention(x.flatten(2)).view(x.shape)
        return self.gamma.to(x.dtype) * out + x


def _conv_abn(cin: int, cout: int, dtype) -> nn.Sequential:
    return nn.Sequential(Conv(cin, cout, 3, padding=1, bias=False, dtype=dtype),
                         ABN(cout, slope=0.0))


class DANetHead(nn.Module):
    """The dual-attention head (``head``) without the auxiliary ``conv6``
    and ``conv7``."""

    def __init__(self, num_classes: int, in_channels: int = 2048, drop_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        inter = in_channels // 4
        self.conv5a = _conv_abn(in_channels, inter, dtype)
        self.conv5c = _conv_abn(in_channels, inter, dtype)
        self.sa = PAMModule(inter, dtype=dtype)
        self.sc = CAMModule()
        self.conv51 = _conv_abn(inter, inter, dtype)
        self.conv52 = _conv_abn(inter, inter, dtype)
        self.conv8 = nn.Sequential(Dropout(drop_rate),
                                   Conv(inter, num_classes, 1, bias=True, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with trace.span("danet.pam"):
            sa = self.conv51(self.sa(self.conv5a(x)))
        with trace.span("danet.cam"):
            sc = self.conv52(self.sc(self.conv5c(x)))
        return self.conv8(sa + sc)


class DANet(DSNSegmenter):
    """Dilated ResNet + dual-attention head. Returns {'main', 'aux'} f32
    logits at OS 8."""

    height_shardable = False

    def __init__(self, num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                 drop_rate: float = 0.1, dtype=torch.float32, remat: Any = False):
        super().__init__(layers, dtype=dtype, remat=remat)
        self.head = DANetHead(num_classes, drop_rate=drop_rate, dtype=dtype)
        self.dsn = DSNHead(num_classes, drop_rate=drop_rate, dtype=dtype)
