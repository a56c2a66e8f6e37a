"""DANet's head: dual attention on layer4, as junfu1115/DANet's ``DANetHead``,
``PAM_Module`` and ``CAM_Module`` (Fu et al., CVPR 2019, arXiv:1809.02983).

Two branches on layer4, each a 3×3 reduction to 512 (no bias) + BN + ReLU:
``conv5a`` → position attention ``sa`` → ``conv51``, and ``conv5c`` →
channel attention ``sc`` → ``conv52``; their sum goes through ``conv8``,
dropout then the 1×1 classifier with bias. The published auxiliary outputs
``conv6`` and ``conv7`` feed only DANet's own three-term loss, which the
benchmark's one criterion replaces, so they are left out (the
configuration's ``assumed`` says so).

* Position attention: q, k = 1×1 convs to 64, v = 1×1 conv to 512, all
  with bias; ``A = softmax_j(q_i·k_j)`` with no 1/√64 scale, ``out = v·Aᵀ``,
  and ``gamma·out + x``.
* Channel attention: ``E = x·xᵀ`` over the positions, ``A =
  softmax_j(max_k E_ik − E_ij)``, ``out = A·x``, and ``gamma·out + x``.

Both are computed whole, literally: the batch's full N×N affinity (2.83 GB
in f32 at batch 8 of 97² positions) and every product's operands and
results through :func:`~benchmark.reference.models.operand`, E, the
affinity, the softmaxes and both ``out`` included, so that the fp8 control
covers them.
"""

from __future__ import annotations

import torch

from benchmark.reference.models import ABN, Conv2d, MaskedDropout, Seq, operand


class PAM(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.query_conv = Conv2d(c, c // 8, 1)
        self.key_conv = Conv2d(c, c // 8, 1)
        self.value_conv = Conv2d(c, c, 1)
        self.gamma = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        B, C, H, W = x.shape
        q = operand(self.query_conv(x).view(B, -1, H * W).permute(0, 2, 1))
        k = operand(self.key_conv(x).view(B, -1, H * W))
        energy = operand(torch.bmm(q, k))
        attention = operand(torch.softmax(energy, dim=-1))
        v = operand(self.value_conv(x).view(B, -1, H * W))
        out = operand(torch.bmm(v, attention.permute(0, 2, 1))).view(B, C, H, W)
        return self.gamma * out + x


class CAM(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.gamma = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        B, C, H, W = x.shape
        value = operand(x.view(B, C, -1))
        energy = operand(torch.bmm(value, value.permute(0, 2, 1)))
        energy_new = torch.max(energy, -1, keepdim=True)[0].expand_as(energy) - energy
        attention = operand(torch.softmax(energy_new, dim=-1))
        out = operand(torch.bmm(attention, value)).view(B, C, H, W)
        return self.gamma * out + x


def _conv_bn_relu(cin, cout):
    return Seq(Conv2d(cin, cout, 3, padding=1, bias=False), ABN(cout, slope=0.0))


class DANetHead(torch.nn.Module):
    def __init__(self, cin, classes, drop):
        super().__init__()
        inter = cin // 4
        self.conv5a = _conv_bn_relu(cin, inter)
        self.conv5c = _conv_bn_relu(cin, inter)
        self.sa = PAM(inter)
        self.sc = CAM()
        self.conv51 = _conv_bn_relu(inter, inter)
        self.conv52 = _conv_bn_relu(inter, inter)
        self.conv8 = Seq(MaskedDropout(drop, inter), Conv2d(inter, classes, 1))

    def forward(self, x):
        sa = self.conv51(self.sa(self.conv5a(x)))
        sc = self.conv52(self.sc(self.conv5c(x)))
        return self.conv8(operand(sa + sc))


def head(config: dict) -> torch.nn.Module:
    return DANetHead(2048, config["num_classes"], config.get("dropout", 0.1))
