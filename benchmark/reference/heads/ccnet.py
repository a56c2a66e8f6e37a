"""CCNet's head: recurrent criss-cross attention (RCCA) on layer4, as
speedinghzl/CCNet ``networks/ccnet.py``'s ``RCCAModule``: a 3×3 reduction to
512, the criss-cross attention ``recurrence`` times with shared weights, a
3×3 convolution, and the bottleneck over the trunk's feature and the
attention's, with dropout before the classifier."""

from __future__ import annotations

import torch

from benchmark.reference.models import ABN, Conv2d, MaskedDropout, Seq, operand


class TorchCCA(torch.nn.Module):
    def __init__(self, c):
        super().__init__()
        self.query_conv = Conv2d(c, c // 8, 1)
        self.key_conv = Conv2d(c, c // 8, 1)
        self.value_conv = Conv2d(c, c, 1)
        self.gamma = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x):
        B, C, H, W = x.shape
        q, k, v = self.query_conv(x), self.key_conv(x), self.value_conv(x)
        q, k, v = operand(q), operand(k), operand(v)
        e_col = torch.einsum("bchw,bckw->bhwk", q, k)
        eye = torch.eye(H, dtype=torch.bool, device=x.device)[:, None, :]
        e_col = e_col.masked_fill(eye[None], float("-1e9"))
        e_row = torch.einsum("bchw,bchv->bhwv", q, k)
        e_col, e_row = operand(e_col), operand(e_row)
        att = operand(torch.softmax(torch.cat([e_col, e_row], dim=3), dim=3))
        out_col = torch.einsum("bhwk,bckw->bchw", att[..., :H], v)
        out_row = torch.einsum("bhwv,bchv->bchw", att[..., H:], v)
        return self.gamma * operand(out_col + out_row) + x


class RCCAHead(torch.nn.Module):
    def __init__(self, cin, cout, classes, R, drop):
        super().__init__()
        inter = cin // 4
        self.R = R
        self.conva = Seq(Conv2d(cin, inter, 3, padding=1, bias=False), ABN(inter))
        self.cca = TorchCCA(inter)
        self.convb = Seq(Conv2d(inter, inter, 3, padding=1, bias=False), ABN(inter))
        self.bottleneck = Seq(
            Conv2d(cin + inter, cout, 3, padding=1, bias=False), ABN(cout),
            MaskedDropout(drop, cout), Conv2d(cout, classes, 1, bias=True))

    def forward(self, x):
        out = self.conva(x)
        for _ in range(self.R):
            out = self.cca(out)
        out = self.convb(out)
        return self.bottleneck(torch.cat([x, out], 1))


def head(config: dict) -> torch.nn.Module:
    return RCCAHead(2048, 512, config["num_classes"], config.get("recurrence", 2),
                    config.get("dropout", 0.1))
