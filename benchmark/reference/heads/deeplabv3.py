"""DeepLabv3's head: ASPP on layer4, as speedinghzl/CCNet
``networks/deeplabv3.py``, then the 1×1 classifier."""

from __future__ import annotations

import torch

from benchmark.reference.models import ABN, Conv2d, MaskedDropout, Seq

F = torch.nn.functional


class ASPP(torch.nn.Module):
    """``networks/deeplabv3.py``'s ASPPModule: image pool, a 1×1 branch and
    three dilated 3×3 branches, concatenated and reduced to 512."""

    def __init__(self, cin, inner, cout, dilations, drop):
        super().__init__()
        self.conv1 = Seq(torch.nn.AdaptiveAvgPool2d((1, 1)),
                         Conv2d(cin, inner, 1, bias=False), ABN(inner))
        self.conv2 = Seq(Conv2d(cin, inner, 1, bias=False), ABN(inner))
        self.conv3, self.conv4, self.conv5 = (
            Seq(Conv2d(cin, inner, 3, padding=d, dilation=d, bias=False), ABN(inner))
            for d in dilations)
        self.bottleneck = Seq(Conv2d(5 * inner, cout, 1, bias=False), ABN(cout),
                              MaskedDropout(drop, cout))

    def forward(self, x):
        h, w = x.shape[2:]
        feat1 = F.interpolate(self.conv1(x), size=(h, w), mode="bilinear",
                              align_corners=True)
        feats = [feat1, self.conv2(x), self.conv3(x), self.conv4(x), self.conv5(x)]
        return self.bottleneck(torch.cat(feats, 1))


def head(config: dict) -> torch.nn.Module:
    aspp = config.get("aspp", {})
    return Seq(ASPP(2048, aspp.get("inner_channels", 256), 512,
                    tuple(aspp.get("dilations", (12, 24, 36))), config.get("dropout", 0.1)),
               Conv2d(512, config["num_classes"], 1, bias=True))
