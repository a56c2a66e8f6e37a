"""An independent torch replica of the reference CCNet, without JAX.

A copy of ``ABN``, ``Bottleneck``, ``TorchCCA``, ``RCCAHead`` and
``TorchCCNet`` from ``tests/test_full_ccnet_torch_parity.py``, which imports
``jax`` and ``ccnet_tpu`` and so cannot be imported where JAX is not
installed. The network is written from the behavioural spec of the
reference's ``networks/ccnet.py:125-191`` (deep stem, ceil-mode max pool,
dilated bottleneck layers, DSN aux head, RCCA head) with the reference's
module names, so ``load_state_dict`` reads a reference-named ``.pth``. Its
criss-cross attention is plain torch ``einsum``/``softmax``. It shares no
code with ``ccnet_tpu_torch.models`` and must stay that way: it is the
yardstick the port's checkpoints are read by.

The only change from the original: the attention's self mask is made on
the input's device, so the replica also runs on a CUDA card.
"""

import torch

F = torch.nn.functional
Conv2d = torch.nn.Conv2d
Seq = torch.nn.Sequential


class ABN(torch.nn.BatchNorm2d):
    """BatchNorm + fused activation, InPlace-ABN semantics (leaky 0.01)."""

    def __init__(self, ch, activation="leaky_relu", slope=0.01):
        super().__init__(ch)
        self._act, self._slope = activation, slope

    def forward(self, x):
        y = super().forward(x)
        return F.leaky_relu(y, self._slope) if self._act == "leaky_relu" else y


class Bottleneck(torch.nn.Module):
    def __init__(self, inplanes, planes, stride=1, dilation=1, multi_grid=1,
                 downsample=False):
        super().__init__()
        d = dilation * multi_grid
        self.conv1 = Conv2d(inplanes, planes, 1, bias=False)
        self.bn1 = ABN(planes, "identity")
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=d,
                            dilation=d, bias=False)
        self.bn2 = ABN(planes, "identity")
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = ABN(planes * 4, "identity")
        self.downsample = (
            Seq(Conv2d(inplanes, planes * 4, 1, stride=stride, bias=False),
                ABN(planes * 4, "identity"))
            if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        res = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + res)


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
        e_col = torch.einsum("bchw,bckw->bhwk", q, k)
        eye = torch.eye(H, dtype=torch.bool, device=x.device)[:, None, :]
        e_col = e_col.masked_fill(eye[None], float("-1e9"))
        e_row = torch.einsum("bchw,bchv->bhwv", q, k)
        att = torch.softmax(torch.cat([e_col, e_row], dim=3), dim=3)
        out_col = torch.einsum("bhwk,bckw->bchw", att[..., :H], v)
        out_row = torch.einsum("bhwv,bchv->bchw", att[..., H:], v)
        return self.gamma * (out_col + out_row) + x


class RCCAHead(torch.nn.Module):
    def __init__(self, cin, cout, classes, R):
        super().__init__()
        inter = cin // 4
        self.R = R
        self.conva = Seq(Conv2d(cin, inter, 3, padding=1, bias=False), ABN(inter))
        self.cca = TorchCCA(inter)
        self.convb = Seq(Conv2d(inter, inter, 3, padding=1, bias=False), ABN(inter))
        self.bottleneck = Seq(
            Conv2d(cin + inter, cout, 3, padding=1, bias=False), ABN(cout),
            torch.nn.Dropout2d(0.1), Conv2d(cout, classes, 1, bias=True))

    def forward(self, x):
        out = self.conva(x)
        for _ in range(self.R):
            out = self.cca(out)
        out = self.convb(out)
        return self.bottleneck(torch.cat([x, out], 1))


class TorchCCNet(torch.nn.Module):
    """Reference-shaped CCNet (networks/ccnet.py:125-191 behavioural spec)."""

    def __init__(self, classes, layers, R):
        super().__init__()
        self.conv1 = Conv2d(3, 64, 3, stride=2, padding=1, bias=False)
        self.bn1 = ABN(64, "identity")
        self.conv2 = Conv2d(64, 64, 3, padding=1, bias=False)
        self.bn2 = ABN(64, "identity")
        self.conv3 = Conv2d(64, 128, 3, padding=1, bias=False)
        self.bn3 = ABN(128, "identity")
        self.maxpool = torch.nn.MaxPool2d(3, stride=2, padding=1, ceil_mode=True)
        inplanes = 128

        def make_layer(planes, blocks, stride=1, dilation=1, grids=None):
            nonlocal inplanes
            mods = []
            for bi in range(blocks):
                mg = grids[bi % len(grids)] if grids else 1
                mods.append(Bottleneck(
                    inplanes, planes, stride=stride if bi == 0 else 1,
                    dilation=dilation, multi_grid=mg,
                    downsample=bi == 0 and (stride != 1 or inplanes != planes * 4)))
                inplanes = planes * 4
            return Seq(*mods)

        self.layer1 = make_layer(64, layers[0])
        self.layer2 = make_layer(128, layers[1], stride=2)
        self.layer3 = make_layer(256, layers[2], dilation=2)
        self.layer4 = make_layer(512, layers[3], dilation=4, grids=(1, 1, 1))
        self.head = RCCAHead(2048, 512, classes, R)
        self.dsn = Seq(Conv2d(1024, 512, 3, padding=1, bias=True), ABN(512),
                       torch.nn.Dropout2d(0.1), Conv2d(512, classes, 1, bias=True))

    def forward(self, x):
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x3 = self.layer3(x)
        x4 = self.layer4(x3)
        return self.head(x4), self.dsn(x3)
