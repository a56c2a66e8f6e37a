"""The plain reference networks of the benchmark: a model's head on the
dilated ResNet trunk, in plain torch, NCHW, f32.

The trunk, the DSN head and the building blocks are a frozen copy of the
repository's JAX-free replica of the reference network (``ABN``,
``Bottleneck``, ``TorchCCNet``), itself written from the behavioural spec
of speedinghzl/CCNet ``networks/ccnet.py``. A configuration's main head is
found by its ``"model"`` name in ``heads/<model>.py`` (:func:`find_head`):
CCNet's RCCA in ``heads/ccnet.py``, DeepLabv3's ASPP in
``heads/deeplabv3.py``. Module names are the reference's, so one state dict
of reference names loads into these networks and into the port's. This
file and the heads import nothing of the program and must stay that way:
they are the yardstick the program is judged by.

What differs from the copy:

* every convolution's, attention product's, BN's and residual sum's
  operands and results go through :func:`operand`, the identity unless :func:`precision` asks for
  fp8: the benchmark's control computes the reference with them, and their
  gradients, rounded to float8 (e4m3, one scale per tensor), to show that
  the comparison catches a step below the configuration's bf16;
* the heads' dropout is elementwise (:class:`MaskedDropout`), as the program
  trains with it (flax's ``nn.Dropout``, where the original reference used
  ``Dropout2d``); its mask is set from outside before a training forward,
  drawn by the benchmark by the program's documented rule
  (:func:`benchmark.reference.train.dropout_masks`);
* ``forward`` returns ``(main, aux)`` logits at output stride 8.
"""

from __future__ import annotations

import importlib
import os
import threading
from contextlib import contextmanager

import torch

F = torch.nn.functional
Seq = torch.nn.Sequential

_STATE = threading.local()


@contextmanager
def precision(name: str):
    """Run the enclosed reference forward with its operands rounded to
    ``name``: ``"f32"`` (none) or ``"fp8"`` (float8 e4m3 with a per-tensor
    scale, the control)."""
    if name not in ("f32", "fp8"):
        raise ValueError(f"unknown reference precision {name!r}")
    before = getattr(_STATE, "precision", "f32")
    _STATE.precision = name
    try:
        yield
    finally:
        _STATE.precision = before


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 after scaling its largest magnitude to
    448, and scaled back."""
    scale = 448.0 / x.abs().amax().float().clamp_min(1e-30)
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _Round(torch.autograd.Function):
    """fp8 rounding of a value in the forward and of its gradient in the
    backward."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a product's operand or result at the current precision: in
    fp8 it is rounded (:func:`_fp8`), and so is its gradient."""
    if getattr(_STATE, "precision", "f32") == "f32":
        return x
    return _Round.apply(x)


class Conv2d(torch.nn.Conv2d):
    def forward(self, x):
        return operand(self._conv_forward(operand(x), operand(self.weight), self.bias))


class ABN(torch.nn.BatchNorm2d):
    """BatchNorm + fused activation, InPlace-ABN semantics (leaky 0.01)."""

    def __init__(self, ch, activation="leaky_relu", slope=0.01):
        super().__init__(ch)
        self._act, self._slope = activation, slope

    def forward(self, x):
        y = super().forward(x)
        return operand(F.leaky_relu(y, self._slope) if self._act == "leaky_relu" else y)


class MaskedDropout(torch.nn.Module):
    """Elementwise dropout of a feature of ``channels`` channels with a mask
    given from outside (``mask``, a bool tensor of the input's shape); the
    identity without one. The training step draws the mask at ``channels``
    (:func:`benchmark.reference.train.train_steps`)."""

    def __init__(self, p, channels):
        super().__init__()
        self.p = p
        self.channels = channels
        self.mask = None

    def forward(self, x):
        if self.mask is None:
            return x
        return x * self.mask / (1.0 - self.p)


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
        return operand(F.relu(out + res))


HEADS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "heads")


def find_head(model: str):
    """The ``head(config) -> torch.nn.Module`` of ``heads/<model>.py``;
    ValueError naming the file where there is none."""
    path = os.path.join(HEADS, f"{model}.py")
    if not os.path.isfile(path):
        raise ValueError(f"the reference has no model {model!r}: no head file {path}")
    return importlib.import_module(f"{__package__}.heads.{model}").head


class Segmenter(torch.nn.Module):
    """Deep-stem dilated ResNet at output stride 8 with a DSN auxiliary head
    on layer3 and the configuration's head on layer4 (:func:`find_head`).
    ``forward`` returns ``(main, aux)``."""

    def __init__(self, config: dict):
        super().__init__()
        classes, layers = config["num_classes"], config["layers"]
        drop = config.get("dropout", 0.1)
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
        self.head = find_head(config["model"])(config)
        self.dsn = Seq(Conv2d(1024, 512, 3, padding=1, bias=True), ABN(512),
                       MaskedDropout(drop, 512), Conv2d(512, classes, 1, bias=True))

    def dropouts(self):
        """The dropout modules in the order a training forward of the
        program draws their masks: the auxiliary head's, then the main
        head's."""
        head = [m for m in self.head.modules() if isinstance(m, MaskedDropout)]
        return [self.dsn[2], *head]

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


def build(config: dict, device="cpu") -> Segmenter:
    """The reference network of a configuration file's dict, f32, in eval
    mode on ``device`` (``"meta"`` for shapes and operation counts)."""
    with torch.device(device):
        net = Segmenter(config)
    return net.eval()


def state_names(net: torch.nn.Module) -> list:
    """``(name, shape)`` of every entry of the network's state dict that the
    program's state dict also holds (BN's ``num_batches_tracked`` is the
    reference's own)."""
    return [(n, tuple(t.shape)) for n, t in net.state_dict().items()
            if not n.endswith("num_batches_tracked")]


def load(net: torch.nn.Module, state: dict) -> None:
    """Load a state dict of reference names; only ``num_batches_tracked`` may
    be missing, nothing may be left over."""
    got = net.load_state_dict(state, strict=False)
    if got.unexpected_keys or not all(k.endswith("num_batches_tracked")
                                      for k in got.missing_keys):
        raise ValueError(f"state dict does not fit the reference: unexpected "
                         f"{got.unexpected_keys[:5]}, missing {got.missing_keys[:5]}")
