"""CCNet: dilated ResNet + recurrent criss-cross attention (RCCA) head, NCHW.

Counterpart of :mod:`ccnet_tpu.models.ccnet`:

* :class:`CrissCrossAttention` — 1×1 q/k convs to C/8, 1×1 v conv to C, the
  joint row+column softmax attention, a zero-initialised scalar ``gamma``
  gate and the residual add. At init the module is an identity, so a wrong
  attention kernel changes no logit until ``gamma`` is non-zero.
* :class:`RCCAModule` — 3×3 conv 2048→512 + ABN(leaky 0.01), CCA applied
  ``recurrence`` times with shared weights, 3×3 conv + ABN, a bottleneck
  over ``concat([trunk, attended])`` (2560→512) + ABN + dropout + the 1×1
  classifier.
* :class:`DSNHead` — the auxiliary head off layer3.

The model returns f32 ``{'main', 'aux'}`` logits at OS 8; the loss lives
outside it. State-dict names are the reference's (``head.cca.gamma``,
``head.bottleneck.0.weight``, ``dsn.3.bias``, ...).

CCA routing: ``impl="torch"`` runs the plain version, ``impl="kernel"`` the
CUDA kernels (and raises on a CPU tensor), ``impl="auto"`` takes the kernels
on a CUDA tensor and the plain version on a CPU tensor. The kernel route is
:class:`~ccnet_tpu_torch.ops.cc_attention_cuda.CrissCrossAttentionFn`: K1/K2
forward and, in training, K3/K4 backward; under ``torch.inference_mode()``
nothing is kept for a backward. The JAX package's TPU crossover
(``_CCA_PALLAS_MIN_AXIS_SUM``) is a v5e measurement and is not carried over.
Head and DSN dropout (``drop_rate``, elementwise, as flax ``nn.Dropout``)
acts in train mode only.

In a height-sharded forward (:mod:`~ccnet_tpu_torch.parallel.spatial`) the
attention gathers q, k and v of every shard (three gathers a call, 3·R an
image), runs on the whole map and keeps this shard's rows; the route the
kernels take is then the one process's. ``_ConcatConv`` exchanges the halo
rows of both its inputs at once; every other padded convolution is a
:class:`~ccnet_tpu_torch.nn.layers.Conv`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ccnet_tpu_torch.models.backbone import DilatedResNet
from ccnet_tpu_torch.nn.layers import ABN, Conv, Dropout
from ccnet_tpu_torch.ops.cc_attention import criss_cross_attention
from ccnet_tpu_torch.ops.cc_attention_cuda import criss_cross_attention_cuda
from ccnet_tpu_torch.parallel import spatial

CCA_IMPLS = ("torch", "kernel", "auto")


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class CrissCrossAttention(nn.Module):
    """Criss-cross attention with q/k/v projections and gamma-gated residual."""

    def __init__(self, features: int, impl: str = "auto", dtype=torch.float32):
        super().__init__()
        if impl not in CCA_IMPLS:
            raise ValueError(f"impl must be one of {CCA_IMPLS}, got {impl!r}")
        self.impl = impl
        self.query_conv = Conv(features, features // 8, 1, dtype=dtype)
        self.key_conv = Conv(features, features // 8, 1, dtype=dtype)
        self.value_conv = Conv(features, features, 1, dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self.query_conv(x), self.key_conv(x), self.value_conv(x)
        plan = spatial.current()
        if plan is not None:  # the attention reads whole columns: every shard's rows
            q, k, v = plan.gather(q), plan.gather(k), plan.gather(v)
        q, k, v = _nhwc(q), _nhwc(k), _nhwc(v)
        impl = self.impl
        if impl == "auto":
            impl = "kernel" if x.device.type == "cuda" else "torch"
        if impl == "kernel":
            if x.device.type != "cuda":
                raise ValueError(f"impl='kernel' needs a CUDA tensor, got one on {x.device}")
            out = criss_cross_attention_cuda(q, k, v)[0]
        else:
            out = criss_cross_attention(q, k, v)
        out = out.permute(0, 3, 1, 2)
        if plan is not None:
            _, start, end = plan.span(x.shape[2])
            out = out[:, :, start:end]
        return self.gamma.to(x.dtype) * out + x


class _ConcatConv(nn.Module):
    """3×3 conv over the channel concat of two inputs, without the concat.

    ``conv(cat([a, b]), W) == conv(a, W[:, :Ca]) + conv(b, W[:, Ca:])``. The
    parameter keeps the reference's single fused shape and name
    (``head.bottleneck.0.weight``), so checkpoints convert unchanged.
    """

    def __init__(self, in_a: int, in_b: int, features: int, dtype=torch.float32):
        super().__init__()
        self.in_a = in_a
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_a + in_b, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))  # nn.Conv2d's default

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w = self.weight.to(dt)
        ca = self.in_a
        a, b, padding = a.to(dt), b.to(dt), 1
        plan = spatial.current()
        if plan is not None:
            a, b = plan.halo([a, b], 3, 1, 1, 1)
            padding = (0, 1)
        return (F.conv2d(a, w[:, :ca], padding=padding)
                + F.conv2d(b, w[:, ca:], padding=padding))


class RCCAModule(nn.Module):
    """Recurrent criss-cross head: conva → CCA×R (shared) → convb → bottleneck."""

    def __init__(self, num_classes: int, in_channels: int = 2048, out_channels: int = 512,
                 recurrence: int = 2, impl: str = "auto", drop_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__()
        inter = in_channels // 4
        self.recurrence = recurrence
        self.conva = nn.Sequential(Conv(in_channels, inter, 3, padding=1, bias=False, dtype=dtype),
                                   ABN(inter))
        self.cca = CrissCrossAttention(inter, impl=impl, dtype=dtype)
        self.convb = nn.Sequential(Conv(inter, inter, 3, padding=1, bias=False, dtype=dtype),
                                   ABN(inter))
        self.bottleneck = nn.Sequential(
            _ConcatConv(in_channels, inter, out_channels, dtype=dtype),
            ABN(out_channels),
            Dropout(drop_rate),
            Conv(out_channels, num_classes, 1, bias=True, dtype=dtype),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conva(x)
        for _ in range(self.recurrence):
            out = self.cca(out)  # shared weights across recurrence steps
        out = self.convb(out)
        cat_conv, bn, drop, classifier = self.bottleneck
        return classifier(drop(bn(cat_conv(x, out))))


class DSNHead(nn.Sequential):
    """Deeply-supervised auxiliary head off layer3 (``dsn.0`` … ``dsn.3``)."""

    def __init__(self, num_classes: int, in_channels: int = 1024, drop_rate: float = 0.1,
                 dtype=torch.float32):
        super().__init__(
            Conv(in_channels, 512, 3, padding=1, bias=True, dtype=dtype),
            ABN(512),
            Dropout(drop_rate),
            Conv(512, num_classes, 1, bias=True, dtype=dtype),
        )


class DSNSegmenter(DilatedResNet):
    """The trunk with a subclass's ``head`` on layer4 and its :class:`DSNHead`
    ``dsn`` on layer3 (CCNet, PSPNet, DeepLabv3). Returns {'main', 'aux'} f32
    logits at OS 8."""

    #: False where the head reads every position of the map (DANet's
    #: attentions), so a height-sharded forward (``--space``) cannot run it
    height_shardable = True

    @classmethod
    def check_shardable(cls) -> None:
        """Raise ValueError unless the model runs on a shard's rows."""
        if not cls.height_shardable:
            raise ValueError(f"{cls.__name__}'s head reads every position of the map and is "
                             "not height-sharded: run it without --space")

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if spatial.current() is not None:
            self.check_shardable()
        x3, x4 = super().forward(x)
        aux = self.dsn(x3)
        main = self.head(x4)
        return {"main": main.float(), "aux": aux.float()}


class CCNet(DSNSegmenter):
    """Full CCNet segmentation model. Returns {'main', 'aux'} f32 logits at OS 8.

    The backbone's modules sit at the top level (``conv1``, ``layer3.0``), as
    in the reference's state dict; ``head`` and ``dsn`` sit beside them.
    """

    def __init__(self, num_classes: int = 19, layers: Sequence[int] = (3, 4, 23, 3),
                 recurrence: int = 2, impl: str = "auto", drop_rate: float = 0.1,
                 dtype=torch.float32, remat: Any = False):
        super().__init__(layers, dtype=dtype, remat=remat)
        self.head = RCCAModule(num_classes, recurrence=recurrence, impl=impl,
                               drop_rate=drop_rate, dtype=dtype)
        self.dsn = DSNHead(num_classes, drop_rate=drop_rate, dtype=dtype)

    def set_cca_impl(self, impl: str) -> None:
        if impl not in CCA_IMPLS:
            raise ValueError(f"impl must be one of {CCA_IMPLS}, got {impl!r}")
        self.head.cca.impl = impl
