"""Core layers: conv with a compute dtype, and activated batch norm (ABN).

Counterpart of :mod:`ccnet_tpu.nn.layers`, NCHW.

* :class:`Conv` keeps f32 parameters (OIHW, torch's default init, which the
  JAX package reproduces) and casts input and weight to the compute
  ``dtype`` at call time, so a bf16 model keeps f32 master weights.
* :class:`ABN` is batch norm followed by identity (backbone) or leaky-ReLU
  0.01 (heads, InPlace-ABN's default). In eval mode scale and shift are
  computed in f32 from the running stats, then cast to the input dtype. In
  train mode it normalises with the biased batch variance and updates the
  running stats with momentum 0.1 and the unbiased variance. Its buffers
  are ``running_mean`` and ``running_var`` only (no
  ``num_batches_tracked``), so the JAX package's ``.pth`` export loads with
  ``strict=True``.
"""

from __future__ import annotations

import torch
from torch import nn


class Conv(nn.Conv2d):
    """``nn.Conv2d`` with f32 parameters, run in ``dtype``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3, stride=1,
                 padding=0, dilation=1, bias: bool = True, dtype=torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=padding, dilation=dilation, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = self.bias.to(dt) if self.bias is not None else None
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ABN(nn.Module):
    """Activated batch norm: BN then identity / leaky-ReLU(0.01)."""

    def __init__(self, features: int, activation: str = "leaky_relu", slope: float = 0.01,
                 momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        if activation not in ("leaky_relu", "identity"):
            raise ValueError(f"unknown ABN activation {activation!r}")
        self.activation, self.slope = activation, slope
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            var = (x32.square().mean(dim=(0, 2, 3)) - mean.square()).clamp_min(0.0)
            n = x.shape[0] * x.shape[2] * x.shape[3]
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var * (n / max(n - 1, 1)))
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.eps)
        shift = self.bias - mean * scale
        y = x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        if self.activation == "leaky_relu":
            y = torch.where(y >= 0, y, y * self.slope)
        return y
