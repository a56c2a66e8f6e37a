"""Core layers: conv with a compute dtype, and activated batch norm (ABN).

Counterpart of :mod:`ccnet_tpu.nn.layers`, NCHW.

* :class:`Conv` keeps f32 parameters (OIHW, torch's default init, which the
  JAX package reproduces) and casts input and weight to the compute
  ``dtype`` at call time, so a bf16 model keeps f32 master weights.
* :class:`ABN` is batch norm followed by identity (backbone) or leaky-ReLU
  0.01 (heads, InPlace-ABN's default). In eval mode scale and shift are
  computed in f32 from the running stats, then cast to the input dtype. In
  train mode it is ``F.batch_norm(training=True)`` (statistics in f32 for a
  bf16 input): it normalises with the biased batch variance and updates the
  running stats with momentum 0.1 and the unbiased variance, as the JAX
  package's ABN does, and keeps only its input for the backward (taking the
  statistics of an f32 copy of the input in autograd would keep that copy
  too, for every BN of the network). With one value per channel (the
  DeepLabv3 image-pool ABN at batch 1), where ``F.batch_norm`` raises, it
  does what the JAX package does: zero variance, so the output is β (up to
  rounding), and the running variance updated with ``var·n/max(n−1, 1)``
  = 0. Its buffers are ``running_mean`` and
  ``running_var`` only (no ``num_batches_tracked``), so the JAX package's
  ``.pth`` export loads with ``strict=True``. Inside :func:`recomputing`
  (the backward's recompute of a checkpointed block) it normalises as in
  the forward but updates its running stats with momentum 0, which leaves
  them as they are: the step updates them once, as flax's ``nn.remat``
  does, and the recompute runs the same operations as the forward.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
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


_STATE = threading.local()


@contextmanager
def recomputing():
    """Mark the enclosed forward, on this thread, as the recompute of an
    activation checkpoint: :class:`ABN` leaves its running stats alone."""
    before = getattr(_STATE, "recomputing", False)
    _STATE.recomputing = True
    try:
        yield
    finally:
        _STATE.recomputing = before


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
        momentum = 0.0 if getattr(_STATE, "recomputing", False) else self.momentum
        if self.training and x.numel() == x.shape[1]:
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

    def _train_one_value(self, x: torch.Tensor, momentum: float) -> torch.Tensor:
        """Train mode with one value per channel: the JAX ABN's formula."""
        mean = x.float().mean(dim=(0, 2, 3))
        scale = self.weight * self.eps ** -0.5  # rsqrt(var + eps) at var = 0
        shift = self.bias - mean * scale
        with torch.no_grad():
            self.running_mean.mul_(1 - momentum).add_(momentum * mean)
            self.running_var.mul_(1 - momentum)  # + momentum * 0
        return x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
