"""Pooling ops, NCHW. Counterpart of :mod:`ccnet_tpu.ops.pooling`.

:func:`max_pool_ceil` is the reference's
``nn.MaxPool2d(3, 2, padding=1, ceil_mode=True)`` (``networks/ccnet.py:141``),
which torch has natively. :func:`adaptive_avg_pool` is the reference's
``nn.AdaptiveAvgPool2d`` of the PSP pyramid and the ASPP image pool; torch's
bins ``[floor(i·in/out), ceil((i+1)·in/out))`` are the JAX package's
``_adaptive_bin_weights``, also where the input is smaller than the output.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def max_pool_ceil(x: torch.Tensor, window: int = 3, stride: int = 2,
                  padding: int = 1) -> torch.Tensor:
    """Max pool with torch ceil_mode=True semantics, NCHW."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=True)


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Adaptive average pool of NCHW ``x`` to ``(out_h, out_w)``, torch binning."""
    return F.adaptive_avg_pool2d(x, (int(out_hw[0]), int(out_hw[1])))


class AdaptiveAvgPool(nn.Module):
    """:func:`adaptive_avg_pool` to ``(size, size)`` as a module (the ``.0`` of
    the reference's PSP stages and ASPP image pool; it holds no weights)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(x, (self.size, self.size))
