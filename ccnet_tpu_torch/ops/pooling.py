"""Pooling ops, NCHW. Counterpart of :mod:`ccnet_tpu.ops.pooling`.

:func:`max_pool_ceil` is the reference's
``nn.MaxPool2d(3, 2, padding=1, ceil_mode=True)`` (``networks/ccnet.py:141``),
which torch has natively. ``adaptive_avg_pool`` waits for the PSPNet port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_ceil(x: torch.Tensor, window: int = 3, stride: int = 2,
                  padding: int = 1) -> torch.Tensor:
    """Max pool with torch ceil_mode=True semantics, NCHW."""
    return F.max_pool2d(x, window, stride, padding, ceil_mode=True)
