"""Pooling ops, NCHW. Counterpart of :mod:`ccnet_tpu.ops.pooling`.

:func:`max_pool_ceil` is the reference's
``nn.MaxPool2d(3, 2, padding=1, ceil_mode=True)`` (``networks/ccnet.py:141``),
which torch has natively. :func:`adaptive_avg_pool` is the reference's
``nn.AdaptiveAvgPool2d`` of the PSP pyramid and the ASPP image pool; torch's
bins ``[floor(i·in/out), ceil((i+1)·in/out))`` are the JAX package's
``_adaptive_bin_weights``, also where the input is smaller than the output.

In a height-sharded forward (:func:`~ccnet_tpu_torch.parallel.spatial.current`)
the max pool reads its halo rows (−∞ beyond the image; the ceil-mode row
past the bottom falls to the last shard) and pools them with the width's
ceil-mode padding made explicit; the adaptive pool adds this shard's rows'
share of each bin (the row slice of the bin weights) and sums the shares
over the shards.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from ccnet_tpu_torch.parallel import spatial


def max_pool_ceil(x: torch.Tensor, window: int = 3, stride: int = 2,
                  padding: int = 1) -> torch.Tensor:
    """Max pool with torch ceil_mode=True semantics, NCHW."""
    plan = spatial.current()
    if plan is None:
        return F.max_pool2d(x, window, stride, padding, ceil_mode=True)
    x, = plan.halo([x], window, 1, stride, padding, value=float("-inf"), ceil=True)
    w = x.shape[3]
    w_out = spatial.out_size(w, window, 1, stride, padding, ceil=True)
    x = F.pad(x, (padding, stride * (w_out - 1) + window - w - padding), value=float("-inf"))
    return F.max_pool2d(x, window, stride)


@functools.lru_cache(maxsize=64)
def adaptive_bin_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) f32 weights of torch's adaptive average pool along one
    axis: output i averages the inputs ``[floor(i·n_in/n_out),
    ceil((i+1)·n_in/n_out))``. Built once per (n_in, n_out, device),
    outside inference mode; callers must not write to it."""
    with torch.inference_mode(False):
        m = torch.zeros(n_out, n_in, dtype=torch.float64, device=device)
        for i in range(n_out):
            lo, hi = (i * n_in) // n_out, -(-((i + 1) * n_in) // n_out)
            m[i, lo:hi] = 1.0 / (hi - lo)
        return m.float()


def adaptive_avg_pool(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Adaptive average pool of NCHW ``x`` to ``(out_h, out_w)``, torch binning."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    plan = spatial.current()
    if plan is None:
        return F.adaptive_avg_pool2d(x, (out_h, out_w))
    height, start, end = plan.span(x.shape[2])
    mh = adaptive_bin_weights(height, out_h, x.device)[:, start:end]
    mw = adaptive_bin_weights(x.shape[3], out_w, x.device)
    share = torch.matmul(torch.matmul(mh, x.float()), mw.t())
    return plan.group.sum(share).to(x.dtype)


class AdaptiveAvgPool(nn.Module):
    """:func:`adaptive_avg_pool` to ``(size, size)`` as a module (the ``.0`` of
    the reference's PSP stages and ASPP image pool; it holds no weights)."""

    def __init__(self, size: int):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(x, (self.size, self.size))
