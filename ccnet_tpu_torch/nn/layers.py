"""Core layers: conv with a compute dtype, and activated batch norm (ABN).

Counterpart of :mod:`ccnet_tpu.nn.layers`, NCHW.

* :class:`Conv` keeps f32 parameters (OIHW, torch's default init, which the
  JAX package reproduces) and casts input and weight to the compute
  ``dtype`` at call time, so a bf16 model keeps f32 master weights. In a
  height-sharded forward (:func:`~ccnet_tpu_torch.parallel.spatial.current`)
  a convolution whose window reads other rows (a kernel taller than one
  row, or row padding) takes its halo rows from the other shards and runs
  without row padding.
* :class:`ABN` is batch norm followed by identity (backbone) or leaky-ReLU
  0.01 (heads, InPlace-ABN's default); ``ABN(x, residual, relu=True)``
  returns ``relu(BN(x) + residual)`` (the bottleneck's tail), else the
  ABN's own activation. In eval mode a CUDA tensor takes the whole of it
  in one pass of the hand-written kernel
  (:func:`ccnet_tpu_torch.ops.abn_eval.abn_eval`: bf16 or f32, f32
  arithmetic rounded once, any layout, a residual of x's shape and dtype;
  anything else raises) and counts ``abn.eval.fused``; a tensor off the
  card (the CPU) takes the torch expression (scale and shift computed in
  f32 from the running stats, cast to the input dtype, then the residual
  add and the activation) and counts ``abn.eval.plain``. Train mode never
  takes the kernel: it runs BN, then ``+ residual``, then the
  activation, as separate torch ops, BN being
  ``F.batch_norm(training=True)`` (statistics in f32 for a bf16 input):
  it normalises with the biased batch variance and updates the
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
* Over N ranks (a live process group of more than one process) ABN's train
  mode normalises with the moments of the global batch, as the JAX ABN's
  means over a sharded batch are global: :class:`_GlobalBatchNorm` takes
  each rank's channel means and centred sums of squares in two f32 passes,
  as ``F.batch_norm`` does, combines them over the ranks in f64 in one
  ``all_reduce`` with the count, and reduces its gradient sums over the
  ranks in its backward. So the N-rank moments are the one-process
  moments up to f32 rounding. One value per channel per rank takes the
  same route. A recompute under remat issues the same collectives, in the
  same order, on every rank, and leaves the running stats as they are.
* A height-sharded forward is inference only: ABN raises in train mode
  there, so the global-moments branch never runs on a row shard (ABN in
  eval mode is a per-channel affine map and needs no communication).
* :class:`Dropout` is ``nn.Dropout`` whose mask, over N ranks, is the
  rank's slice of the mask one process draws for the global batch.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

import torch
import torch.nn.functional as F
from torch import nn

from ccnet_tpu_torch.ops import abn_eval
from ccnet_tpu_torch.parallel import spatial
from ccnet_tpu_torch.parallel.distributed import world
from ccnet_tpu_torch.parallel.mesh import all_reduce_sum, rank_slice
from ccnet_tpu_torch.utils import trace


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
        plan = spatial.current()
        if plan is None or (self.kernel_size[0] == 1 and self.padding[0] == 0):
            return self._conv_forward(x.to(dt), self.weight.to(dt), bias)
        x, = plan.halo([x.to(dt)], self.kernel_size[0], self.dilation[0], self.stride[0],
                       self.padding[0])
        return F.conv2d(x, self.weight.to(dt), bias, self.stride, (0, self.padding[1]),
                        self.dilation, self.groups)


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

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None,
                relu: bool = False) -> torch.Tensor:
        """``act(BN(x) + residual)``: ``act`` is ReLU where ``relu``, else
        the ABN's own activation; no residual where it is None."""
        act = "relu" if relu else self.activation
        if not self.training:
            return self._eval(x, residual, act)
        if spatial.current() is not None:
            raise RuntimeError("a height-sharded forward is inference only: put the model "
                               "in eval mode")
        momentum = 0.0 if getattr(_STATE, "recomputing", False) else self.momentum
        if world()[1] > 1:
            y = _GlobalBatchNorm.apply(x, self.weight, self.bias, self.running_mean,
                                       self.running_var, momentum, self.eps)
        elif x.numel() == x.shape[1]:
            y = self._train_one_value(x, momentum)
        else:
            y = F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                             training=True, momentum=momentum, eps=self.eps)
        return self._finish(y, residual, act)

    def _eval(self, x: torch.Tensor, residual, act: str) -> torch.Tensor:
        if x.device.type != "cuda":
            return self._eval_plain(x, residual, act)
        trace.count("abn.eval.fused")
        return abn_eval.abn_eval(x, self.weight, self.bias, self.running_mean,
                                 self.running_var, self.eps, act, self.slope, residual)

    def _eval_plain(self, x: torch.Tensor, residual, act: str) -> torch.Tensor:
        """Eval mode off the card: the torch expression."""
        trace.count("abn.eval.plain")
        scale = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * scale
        y = x * scale.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
        return self._finish(y, residual, act)

    def _finish(self, y: torch.Tensor, residual, act: str) -> torch.Tensor:
        if residual is not None:
            y = y + residual
        if act == "relu":
            return F.relu(y)
        if act == "leaky_relu":
            return torch.where(y >= 0, y, y * self.slope)
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


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode BN of an NCHW input over the global batch of the ranks.

    Forward: each rank's channel mean ``m_r`` and centred sum of squares
    ``M2_r = Σ (x − m_r)²`` in f32 (two passes: no cancellation), then one
    ``all_reduce`` in f64 of ``n_r·m_r``, ``M2_r + n_r·m_r²`` and ``n_r``
    (Chan et al.'s pairwise combination: in f64 the difference ``Σ(M2_r +
    n_r·m_r²)/n − mean²`` loses nothing an f32 variance holds), so the
    global mean and biased variance are the one-process ones up to f32
    rounding; ``y = (x − mean) · γ · rsqrt(var + eps) + β`` in f32 rounded
    once to x's dtype (as ``F.batch_norm`` rounds the one-process output),
    and the running stats updated from the global count (unbiased
    variance). It keeps only x (in its own dtype) and the per-channel
    statistics for the backward, which reduces ``Σ dy`` and ``Σ dy · x̂``
    over the ranks in one ``all_reduce``: ``dx = γ · rstd · (dy − mean(dy)
    − x̂ · mean(dy · x̂))`` over the global batch. The parameter grads are
    the rank's own sums: the data-parallel wrapper combines them across
    ranks."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, momentum, eps):
        C = x.shape[1]
        count = x.numel() // C
        x32 = x.float()
        local_mean = x32.mean(dim=(0, 2, 3))
        centred = x32 - local_mean[:, None, None]
        m2 = (centred * centred).sum(dim=(0, 2, 3))
        del centred
        m64 = local_mean.double()
        stats = all_reduce_sum(torch.cat([count * m64, m2.double() + count * m64 * m64,
                                          m64.new_full((1,), count)]), "bn")
        n = stats[2 * C]
        mean64 = stats[:C] / n
        var64 = (stats[C:2 * C] / n - mean64 * mean64).clamp_min(0.0)
        mean, var, n = mean64.float(), var64.float(), n.float()
        rstd = torch.rsqrt(var + eps)
        with torch.no_grad():
            unbiased = var * (n / (n - 1).clamp_min(1.0))
            running_mean.mul_(1 - momentum).add_(momentum * mean)
            running_var.mul_(1 - momentum).add_(momentum * unbiased)
        scale = weight * rstd
        ctx.save_for_backward(x, weight, mean, rstd, n, var64 > 0)
        # in f32 and rounded once, as F.batch_norm (the one-process path) does
        return torch.addcmul(bias[:, None, None], x32 - mean[:, None, None],
                             scale[:, None, None]).to(x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd, n, live = ctx.saved_tensors
        C = x.shape[1]
        dy32 = dy.float()
        xhat = (x.float() - mean[:, None, None]) * rstd[:, None, None]
        sum_dy = dy32.sum(dim=(0, 2, 3))
        sum_dy_xhat = (dy32 * xhat).sum(dim=(0, 2, 3))
        sums = all_reduce_sum(torch.cat([sum_dy, sum_dy_xhat]), "bn_grad") / n
        # where the variance is 0 it does not depend on x
        dx = (weight * rstd)[:, None, None] * (
            dy32 - sums[:C, None, None] - xhat * (sums[C:] * live)[:, None, None])
        return dx.to(x.dtype), sum_dy_xhat, sum_dy, None, None, None, None


class Dropout(nn.Dropout):
    """``nn.Dropout``; over N ranks in train mode the mask is the rank's
    slice of the mask one process draws for the global batch: every rank
    draws that mask from the same generator state (the train step seeds it
    from ``(seed, step)``) with the same op on the same shape and dtype, so
    the N-rank step drops what the one-process step drops and scales the
    kept values as ``F.dropout`` does."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rank, size = world()
        if size == 1 or not self.training or self.p == 0.0:
            return super().forward(x)
        mask = F.dropout(x.new_ones((x.shape[0] * size, *x.shape[1:])), self.p, True)
        keep = rank_slice(mask, rank, size) != 0
        return (x.float() * keep * (1.0 / (1.0 - self.p))).to(x.dtype)
