"""Fused bilinear-upsample + NLL through the hand-written CUDA kernels.

Counterpart of :mod:`ccnet_tpu.ops.upsampled_ce`. The training loss takes
the cross-entropy of OS-8 logits upsampled (align_corners=True) to the label
size; done literally that builds a ``(B, C, 769, 769)`` f32 tensor and its
softmax. The kernels of ``ccnet_tpu_torch/csrc/upsampled_ce.cu`` never build
it; each has a wrapper here and a plain PyTorch version beside it:

* K5 :func:`upsampled_nll_fwd` replaces ``_fwd_kernel``: the per-pixel NLL;
  plain version :func:`upsampled_nll_reference`.
* K6 :func:`upsampled_nll_bwd` replaces ``_bwd_kernel``: the coarse-logit
  gradient for an upstream grad ``g``; plain version
  :func:`upsampled_nll_bwd_plain` (autograd of the reference).

:class:`UpsampledNLLFn` is the ``torch.autograd.Function`` of the JAX
package's ``upsampled_nll`` custom VJP: K5 forward, K6 backward, no grad
to the labels. The JAX package's GSPMD wrappers (``_def_batch_partition``,
``_partitioned_*``) and its interpret/partition switches are not carried
over: routing is by the tensors' device, CPU tensors take the plain
versions and CUDA tensors launch the kernels or raise.

Layout: logits NCHW ``(B, C, h, w)`` f32 as the model emits them (the JAX
op takes NHWC); labels ``(B, H, W)`` with ``H = (h−1)·r + 1`` and
``W = (w−1)·r + 1`` for one integer ratio ``r``; on the card int32 or uint8.
Labels outside ``[0, C)`` (ignore 255) give nll 0 and no gradient.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

# launches of each kernel made by this process; callers may reset them to 0
LAUNCHES = {"upsampled_nll_fwd": 0, "upsampled_nll_bwd": 0}

MAX_C = 32  # the kernels keep one pixel's class values in registers
_LABEL_BYTES = {torch.int32: 4, torch.uint8: 1}
_P, _I = ctypes.c_void_p, ctypes.c_int


def integer_upsample_ratio(in_size: int, out_size: int):
    """r with out == (in−1)·r + 1, or None."""
    if in_size > 1 and out_size > in_size and (out_size - 1) % (in_size - 1) == 0:
        return (out_size - 1) // (in_size - 1)
    return None


def interp_matrix(w: int, W: int, r: int) -> np.ndarray:
    """(w, W) align-corners weights: u[:, x] = Σ_x0 M[x0, x] · L[:, x0].

    The JAX package's ``_interp_matrix``; the kernels compute the same two
    taps per column (weights in double, rounded to f32)."""
    M = np.zeros((w, W), np.float32)
    for x in range(W):
        lo, frac = divmod(x, r)
        if lo >= w - 1:
            M[w - 1, x] += 1.0
        else:
            f = frac / r
            M[lo, x] += 1.0 - f
            M[lo + 1, x] += f
    return M


def upsampled_nll_reference(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Plain torch: per-pixel NLL of the align-corners upsampled logits, f32.

    logits ``(B, C, h, w)``, labels ``(B, H, W)`` of any integer dtype;
    labels outside ``[0, C)`` give 0. Differentiable in the logits."""
    C = logits.shape[1]
    u = F.interpolate(logits.float(), size=tuple(labels.shape[1:]), mode="bilinear",
                      align_corners=True)
    logp = torch.log_softmax(u, dim=1)
    lab = labels.long()
    valid = (lab >= 0) & (lab < C)
    picked = logp.gather(1, torch.where(valid, lab, 0)[:, None])[:, 0]
    return torch.where(valid, -picked, torch.zeros_like(picked))


def upsampled_nll_bwd_plain(logits, labels, g):
    """Plain torch: the logits' gradient of ``Σ g · upsampled_nll``."""
    with torch.enable_grad():
        x = logits.detach().float().requires_grad_(True)
        (grad,) = torch.autograd.grad(upsampled_nll_reference(x, labels), x, g.float())
    return grad


def _check(logits: torch.Tensor, labels: torch.Tensor) -> tuple:
    """Validate the shapes; return ``(route, r)``."""
    if logits.dim() != 4 or labels.dim() != 3 or labels.shape[0] != logits.shape[0]:
        raise ValueError(f"upsampled NLL wants logits (B, C, h, w) and labels (B, H, W); "
                         f"got {tuple(logits.shape)}, {tuple(labels.shape)}")
    if logits.device != labels.device:
        raise ValueError(f"logits on {logits.device}, labels on {labels.device}")
    h, w = logits.shape[2:]
    H, W = labels.shape[1:]
    r = integer_upsample_ratio(h, H)
    if r is None or r != integer_upsample_ratio(w, W):
        raise ValueError(f"upsampled NLL needs one integer align-corners ratio, got "
                         f"{(h, w)} -> {(H, W)}")
    if logits.device.type == "cpu":
        return "cpu", r
    if logits.device.type != "cuda":
        raise ValueError(f"upsampled NLL kernels: unsupported device {logits.device}")
    if logits.dtype != torch.float32 or not logits.is_contiguous():
        raise TypeError("logits must be contiguous float32 on the card")
    if labels.dtype not in _LABEL_BYTES or not labels.is_contiguous():
        raise TypeError(f"labels must be contiguous int32 or uint8 on the card, got {labels.dtype}")
    if logits.shape[1] > MAX_C:
        raise ValueError(f"C={logits.shape[1]} exceeds the kernels' limit of {MAX_C}")
    return "cuda", r


def _lib():
    from ccnet_tpu_torch.ops._build import load_library

    lib = load_library("upsampled_ce")
    if not getattr(lib, "_ccnet_bound", False):
        lib.upsampled_nll_fwd.argtypes = [_P, _P, _P] + [_I] * 8 + [_P]
        lib.upsampled_nll_fwd.restype = ctypes.c_int
        lib.upsampled_nll_bwd.argtypes = [_P, _P, _P, _P] + [_I] * 8 + [_P]
        lib.upsampled_nll_bwd.restype = ctypes.c_int
        lib._ccnet_bound = True
    return lib


def _dims(logits, labels, r) -> list:
    B, C, h, w = logits.shape
    return [B, C, h, w, labels.shape[1], labels.shape[2], r, _LABEL_BYTES[labels.dtype]]


def upsampled_nll_fwd(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """K5: ``(B, H, W)`` f32 per-pixel NLL of the upsampled logits."""
    route, r = _check(logits, labels)
    if route == "cpu":
        return upsampled_nll_reference(logits, labels)
    with torch.cuda.device(logits.device):
        nll = torch.empty(labels.shape, device=logits.device, dtype=torch.float32)
        rc = _lib().upsampled_nll_fwd(
            _P(logits.data_ptr()), _P(labels.data_ptr()), _P(nll.data_ptr()),
            *_dims(logits, labels, r), _P(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"upsampled_nll_fwd launch failed: CUDA error {rc}")
        LAUNCHES["upsampled_nll_fwd"] += 1
    return nll


def upsampled_nll_bwd(logits: torch.Tensor, labels: torch.Tensor,
                      g: torch.Tensor) -> torch.Tensor:
    """K6: ``(B, C, h, w)`` f32 gradient of ``Σ g · nll`` in the logits."""
    route, r = _check(logits, labels)
    if tuple(g.shape) != tuple(labels.shape) or g.device != logits.device:
        raise ValueError(f"g must be {tuple(labels.shape)} on {logits.device}; got "
                         f"{tuple(g.shape)} on {g.device}")
    if route == "cpu":
        return upsampled_nll_bwd_plain(logits, labels, g)
    g = g.float().contiguous()
    with torch.cuda.device(logits.device):
        dlogits = torch.empty_like(logits)
        rc = _lib().upsampled_nll_bwd(
            _P(logits.data_ptr()), _P(labels.data_ptr()), _P(g.data_ptr()),
            _P(dlogits.data_ptr()), *_dims(logits, labels, r),
            _P(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"upsampled_nll_bwd launch failed: CUDA error {rc}")
        LAUNCHES["upsampled_nll_bwd"] += 1
    return dlogits


class UpsampledNLLFn(torch.autograd.Function):
    """Per-pixel NLL of upsampled logits: K5 forward, K6 backward, no grad
    to the labels. ``apply(logits (B, C, h, w) f32, labels (B, H, W))``."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return upsampled_nll_fwd(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return upsampled_nll_bwd(logits, labels, g), None
