"""Eval-mode activated batch norm in one pass through a hand-written CUDA kernel.

:func:`abn_eval` launches ``ccnet_tpu_torch/csrc/abn_eval.cu``:
``y = act(x·scale[c] + shift[c] (+ r))`` with ``scale = w·rsqrt(var + eps)``
and ``shift = b − mean·scale`` from the running statistics, in f32, rounded
once to x's dtype; ``act`` is identity, ReLU or leaky-ReLU(slope). It
replaces no TPU kernel (XLA fuses these on the TPU); in eager PyTorch they
were four passes over memory, BN's broadcast mul and add, the residual add
and the activation.

It takes every 4-D bf16 or f32 CUDA tensor of fewer than 2**31 values and
at most the kernel's 6144 channels, and gives y in x's layout. The kernel
reads contiguous NCHW or channels_last, 16-byte aligned: any other x (a
view, an offset) is copied into NCHW first, and a residual into x's layout.
Other dtypes, a residual of another shape, dtype or device, and parameters
that are not f32 ``(C,)`` on x's device raise. Where autograd needs the
result (an eval-mode model run without ``torch.no_grad``), the kernel's
forward is a Function whose backward, :func:`abn_eval_backward`, is plain
torch: the kernel has none, and eval-mode BN trains nothing on the main path.

:func:`abn_eval_reference` is the kernel's arithmetic in f32, unrounded.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

# launches of the kernel made by this process, and those of them with a
# residual; callers may reset them to 0
LAUNCHES = {"abn_eval": 0, "abn_eval_residual": 0}

ACTIVATIONS = {"identity": 0, "relu": 1, "leaky_relu": 2}
_DTYPES = (torch.bfloat16, torch.float32)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def abn_eval_reference(x: torch.Tensor, weight, bias, mean, var, eps: float, act: str,
                       slope: float = 0.01, residual=None) -> torch.Tensor:
    """The kernel's function in f32, unrounded: ``act(x·scale + shift (+ r))``."""
    scale = weight.float() * torch.rsqrt(var.float() + eps)
    shift = bias.float() - mean.float() * scale
    y = x.float() * scale[:, None, None] + shift[:, None, None]
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return torch.where(y >= 0, y, y * slope)
    return y


def abn_eval_backward(dy: torch.Tensor, x: torch.Tensor, residual, weight, bias, mean, var,
                      eps: float, act: str, slope: float = 0.01):
    """The gradients ``(dx, dresidual, dweight, dbias)`` of
    :func:`abn_eval_reference` at ``dy``, in f32 (dx and dresidual rounded to
    their inputs' dtypes; dresidual None without a residual). The activation's
    slope is taken at the recomputed pre-activation: ReLU passes where it is
    positive, leaky-ReLU where it is not negative, as torch's own ops do."""
    rstd = torch.rsqrt(var.float() + eps)
    scale = weight.float() * rstd
    g = dy.float()
    if act != "identity":
        pre = abn_eval_reference(x, weight, bias, mean, var, eps, "identity",
                                 residual=residual)
        g = g * (pre > 0) if act == "relu" else torch.where(pre >= 0, g, g * slope)
    dx = (g * scale[:, None, None]).to(x.dtype)
    dres = None if residual is None else g.to(residual.dtype)
    xhat = (x.float() - mean.float()[:, None, None]) * rstd[:, None, None]
    return dx, dres, (g * xhat).sum((0, 2, 3)), g.sum((0, 2, 3))


_LIB = None  # csrc/abn_eval.cu, loaded and declared once


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from ccnet_tpu_torch.ops._build import load_library

        lib = load_library("abn_eval")
        lib.abn_eval.argtypes = [_P] * 7 + [_F, _F, _L] + [_I] * 5 + [_P]
        lib.abn_eval.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _dense(t: torch.Tensor, fmt) -> torch.Tensor:
    """``t``, or a copy of it, contiguous in ``fmt`` and 16-byte aligned."""
    if t.is_contiguous(memory_format=fmt) and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=fmt)


def _launch(x, residual, weight, bias, mean, var, eps, act, slope) -> torch.Tensor:
    """One launch on x's card, current stream; x and the residual dense."""
    device = x.get_device()
    if device != torch.cuda.current_device():
        with torch.cuda.device(device):
            return _launch(x, residual, weight, bias, mean, var, eps, act, slope)
    y = torch.empty_like(x)
    nchw = x.is_contiguous()
    rc = _lib().abn_eval(
        x.data_ptr(), 0 if residual is None else residual.data_ptr(), y.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), mean.data_ptr(), var.data_ptr(), eps, slope,
        x.numel(), x.shape[1], x.shape[2] * x.shape[3] if nchw else 1,
        int(x.dtype == torch.bfloat16), int(not nchw), ACTIVATIONS[act],
        torch._C._cuda_getCurrentRawStream(device))
    if rc != 0:
        raise RuntimeError(f"abn_eval launch failed: CUDA error {rc} for x "
                           f"{tuple(x.shape)} {x.dtype} (cudaErrorInvalidValue, 1: more "
                           f"channels than the kernel's table holds)")
    LAUNCHES["abn_eval"] += 1
    LAUNCHES["abn_eval_residual"] += residual is not None
    return y


class _ABNEvalFn(torch.autograd.Function):
    """The kernel's forward, :func:`abn_eval_backward`'s backward."""

    @staticmethod
    def forward(ctx, x, residual, weight, bias, mean, var, eps, act, slope):
        ctx.save_for_backward(x, residual, weight, bias, mean, var)
        ctx.args = eps, act, slope
        return _launch(x, residual, weight, bias, mean, var, eps, act, slope)

    @staticmethod
    def backward(ctx, dy):
        x, residual, weight, bias, mean, var = ctx.saved_tensors
        dx, dres, dw, db = abn_eval_backward(dy, x, residual, weight, bias, mean, var,
                                             *ctx.args)
        return dx, dres, dw, db, None, None, None, None, None


def abn_eval(x: torch.Tensor, weight, bias, mean, var, eps: float, act: str,
             slope: float = 0.01, residual=None) -> torch.Tensor:
    """``act(x·scale[c] + shift[c] (+ residual))`` of a CUDA tensor through
    the kernel, in x's dtype and layout: see the module's note for what it
    takes, copies and refuses (ValueError)."""
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}; have {sorted(ACTIVATIONS)}")
    if (x.device.type != "cuda" or x.dtype not in _DTYPES or x.dim() != 4
            or x.numel() >= 2**31):
        raise ValueError(f"abn_eval takes a 4-D bf16 or f32 CUDA tensor of fewer than 2**31 "
                         f"values, not {tuple(x.shape)} {x.dtype} on {x.device}")
    C = x.shape[1]
    for p in (weight, bias, mean, var):
        if (p.dtype != torch.float32 or p.device != x.device or p.shape != (C,)
                or not p.is_contiguous()):
            raise ValueError(f"abn_eval's parameters are f32 contiguous ({C},) on {x.device}, "
                             f"not {tuple(p.shape)} {p.dtype} on {p.device}")
    if residual is not None and (residual.shape != x.shape or residual.dtype != x.dtype
                                 or residual.device != x.device):
        raise ValueError(f"abn_eval's residual is of x's shape, dtype and device: "
                         f"{tuple(residual.shape)} {residual.dtype} on {residual.device}")
    if x.numel() == 0:
        return torch.empty_like(x)
    fmt = (torch.channels_last if not x.is_contiguous()
           and x.is_contiguous(memory_format=torch.channels_last) else torch.contiguous_format)
    x = _dense(x, fmt)
    residual = None if residual is None else _dense(residual, fmt)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, residual, weight, bias)):
        return _ABNEvalFn.apply(x, residual, weight, bias, mean, var, eps, act, slope)
    return _launch(x, residual, weight, bias, mean, var, eps, act, slope)
