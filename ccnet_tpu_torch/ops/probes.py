"""The layout probes P1–P5 through the hand-written CUDA kernels.

Counterpart of the Pallas kernels of ``scripts/probe_mosaic.py``, which ask
what a fused criss-cross attention kernel needs of the compiler. The kernels
live in ``ccnet_tpu_torch/csrc/probes.cu``; each wrapper here has a plain
PyTorch version beside it and a launch count in :data:`LAUNCHES`:

* P1 :func:`mid_batch_dot` replaces ``_mid_batch_kernel``: ``(H, T, C)`` q, k
  bf16 → ``e (T, H, H)`` f32, ``e[t, h, g] = Σ_c q[h, t, c]·k[g, t, c]``.
* P2 :func:`swap_leading` replaces ``_swap_kernel``: ``(A, B, C)`` →
  ``(B, A, C)`` bf16.
* P3 :func:`scale_ragged` replaces ``_tile_kernel``: ``2·x`` over ``(M, N)``
  f32 (the TPU kernel's 16-row grid leaves a ragged tail at M = 97).
* P4 :func:`mid_batch_dot_4d` replaces ``_mid_batch4_kernel``: P1 on the
  columns of NHWC ``(B, H, W, C)`` q, k, read in place → ``(B, W, H, H)``
  f32, the column-path logits of K1.
* P5 :func:`store_transposed` replaces ``_store_transposed_kernel``: NHWC
  ``(B, H, W, C)`` → column-major ``(B, W, H, C)`` bf16.

P1/P4 share one kernel, and P2/P5 another. The TPU kernels pad P4's and P5's
outputs to a multiple of the 16-column tile; those rows are a block artefact
that nothing reads, and the port returns only the ``W`` used columns.

A CUDA tensor launches the kernel; a CPU tensor takes the plain version. A
wrong dtype, rank or layout raises on either device. Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

# launches of each kernel made by this process; callers may reset them to 0
LAUNCHES = {"mid_batch_dot": 0, "swap_leading": 0, "scale_ragged": 0,
            "mid_batch_dot_4d": 0, "store_transposed": 0}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib():
    from ccnet_tpu_torch.ops._build import load_library

    lib = load_library("probes")
    if not getattr(lib, "_ccnet_bound", False):
        lib.probe_mid_batch_dot.argtypes = [_P, _P, _P, _I, _I, _I, _I, _L, _L, _L, _P]
        lib.probe_mid_batch_dot.restype = ctypes.c_int
        lib.probe_swap_leading.argtypes = [_P, _P, _I, _I, _I, _I, _P]
        lib.probe_swap_leading.restype = ctypes.c_int
        lib.probe_scale.argtypes = [_P, _P, _L, ctypes.c_float, _P]
        lib.probe_scale.restype = ctypes.c_int
        lib._ccnet_bound = True
    return lib


def _check(name: str, x: torch.Tensor, ndim: int, dtype: torch.dtype) -> str:
    """Validate one operand; return the route, ``"cpu"`` or ``"cuda"``."""
    if x.dim() != ndim or x.dtype != dtype or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"{name} wants a non-empty contiguous {ndim}-D {dtype} tensor, got "
                         f"{tuple(x.shape)} {x.dtype} (contiguous: {x.is_contiguous()})")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type


def _check_pair(name: str, q: torch.Tensor, k: torch.Tensor, ndim: int) -> str:
    route = _check(name, q, ndim, torch.bfloat16)
    _check(name, k, ndim, torch.bfloat16)
    if q.shape != k.shape or q.device != k.device:
        raise ValueError(f"{name}: q {tuple(q.shape)} on {q.device} and k "
                         f"{tuple(k.shape)} on {k.device} differ")
    return route


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def _stream():
    return _P(torch.cuda.current_stream().cuda_stream)


# ------------------------------------------------------------ plain versions


def mid_batch_dot_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("htc,gtc->thg", q.float(), k.float())


def mid_batch_dot_4d_plain(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhwc,bgwc->bwhg", q.float(), k.float())


def swap_leading_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(0, 1).contiguous()


def store_transposed_plain(x: torch.Tensor) -> torch.Tensor:
    return x.transpose(1, 2).contiguous()


def scale_ragged_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


# ------------------------------------------------------------------ kernels


def _dot(name: str, q: torch.Tensor, k: torch.Tensor, N: int, T: int, H: int, C: int,
         strides) -> torch.Tensor:
    with torch.cuda.device(q.device):
        e = torch.empty((N, T, H, H), device=q.device, dtype=torch.float32)
        rc = _lib().probe_mid_batch_dot(_P(q.data_ptr()), _P(k.data_ptr()), _P(e.data_ptr()),
                                        N, T, H, C, *strides, _stream())
        _raise_on(rc, name)
    return e


def mid_batch_dot(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """P1: ``(H, T, C)`` bf16 q, k → ``(T, H, H)`` f32."""
    if _check_pair("mid_batch_dot", q, k, 3) == "cpu":
        return mid_batch_dot_plain(q, k)
    H, T, C = q.shape
    return _dot("mid_batch_dot", q, k, 1, T, H, C, (0, T * C, C))[0]


def mid_batch_dot_4d(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """P4: NHWC ``(B, H, W, C)`` bf16 q, k → ``(B, W, H, H)`` f32, the
    logits of each column's H pixels (columns read in place)."""
    if _check_pair("mid_batch_dot_4d", q, k, 4) == "cpu":
        return mid_batch_dot_4d_plain(q, k)
    B, H, W, C = q.shape
    return _dot("mid_batch_dot_4d", q, k, B, W, H, C, (H * W * C, W * C, C))


def _swap(name: str, x: torch.Tensor, N: int, A: int, Bd: int) -> torch.Tensor:
    row_bytes = x.shape[-1] * x.element_size()
    if row_bytes % 16 or x.data_ptr() % 16:
        raise ValueError(f"{name}: rows of {row_bytes} bytes at {x.data_ptr():#x}; the "
                         f"kernel moves 16-byte chunks (C % 8 == 0, 16-byte aligned)")
    with torch.cuda.device(x.device):
        y = torch.empty((N, Bd, A, x.shape[-1]), device=x.device, dtype=x.dtype)
        rc = _lib().probe_swap_leading(_P(x.data_ptr()), _P(y.data_ptr()), N, A, Bd,
                                       row_bytes, _stream())
        _raise_on(rc, name)
    return y


def swap_leading(x: torch.Tensor) -> torch.Tensor:
    """P2: ``(A, B, C)`` → ``(B, A, C)`` bf16."""
    if _check("swap_leading", x, 3, torch.bfloat16) == "cpu":
        return swap_leading_plain(x)
    A, Bd, _ = x.shape
    return _swap("swap_leading", x, 1, A, Bd)[0]


def store_transposed(x: torch.Tensor) -> torch.Tensor:
    """P5: NHWC ``(B, H, W, C)`` → column-major ``(B, W, H, C)`` bf16."""
    if _check("store_transposed", x, 4, torch.bfloat16) == "cpu":
        return store_transposed_plain(x)
    B, H, W, _ = x.shape
    return _swap("store_transposed", x, B, H, W)


def scale_ragged(x: torch.Tensor) -> torch.Tensor:
    """P3: ``2·x`` over ``(M, N)`` f32."""
    if _check("scale_ragged", x, 2, torch.float32) == "cpu":
        return scale_ragged_plain(x)
    with torch.cuda.device(x.device):
        y = torch.empty_like(x)
        rc = _lib().probe_scale(_P(x.data_ptr()), _P(y.data_ptr()), x.numel(), 2.0, _stream())
        _raise_on(rc, "scale_ragged")
    return y
