"""Criss-cross attention through the hand-written CUDA kernels, with its backward.

Counterpart of :mod:`ccnet_tpu.ops.cc_attention_pallas` (``_fwd_impl_natural``,
``_bwd_natural`` and the custom VJP around them). The kernels live in
``ccnet_tpu_torch/csrc/cca_fwd.cu`` and ``csrc/cca_bwd.cu``; each has a
wrapper here and a plain PyTorch version beside it:

* K1 :func:`cca_fwd_col` replaces ``_fwd_col_kernel``: the column path with
  the self slot at −1e9, giving the unnormalised aggregate ``o_col`` (f32)
  and its stats ``m_col, l_col``; plain version :func:`cca_fwd_col_plain`.
* K2 :func:`cca_fwd_row` replaces ``_fwd_row_kernel``: the row path fused
  with the joint-softmax combine, giving ``out`` in v's dtype and the joint
  ``(m, L)`` residuals; plain version :func:`cca_fwd_row_plain`.
* K3 :func:`cca_bwd_col` replaces ``_bwd_col_kernel``: the column path's
  dq, dk, dv (f32) recomputed from ``(q, k, m, L)`` and ``delta``; plain
  version :func:`cca_bwd_col_plain`.
* K4 :func:`cca_bwd_row` replaces ``_bwd_row_kernel``: the row path's grads
  plus K3's, in the input dtype; plain version :func:`cca_bwd_row_plain`.

:class:`CrissCrossAttentionFn` is the ``torch.autograd.Function`` around
them (the JAX package's ``_cca_pallas`` custom VJP): K1 then K2 forward,
``delta = Σ_c out·g`` in plain torch, then K3 and K4 backward.
:func:`criss_cross_attention_cuda` goes through it.

The libraries are built with ``nvcc`` at first use (:mod:`._build`) and
bound with ctypes: every pointer and the stream go as ``c_void_p`` (a bare
Python int would be passed as a 32-bit C int and cut the pointer), every
int as ``c_int``. Launches are asynchronous on the current stream.

Routing is by the tensors' device: CPU tensors take the plain versions and
leave :data:`LAUNCHES` alone; CUDA tensors launch the kernels or raise.
Nothing falls back.

Layout: NHWC contiguous ``(B, H, W, C)``, as the JAX op. The NCHW model
feeds it with ``permute(0, 2, 3, 1).contiguous()`` copies of q, k and v.
"""

from __future__ import annotations

import ctypes

import torch

from ccnet_tpu_torch.ops.cc_attention import NEG_INF

# launches of each kernel made by this process; callers may reset them to 0
LAUNCHES = {"cca_fwd_col": 0, "cca_fwd_row": 0, "cca_bwd_col": 0, "cca_bwd_row": 0}

MAX_CQ = 128  # the kernels stage 48 lines of Cq f32 q/k values in shared memory
MAX_SMEM = 227 * 1024  # dynamic shared memory one block may use on Hopper

_P, _I = ctypes.c_void_p, ctypes.c_int


def _lib():
    from ccnet_tpu_torch.ops._build import load_library

    lib = load_library("cca_fwd")
    if not getattr(lib, "_ccnet_bound", False):
        lib.cca_fwd_col.argtypes = [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.cca_fwd_col.restype = ctypes.c_int
        lib.cca_fwd_row.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _I, _I, _I, _I, _I, _I, _P]
        lib.cca_fwd_row.restype = ctypes.c_int
        lib._ccnet_bound = True
    return lib


def _bwd_lib():
    from ccnet_tpu_torch.ops._build import load_library

    lib = load_library("cca_bwd")
    if not getattr(lib, "_ccnet_bound", False):
        lib.cca_bwd_col.argtypes = [_P] * 12 + [_I] * 6 + [_P]
        lib.cca_bwd_col.restype = ctypes.c_int
        lib.cca_bwd_row.argtypes = [_P] * 15 + [_I] * 6 + [_P]
        lib.cca_bwd_row.restype = ctypes.c_int
        lib.cca_bwd_query_smem_bytes.argtypes = [_I, _I]
        lib.cca_bwd_query_smem_bytes.restype = ctypes.c_longlong
        lib._ccnet_bound = True
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """Validate q/k/v; return the route, ``"cpu"`` or ``"cuda"``."""
    if q.dim() != 4 or k.shape != q.shape or v.dim() != 4 or v.shape[:3] != q.shape[:3]:
        raise ValueError(f"criss-cross attention wants q, k (B, H, W, Cq) and v "
                         f"(B, H, W, Cv); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q, k, v on different devices: {q.device}, {k.device}, {v.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must share one dtype, float32 or bfloat16; got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.device.type == "cpu":
        return "cpu"
    if q.device.type != "cuda":
        raise ValueError(f"criss-cross attention kernels: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous NHWC")
    if q.shape[-1] > MAX_CQ:
        raise ValueError(f"Cq={q.shape[-1]} exceeds the kernels' limit of {MAX_CQ}")
    return "cuda"


def _check_like(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {device}; got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if device.type == "cuda" and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_bwd(q, k, v, g, m, L, delta) -> str:
    """Validate the backward's inputs; return the route."""
    route = _check(q, k, v)
    B, H, W, _ = q.shape
    _check_like("g", g, v.shape, q.device, v.dtype)
    for name, t in (("m", m), ("L", L), ("delta", delta)):
        _check_like(name, t, (B, H, W), q.device)
    return route


# ------------------------------------------------------------ plain versions


def cca_fwd_col_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Column path in plain torch: ``(o_col f32, m_col, l_col)``."""
    H = q.shape[1]
    e = torch.einsum("bhwc,bkwc->bhwk", q.float(), k.float())
    diag = torch.eye(H, dtype=torch.bool, device=q.device)[:, None, :]
    e = e.masked_fill(diag[None], NEG_INF)
    m = e.amax(dim=-1)
    p = torch.exp(e - m[..., None])
    o = torch.einsum("bhwk,bkwc->bhwc", p, v.float())
    return o, m, p.sum(dim=-1)


def cca_fwd_row_plain(q, k, v, o_col, m_col, l_col):
    """Row path + joint-softmax combine in plain torch: ``(out, m, L)``."""
    e = torch.einsum("bhwc,bhvc->bhwv", q.float(), k.float())
    m_r = e.amax(dim=-1)
    p = torch.exp(e - m_r[..., None])
    o_r = torch.einsum("bhwv,bhvc->bhwc", p, v.float())
    m = torch.maximum(m_col, m_r)
    a_c, a_r = torch.exp(m_col - m), torch.exp(m_r - m)
    L = l_col * a_c + p.sum(dim=-1) * a_r
    out = (o_col * a_c[..., None] + o_r * a_r[..., None]) / L[..., None]
    return out.to(v.dtype), m, L


def cca_bwd_col_plain(q, k, v, g, m, L, delta):
    """Column-path backward in plain torch: ``(dq_c, dk_c, dv_c)`` f32.

    ``p = exp(e − m) / L`` with the joint stats (the self slot's −1e9 gives
    p = 0), ``de = p·(g·vᵀ − delta)``, ``dq = de·k``, ``dk = deᵀ·q``,
    ``dv = pᵀ·g`` over each column."""
    H = q.shape[1]
    e = torch.einsum("bhwc,bkwc->bhwk", q.float(), k.float())
    diag = torch.eye(H, dtype=torch.bool, device=q.device)[:, None, :]
    e = e.masked_fill(diag[None], NEG_INF)
    p = torch.exp(e - m[..., None]) / L[..., None]
    dp = torch.einsum("bhwc,bkwc->bhwk", g.float(), v.float())
    de = p * (dp - delta[..., None])
    return (torch.einsum("bhwk,bkwc->bhwc", de, k.float()),
            torch.einsum("bhwk,bhwc->bkwc", de, q.float()),
            torch.einsum("bhwk,bhwc->bkwc", p, g.float()))


def cca_bwd_row_plain(q, k, v, g, m, L, delta, dq_c, dk_c, dv_c):
    """Row-path backward plus the column grads, in plain torch:
    ``(dq, dk, dv)`` in the input dtype."""
    e = torch.einsum("bhwc,bhvc->bhwv", q.float(), k.float())
    p = torch.exp(e - m[..., None]) / L[..., None]
    dp = torch.einsum("bhwc,bhvc->bhwv", g.float(), v.float())
    de = p * (dp - delta[..., None])
    dq = torch.einsum("bhwv,bhvc->bhwc", de, k.float()) + dq_c
    dk = torch.einsum("bhwv,bhwc->bhvc", de, q.float()) + dk_c
    dv = torch.einsum("bhwv,bhwc->bhvc", p, g.float()) + dv_c
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ------------------------------------------------------------------ kernels


def cca_fwd_col(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """K1: ``(o_col (B,H,W,Cv) f32, m_col (B,H,W) f32, l_col (B,H,W) f32)``."""
    if _check(q, k, v) == "cpu":
        return cca_fwd_col_plain(q, k, v)
    B, H, W, Cq = q.shape
    Cv = v.shape[-1]
    lib = _lib()
    with torch.cuda.device(q.device):
        f32 = dict(device=q.device, dtype=torch.float32)
        o_col = torch.empty((B, H, W, Cv), **f32)
        m_col = torch.empty((B, H, W), **f32)
        l_col = torch.empty((B, H, W), **f32)
        rc = lib.cca_fwd_col(
            _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()), _P(o_col.data_ptr()),
            _P(m_col.data_ptr()), _P(l_col.data_ptr()), B, H, W, Cq, Cv,
            int(q.dtype == torch.bfloat16), _P(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"cca_fwd_col launch failed: CUDA error {rc}")
        LAUNCHES["cca_fwd_col"] += 1
    return o_col, m_col, l_col


def cca_fwd_row(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o_col: torch.Tensor,
                m_col: torch.Tensor, l_col: torch.Tensor):
    """K2: ``(out (B,H,W,Cv) in v's dtype, m (B,H,W) f32, L (B,H,W) f32)``."""
    route = _check(q, k, v)
    B, H, W, Cq = q.shape
    Cv = v.shape[-1]
    _check_like("o_col", o_col, (B, H, W, Cv), q.device)
    _check_like("m_col", m_col, (B, H, W), q.device)
    _check_like("l_col", l_col, (B, H, W), q.device)
    if route == "cpu":
        return cca_fwd_row_plain(q, k, v, o_col, m_col, l_col)
    lib = _lib()
    with torch.cuda.device(q.device):
        f32 = dict(device=q.device, dtype=torch.float32)
        out = torch.empty_like(v)
        m = torch.empty((B, H, W), **f32)
        L = torch.empty((B, H, W), **f32)
        rc = lib.cca_fwd_row(
            _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()), _P(o_col.data_ptr()),
            _P(m_col.data_ptr()), _P(l_col.data_ptr()), _P(out.data_ptr()),
            _P(m.data_ptr()), _P(L.data_ptr()), B, H, W, Cq, Cv,
            int(q.dtype == torch.bfloat16), _P(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise RuntimeError(f"cca_fwd_row launch failed: CUDA error {rc}")
        LAUNCHES["cca_fwd_row"] += 1
    return out, m, L


def _bwd_launch(name, q, k, v, g, m, L, delta, extra_in, outs):
    """Launch K3 or K4 with freshly allocated P/DE scratch of the path."""
    B, H, W, Cq = q.shape
    Cv = v.shape[-1]
    lib = _bwd_lib()
    smem = lib.cca_bwd_query_smem_bytes(Cq, Cv)
    if smem > MAX_SMEM:
        raise ValueError(f"{name}: Cv={Cv} needs {smem} B of shared memory, over {MAX_SMEM}")
    n = H if name == "cca_bwd_col" else W
    P = torch.empty((B * H * W * n,), device=q.device, dtype=torch.float32)
    DE = torch.empty_like(P)
    ptrs = [t.data_ptr() for t in (q, k, v, g, m, L, delta, P, DE, *extra_in, *outs)]
    rc = getattr(lib, name)(*map(_P, ptrs), B, H, W, Cq, Cv, int(q.dtype == torch.bfloat16),
                            _P(torch.cuda.current_stream().cuda_stream))
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    LAUNCHES[name] += 1


def cca_bwd_col(q, k, v, g, m, L, delta):
    """K3: column-path ``(dq_c, dk_c, dv_c)``, f32 ``(B, H, W, C)``.

    ``g`` is the output grad in v's dtype; ``m``, ``L`` the joint stats of
    the forward; ``delta = Σ_c out·g``, all ``(B, H, W)`` f32."""
    if _check_bwd(q, k, v, g, m, L, delta) == "cpu":
        return cca_bwd_col_plain(q, k, v, g, m, L, delta)
    with torch.cuda.device(q.device):
        outs = [torch.empty(t.shape, device=q.device, dtype=torch.float32) for t in (q, k, v)]
        _bwd_launch("cca_bwd_col", q, k, v, g, m, L, delta, (), outs)
    return tuple(outs)


def cca_bwd_row(q, k, v, g, m, L, delta, dq_c, dk_c, dv_c):
    """K4: row-path grads plus K3's ``(dq_c, dk_c, dv_c)``: the final
    ``(dq, dk, dv)`` in the input dtype."""
    route = _check_bwd(q, k, v, g, m, L, delta)
    for name, t, ref in (("dq_c", dq_c, q), ("dk_c", dk_c, k), ("dv_c", dv_c, v)):
        _check_like(name, t, ref.shape, q.device)
    if route == "cpu":
        return cca_bwd_row_plain(q, k, v, g, m, L, delta, dq_c, dk_c, dv_c)
    with torch.cuda.device(q.device):
        outs = [torch.empty_like(t) for t in (q, k, v)]
        _bwd_launch("cca_bwd_row", q, k, v, g, m, L, delta, (dq_c, dk_c, dv_c), outs)
    return tuple(outs)


class CrissCrossAttentionFn(torch.autograd.Function):
    """Criss-cross attention with the kernels' backward: forward K1 → K2,
    saving ``(q, k, v, out, m, L)``; backward ``delta = Σ_c out·g`` in plain
    torch (as ``_cca_bwd`` does), then K3 → K4. Returns ``(out, m, L)``;
    ``m`` and ``L`` are not differentiable. On CPU tensors every step takes
    its plain version."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, m, L = cca_fwd_row(q, k, v, *cca_fwd_col(q, k, v))
        ctx.save_for_backward(q, k, v, out, m, L)
        ctx.mark_non_differentiable(m, L)
        return out, m, L

    @staticmethod
    def backward(ctx, g, _gm, _gL):
        q, k, v, out, m, L = ctx.saved_tensors
        g = g.to(v.dtype).contiguous()
        delta = (g.float() * out.float()).sum(dim=-1)
        grads = cca_bwd_row(q, k, v, g, m, L, delta, *cca_bwd_col(q, k, v, g, m, L, delta))
        return grads


def criss_cross_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """Fused criss-cross attention, K1 then K2, differentiable through K3
    and K4 (:class:`CrissCrossAttentionFn`): ``(out, m, L)``.

    q, k: (B, H, W, Cq); v: (B, H, W, Cv); NHWC, one dtype (f32 or bf16).
    ``out`` (B, H, W, Cv) is in v's dtype; ``m``, ``L`` are (B, H, W) f32,
    the joint-softmax row max and sum. Same semantics as
    :func:`ccnet_tpu_torch.ops.cc_attention.criss_cross_attention`.
    """
    return CrissCrossAttentionFn.apply(q, k, v)
