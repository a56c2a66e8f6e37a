"""Operations and bytes of DANet's position attention, counted from the
op's own inputs and outputs (``PositionAttentionFn``: q, k ``(B, N, Cq)``,
v and out ``(B, N, Cv)``), so the same work is read whatever route
implements it. The bound is :func:`benchmark.work.ops.bound_s`'s."""

from __future__ import annotations

from benchmark.work.ops import bound_s

_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


def pam_flops(shape, fwd: bool) -> float:
    """FLOPs of one call at (B, N, Cq, Cv): B·N² pairs, the forward's q·kᵀ
    and p·v (2·Cq + 2·Cv a pair), the backward's dq, dk and the recomputed
    q·kᵀ (3 · 2·Cq) and g·vᵀ, dv (2 · 2·Cv)."""
    B, N, Cq, Cv = shape
    return B * N * N * (2 * (Cq + Cv) if fwd else 2 * (3 * Cq + 2 * Cv))


def pam_bound_s(shape, fwd: bool, dtype: str) -> float:
    """One call at the value dtype: the forward reads q, k, v and writes out
    and the rows' f32 log-sum-exp; the backward reads q, k, v, out and g and
    writes dq, dk, dv."""
    B, N, Cq, Cv = shape
    size = _ITEMSIZE[dtype]
    if fwd:
        nbytes = B * N * ((2 * Cq + 2 * Cv) * size + 4)
    else:
        nbytes = B * N * (2 * Cq + 3 * Cv + 2 * Cq + Cv) * size
    return bound_s(nbytes, pam_flops(shape, fwd), dtype)
