"""Operations and bytes of the hand-written ops, counted from each op's own
inputs and outputs, so the same work is read whatever implements it.

A bound is the least time the card could take: the larger of the bytes over
the HBM rate and the operations over the peak rate of their dtype. Bytes
count each input read once and each output written once.
"""

from __future__ import annotations

from benchmark.work.peaks import FLOPS, HBM_BYTES_PER_S


def bound_s(nbytes: float, flops: float, dtype: str) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / FLOPS[dtype])


def cca_flops(shape, fwd: bool, path: str) -> float:
    """FLOPs of one criss-cross attention path at (B, H, W, Cq, Cv): the
    forward's q·kᵀ and p·v (2·Cq + 2·Cv per pair), the backward's
    recomputed q·kᵀ, dq, dk (3 · 2·Cq) and g·vᵀ, dv (2 · 2·Cv); a path has
    B·W·H² (columns) or B·H·W² (rows) pairs."""
    B, H, W, Cq, Cv = shape
    pairs = B * W * H * H if path == "col" else B * H * W * W
    return pairs * (2 * (Cq + Cv) if fwd else 2 * (3 * Cq + 2 * Cv))


def cca_bound_s(shape, fwd: bool, itemsize: int, dtype: str) -> float:
    """One attention call, both paths: forward q, k, v in and out out;
    backward q, k, v, g in and dq, dk, dv out, at the value dtype."""
    B, H, W, Cq, Cv = shape
    px = B * H * W
    if fwd:
        nbytes = px * (2 * Cq + Cv + Cv) * itemsize
    else:
        nbytes = px * (2 * Cq + Cv + Cv + 2 * Cq + Cv) * itemsize
    flops = cca_flops(shape, fwd, "col") + cca_flops(shape, fwd, "row")
    return bound_s(nbytes, flops, dtype)


# per (fine pixel, class): the bilinear upsample (3 lerps, 6) and the
# log-softmax (exp and sum, 2); the backward adds the softmax's gradient and
# the upsample's transpose (6)
NLL_FWD_OPS, NLL_BWD_OPS = 8, 14


def nll_bound_s(logits_shape, labels_shape, fwd: bool) -> float:
    """One upsampled-NLL call: logits (B, C, h, w) f32 and labels (B, H, W)
    int32 in, the per-pixel loss (B, H, W) f32 out; the backward reads the
    logits, the labels and g (B, H, W) f32 and writes dlogits."""
    B, C, h, w = logits_shape
    _, H, W = labels_shape
    coarse, fine = B * C * h * w * 4, B * H * W * 4
    if fwd:
        nbytes, ops = coarse + 2 * fine, B * H * W * C * NLL_FWD_OPS
    else:
        nbytes, ops = 2 * coarse + 2 * fine, B * H * W * C * NLL_BWD_OPS
    return bound_s(nbytes, ops, "float32")
