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

Both kernels work on tiles of :func:`band_tile` coarse columns: K5 one block
per (image, band of r fine rows, tile), K6 one block per (image, coarse row,
tile) over the fine rows and columns that weigh on it, halo included, with
a fixed-order reduction and no atomics (the design is in the source's
note). :func:`upsampled_nll_band_fwd` and :func:`upsampled_nll_band_bwd`
are plain-torch mirrors of that algorithm (the same tiles, halo, skipped
pixels and reduction order) for the CPU tests; no route runs them.

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
BAND_COLS = 256  # fine columns one block of K5/K6 covers, one per thread
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


def band_tile(w: int, r: int) -> int:
    """The coarse columns T of a tile of K5/K6: as many as keep a tile's
    fine columns plus K6's halo (T·r + r − 1) within :data:`BAND_COLS`, then
    evened out over the ``ceil(w / T)`` tiles of a row (97 → 4 tiles of 25,
    25, 25, 22 at r = 8)."""
    tmax = max(1, (BAND_COLS - r + 1) // r)
    n = -(-w // tmax)
    return -(-w // n)


def _width_taps(w: int, W: int, r: int):
    """Per fine column x: ``(x0, x1, w0, w1)`` as long tensors and f32
    weights, the two nonzero entries of :func:`interp_matrix`'s column
    (``x0 == x1 == w − 1``, weights (1, 0), past the last coarse column)."""
    x = np.arange(W)
    lo, frac = x // r, x % r
    last = lo >= w - 1
    f = frac / r
    x0 = np.where(last, w - 1, lo)
    x1 = np.where(last, w - 1, lo + 1)
    w0 = np.where(last, 1.0, 1.0 - f).astype(np.float32)
    w1 = np.where(last, 0.0, f).astype(np.float32)
    return (torch.from_numpy(x0), torch.from_numpy(x1), torch.from_numpy(w0),
            torch.from_numpy(w1))


def _band_u(L, taps, seg: int, wy) -> torch.Tensor:
    """u (B, C, len(wy), columns) of segment ``seg``: coarse rows ``seg``
    and ``seg + 1`` (clamped) of ``L`` (B, C, h, w) lerped across the width
    at the columns whose ``taps`` are given, then across the height at each
    fine row's ``wy``, in f32 as the kernels do."""
    h = L.shape[2]
    x0, x1, w0, w1 = taps
    R0, R1 = (L[:, :, min(k, h - 1)][:, :, x0] * w0 + L[:, :, min(k, h - 1)][:, :, x1] * w1
              for k in (seg, seg + 1))
    return torch.stack([R0 * (1.0 - t) + R1 * t for t in wy], dim=2)


def _wy(y: int, y0: int, r: int) -> torch.Tensor:
    """The height weight of fine row y in the segment starting at y0, as
    the kernels divide it in f32."""
    return torch.tensor(np.float32(y - y0) / np.float32(r))


def upsampled_nll_band_fwd(logits: torch.Tensor, labels: torch.Tensor, T=None) -> torch.Tensor:
    """K5's algorithm in plain torch, tile by tile: for each band k (fine
    rows k·r .. k·r + r − 1) and tile of ``T`` coarse columns (default
    :func:`band_tile`), coarse rows k and k + 1 lerped across the width once
    per fine column, then each fine row's height lerp and softmax. For the
    CPU tests; no route takes it."""
    B, C, h, w = logits.shape
    H, W = labels.shape[1:]
    r = integer_upsample_ratio(h, H)
    T = T or band_tile(w, r)
    L = logits.float()
    taps = _width_taps(w, W, r)
    lab = labels.long()
    nll = torch.zeros((B, H, W), dtype=torch.float32)
    for k in range(h):
        ys = range(k * r, min(k * r + r, H))
        wy = [_wy(y, k * r, r) for y in ys]
        for j0 in range(0, w, T):
            j1 = min(j0 + T, w)
            cols = slice(j0 * r, W if j1 == w else j1 * r)
            u = _band_u(L, [t[cols] for t in taps], k, wy)
            lse = torch.logsumexp(u, dim=1)
            lt = lab[:, ys.start:ys.stop, cols]
            valid = (lt >= 0) & (lt < C)
            ul = u.gather(1, torch.where(valid, lt, 0)[:, None])[:, 0]
            nll[:, ys.start:ys.stop, cols] = torch.where(valid, lse - ul, torch.zeros_like(ul))
    return nll


def upsampled_nll_band_bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
                           T=None) -> torch.Tensor:
    """K6's algorithm in plain torch: for each coarse row k and tile of ``T``
    coarse columns (default :func:`band_tile`), the fine rows (k−1)·r + 1 ..
    k·r + r − 1 (weight wy in segment k − 1, 1 − wy in segment k) over the
    tile's fine columns plus the halo, each column summing
    ``wgt_y · g · (softmax − onehot)`` row by row in order over the pixels
    that count (a label in [0, C), g ≠ 0); then each coarse column j sums its
    fine columns (j−1)·r + 1 .. j·r + r − 1 in order, weighted by
    :func:`interp_matrix`. For the CPU tests; no route takes it."""
    B, C, h, w = logits.shape
    H, W = labels.shape[1:]
    r = integer_upsample_ratio(h, H)
    T = T or band_tile(w, r)
    L = logits.float()
    M = torch.from_numpy(interp_matrix(w, W, r))
    taps = _width_taps(w, W, r)
    lab, gf = labels.long(), g.float()
    out = torch.empty((B, C, h, w), dtype=torch.float32)
    for k in range(h):
        # (segment, its first fine row, fine rows, whether row k is its second)
        segs = [(k - 1, (k - 1) * r, range((k - 1) * r + 1, k * r), True)] if k >= 1 else []
        segs.append((k, k * r, range(k * r, min(k * r + r, H)), False))
        for j0 in range(0, w, T):
            j1 = min(j0 + T, w)
            xs, xe = max(0, (j0 - 1) * r + 1), min(W - 1, (j1 - 1) * r + r - 1)
            cols = slice(xs, xe + 1)
            acc = torch.zeros((B, C, xe - xs + 1), dtype=torch.float32)
            for seg, y0, ys, second in segs:
                for y in ys:
                    wy = _wy(y, y0, r)
                    u = _band_u(L, [t[cols] for t in taps], seg, [wy])[:, :, 0]
                    p = torch.softmax(u, dim=1)
                    lt, gt = lab[:, y, cols], gf[:, y, cols]
                    live = (lt >= 0) & (lt < C) & (gt != 0)
                    onehot = F.one_hot(torch.where(live, lt, 0), C).permute(0, 2, 1)
                    wgt = gt * (wy if second else 1.0 - wy)
                    acc = acc + torch.where(live[:, None], wgt[:, None] * (p - onehot), 0.0)
            for j in range(j0, j1):
                s = torch.zeros((B, C), dtype=torch.float32)
                for x in range(max(0, (j - 1) * r + 1), min(W - 1, j * r + r - 1) + 1):
                    s = s + M[j, x] * acc[:, :, x - xs]
                out[:, :, k, j] = s
    return out


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
        lib.upsampled_nll_fwd.argtypes = [_P, _P, _P] + [_I] * 9 + [_P]
        lib.upsampled_nll_fwd.restype = ctypes.c_int
        lib.upsampled_nll_bwd.argtypes = [_P, _P, _P, _P] + [_I] * 9 + [_P]
        lib.upsampled_nll_bwd.restype = ctypes.c_int
        lib._ccnet_bound = True
    return lib


def _dims(logits, labels, r) -> list:
    B, C, h, w = logits.shape
    return [B, C, h, w, labels.shape[1], labels.shape[2], r, band_tile(w, r),
            _LABEL_BYTES[labels.dtype]]


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
