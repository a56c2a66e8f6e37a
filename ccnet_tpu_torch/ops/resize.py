"""Resizes, NCHW. Counterpart of :mod:`ccnet_tpu.ops.resize`.

Only the align-corners bilinear resize is on the evaluation path (logits
OS-8 → tile size, the reference's ``evaluate.py:103``, and the multi-scale
input resize). The cv2-convention resizes wait for the data-side port.

Two forms of the align-corners resize, split by the input's size:

* :func:`resize_bilinear_align_corners` (``F.interpolate``) for every
  resize of a feature map or an image: the logits to the tile or the
  image, the multi-scale inputs, the criterion's materialised upsample.
* :func:`upsample_small_align_corners` for an input of a few pixels only:
  the PSP pyramid's 1…6² priors and the ASPP image pool (a 1×1 map), each
  upsampled to the 97² features. It is two f32 matrix products with the
  interpolation weights, and so is its backward, where ``F.interpolate``'s
  backward adds every output pixel's gradient into its input taps with
  atomics, which in bf16 serialise when thousands of outputs share one
  input (432 ms of a 705 ms PSPNet-R101 train step at batch 8 of 769²,
  NVIDIA H100 80GB HBM3, 700.00 W, ``chip_smoke.py``). Its weights are
  O(n_in · n_out), so it is not for large inputs.

:func:`resize_rows_align_corners` computes some output rows of the
align-corners resize from the input rows they read: a height-sharded
evaluation's own rows of the full-resolution logits. In a height-sharded
forward (:func:`~ccnet_tpu_torch.parallel.spatial.current`),
:func:`upsample_small_align_corners` resizes to the map's global height and
returns this shard's rows.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ccnet_tpu_torch.parallel import spatial


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) with align_corners=True, in f32."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    x = x.float()
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)


@functools.lru_cache(maxsize=64)
def align_corners_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in) f32 weights of the align-corners bilinear resize along one
    axis: output i takes ``1 − f`` of input ``lo`` and ``f`` of ``lo + 1``
    at source position ``i·(n_in − 1)/(n_out − 1)``. Built once per
    (n_in, n_out, device) on ``device``, outside inference mode (so that a
    matrix first made during evaluation can be saved for a later backward);
    callers must not write to it."""
    with torch.inference_mode(False):
        rows = torch.arange(n_out, device=device)
        src = rows.double() * ((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
        lo = src.floor().long().clamp_max(n_in - 1)
        frac = src - lo
        m = torch.zeros(n_out, n_in, dtype=torch.float64, device=device)
        m.index_put_((rows, lo), 1.0 - frac, accumulate=True)
        m.index_put_((rows, (lo + 1).clamp_max(n_in - 1)), frac, accumulate=True)
        return m.float()


def source_rows(n_in: int, n_out: int, rows) -> tuple:
    """The input rows ``(lo, hi)`` (long tensors) that the output rows
    ``[rows[0], rows[1])`` of an align-corners resize from ``n_in`` to
    ``n_out`` rows interpolate between, and each row's weight of ``hi``."""
    out = torch.arange(rows[0], rows[1])
    src = out.double() * ((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
    lo = src.floor().long().clamp_max(n_in - 1)
    return lo, (lo + 1).clamp_max(n_in - 1), (src - lo).float()


def resize_rows_align_corners(x: torch.Tensor, out_hw, rows, n_in: int | None = None,
                              row0: int = 0) -> torch.Tensor:
    """Output rows ``[rows[0], rows[1])`` of the align-corners bilinear
    resize to ``out_hw`` of an NCHW map of ``n_in`` rows (default: ``x``'s),
    of which ``x`` holds rows ``[row0, row0 + x.shape[2])``; in f32. Widths
    resize first, then each output row interpolates its two input rows."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    n_in = x.shape[2] if n_in is None else n_in
    x = x.float()
    if x.shape[3] != out_w:  # rows map to themselves: a resize of the width only
        x = F.interpolate(x, size=(x.shape[2], out_w), mode="bilinear", align_corners=True)
    lo, hi, frac = (t.to(x.device) for t in source_rows(n_in, out_h, rows))
    top, bottom = x.index_select(2, lo - row0), x.index_select(2, hi - row0)
    return top * (1.0 - frac)[:, None] + bottom * frac[:, None]


def upsample_small_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Align-corners bilinear resize of a small NCHW ``x`` to ``out_hw`` as
    ``Mh · x · Mwᵀ`` in f32, returned in x's dtype."""
    plan = spatial.current()
    if plan is not None:  # out_hw is this shard's rows of the map
        height, start, end = plan.span(int(out_hw[0]))
        mh = align_corners_matrix(x.shape[2], height, x.device)[start:end]
        mw = align_corners_matrix(x.shape[3], int(out_hw[1]), x.device)
        return torch.matmul(torch.matmul(mh, x.float()), mw.t()).to(x.dtype)
    mh = align_corners_matrix(x.shape[2], int(out_hw[0]), x.device)
    mw = align_corners_matrix(x.shape[3], int(out_hw[1]), x.device)
    return torch.matmul(torch.matmul(mh, x.float()), mw.t()).to(x.dtype)
