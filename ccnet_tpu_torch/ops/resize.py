"""Resizes, NCHW. Counterpart of :mod:`ccnet_tpu.ops.resize`.

Only the align-corners bilinear resize is on the evaluation path (logits
OS-8 → tile size, the reference's ``evaluate.py:103``, and the multi-scale
input resize). The cv2-convention resizes wait for the data-side port.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def resize_bilinear_align_corners(x: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of (N, C, H, W) with align_corners=True, in f32."""
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    x = x.float()
    if tuple(x.shape[-2:]) == (out_h, out_w):
        return x
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear", align_corners=True)
