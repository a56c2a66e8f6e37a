"""Sliding-window / whole-image / multi-scale prediction, NCHW.

Counterpart of :mod:`ccnet_tpu.evaluation.sliding`. The tiling arithmetic is
the reference's (``evaluate.py:102-143``): stride = ceil(tile·(1−overlap)),
tiles clamped to the image with the last tile pulled back inside,
overlapping logits averaged by visit count. The tiles of an image are
stacked into batches of ``tiles_per_call`` and go through the network
together; a Python loop over those chunks takes the place of the JAX
package's ``lax.map``. Logits are upsampled to tile size with
align-corners bilinear and summed into a plain ``(B, C, H, W)`` f32 canvas.

``apply_fn(images (N, 3, h, w)) -> (N, C, h', w')`` is any forward that
returns OS-k logits. Images here are NCHW; the JAX functions take NHWC.

Whole-image prediction takes a ``space``
(:class:`~ccnet_tpu_torch.parallel.spatial.SpaceGroup`), the counterpart of
the JAX functions' ``mesh`` with a ``space`` axis: each rank runs the
network on its rows of each (scaled, flipped) image, the stride-8 logits of
the shards are gathered (19×129×257 f32 is 2.5 MB an image), and the rank
interpolates its own rows of the full-resolution logits
(:meth:`SpaceGroup.rows`) from them; a multi-scale pass resizes back the
same way. The result is this rank's rows of the one-process result.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ccnet_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
    resize_rows_align_corners,
    source_rows,
)


def compute_tiles(image_hw: Tuple[int, int], tile_hw: Tuple[int, int],
                  overlap: float = 1.0 / 3.0) -> List[Tuple[int, int, int, int]]:
    """(y1, x1, y2, x2) boxes with the reference's stride/clamp arithmetic."""
    H, W = image_hw
    th, tw = tile_hw
    stride = int(math.ceil(th * (1.0 - overlap)))
    rows = int(math.ceil(max(H - th, 0) / stride) + 1)
    cols = int(math.ceil(max(W - tw, 0) / stride) + 1)
    boxes = []
    for r in range(rows):
        for c in range(cols):
            x1, y1 = c * stride, r * stride
            x2, y2 = min(x1 + tw, W), min(y1 + th, H)
            x1, y1 = max(x2 - tw, 0), max(y2 - th, 0)
            boxes.append((y1, x1, y2, x2))
    return boxes


def predict_sliding(apply_fn: Callable, image: torch.Tensor, tile_hw: Tuple[int, int],
                    num_classes: int, overlap: float = 1.0 / 3.0,
                    tiles_per_call: int = 8) -> torch.Tensor:
    """(B, 3, H, W) preprocessed → (B, C, H, W) f32 logits averaged over
    the overlapping tiles (the reference averages raw upsampled logits)."""
    B, _, H, W = image.shape
    th, tw = tile_hw
    # pad up to tile size if smaller (reference pad_image, evaluate.py:95-100)
    pad_h, pad_w = max(th - H, 0), max(tw - W, 0)
    if pad_h or pad_w:
        image = F.pad(image, (0, pad_w, 0, pad_h))
    Hp, Wp = image.shape[2], image.shape[3]
    boxes = compute_tiles((Hp, Wp), tile_hw, overlap)
    # tile t = box_index * B + batch_index
    tiles = torch.cat([image[:, :, y1:y2, x1:x2] for (y1, x1, y2, x2) in boxes], dim=0)
    step = max(tiles_per_call, B)
    canvas = torch.zeros((B, num_classes, Hp, Wp), dtype=torch.float32, device=image.device)
    count = torch.zeros((Hp, Wp), dtype=torch.float32, device=image.device)
    for s in range(0, tiles.shape[0], step):
        logits = resize_bilinear_align_corners(apply_fn(tiles[s:s + step]), tile_hw)
        for j in range(logits.shape[0]):
            i_box, b = divmod(s + j, B)
            y1, x1, y2, x2 = boxes[i_box]
            canvas[b, :, y1:y2, x1:x2] += logits[j]
    for (y1, x1, y2, x2) in boxes:
        count[y1:y2, x1:x2] += 1.0
    return (canvas / count)[:, :, :H, :W]


def predict_whole(apply_fn: Callable, image: torch.Tensor, num_classes: int,
                  space=None) -> torch.Tensor:
    """Whole-image forward, logits upsampled to input size (evaluate.py:145-153).
    With ``space``, this rank's rows of them (``space.rows(H)``)."""
    if space is not None:
        return _whole_rows(apply_fn, image, space, image.shape[2:],
                           space.rows(image.shape[2]))
    return resize_bilinear_align_corners(apply_fn(image), image.shape[2:])


def _whole_rows(apply_fn: Callable, image: torch.Tensor, space, out_hw, rows) -> torch.Tensor:
    """Rows ``rows`` of the whole-image logits of ``image`` upsampled to
    ``out_hw``, from the stride-8 logits gathered over ``space``."""
    return resize_rows_align_corners(space.forward(apply_fn, image), out_hw, rows)


def predict_multiscale(apply_fn: Callable, image: torch.Tensor, tile_hw: Tuple[int, int],
                       num_classes: int, scales: Sequence[float] = (1.0,), flip: bool = False,
                       overlap: float = 1.0 / 3.0, whole: bool = False,
                       tiles_per_call: int = 8, space=None) -> torch.Tensor:
    """Multi-scale + flip averaging (reference evaluate.py:155-175): resize the
    input per scale (``scipy.ndimage.zoom(order=1)`` semantics: round(in·s),
    align-corners), sliding or whole prediction, optional horizontal-flip
    average, resize back, mean over scales. Returns (B, C, H, W) f32; with
    ``space`` (whole-image only), this rank's rows ``space.rows(H)`` of it."""
    _, _, H, W = image.shape
    if space is not None:
        if not whole:
            raise ValueError("height sharding (space) applies to whole-image prediction only")
        return _multiscale_rows(apply_fn, image, space, scales, flip)

    def predict(x):
        if whole:
            return predict_whole(apply_fn, x, num_classes)
        return predict_sliding(apply_fn, x, tile_hw, num_classes, overlap, tiles_per_call)

    acc = None
    for s in scales:
        sh, sw = int(round(H * float(s))), int(round(W * float(s)))
        scaled = resize_bilinear_align_corners(image, (sh, sw)) if (sh, sw) != (H, W) else image
        probs = predict(scaled)
        if flip:
            probs = 0.5 * (probs + predict(scaled.flip(-1)).flip(-1))
        if (sh, sw) != (H, W):
            probs = resize_bilinear_align_corners(probs, (H, W))
        acc = probs if acc is None else acc + probs
    return acc / len(scales)


def _multiscale_rows(apply_fn: Callable, image: torch.Tensor, space, scales: Sequence[float],
                     flip: bool) -> torch.Tensor:
    """:func:`predict_multiscale`'s whole-image average, this rank's rows of
    it: each pass interpolates only the rows of its scaled logits that this
    rank's rows of the result read."""
    _, _, H, W = image.shape
    rows = space.rows(H)
    acc = None
    for s in scales:
        sh, sw = int(round(H * float(s))), int(round(W * float(s)))
        scaled = resize_bilinear_align_corners(image, (sh, sw)) if (sh, sw) != (H, W) else image
        window = rows
        if (sh, sw) != (H, W):
            lo, hi, _ = source_rows(sh, H, rows)
            window = (int(lo.min()), int(hi.max()) + 1)
        probs = _whole_rows(apply_fn, scaled, space, (sh, sw), window)
        if flip:
            probs = 0.5 * (probs + _whole_rows(apply_fn, scaled.flip(-1), space, (sh, sw),
                                               window).flip(-1))
        if (sh, sw) != (H, W):
            probs = resize_rows_align_corners(probs, (H, W), rows, n_in=sh, row0=window[0])
        acc = probs if acc is None else acc + probs
    return acc / len(scales)
