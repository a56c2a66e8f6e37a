"""Training augmentation with the reference's semantics, on the device.

Counterpart of :mod:`ccnet_tpu.data.preprocess`. The reference recipe
(``dataset/datasets.py:157-210``): random scale in {0.7, 0.8, …, 2.1} (cv2
INTER_LINEAR image / INTER_NEAREST label), BGR mean subtraction, pad to the
crop (image 0 after the mean, label ignore), random crop, random mirror.

:func:`device_augment_batch` composes scale → pad → crop → mirror into one
bilinear gather per output pixel, in plain torch on the images' device, as
the JAX package's gather sampler does: output pixel ``(i, j)`` of a crop at
``(oy, ox)`` and scale ``f`` reads the source at the cv2 half-pixel
coordinate ``(i + oy + 0.5) · H₀/round(H₀·f) − 0.5``; coordinates past the
scaled extent are the padding; the mean is subtracted after sampling
(exact, since bilinear weights sum to 1). The per-sample draws (scale step,
``oy``, ``ox``, flip) come from :func:`draw_augment_params` with a CPU
``torch.Generator`` seeded from ``(seed, step)``; :func:`augment_batch`
takes them as arguments, so a test can feed it the JAX package's draws.
Copying the draws and the mean to a card blocks the host (pageable
memory): each such copy is counted as ``sync.augment.*``
(:mod:`~ccnet_tpu_torch.utils.trace`).
The JAX package's ``matmul`` sampler is not carried over.

:func:`finish_u8_crops` is the device tail of the uint8-crop input path,
and :func:`host_augment_u8` its numpy/cv2 host half (cv2 is imported when
it is called).

:func:`host_augment` is the host augmenter of variable-size datasets (VOC),
the JAX package's ``host_augment`` with its cv2 resizes replaced by numpy
ones of the same semantics (:func:`resize_linear`, :func:`resize_nearest`),
so it runs where cv2 is not installed.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ccnet_tpu_torch.parallel.mesh import rank_slice
from ccnet_tpu_torch.utils.trace import sync

# reference train.py:30 (BGR order, matches cv2 imread)
CITYSCAPES_MEAN_BGR = (104.00698793, 116.66876762, 122.67891434)

SCALE_MIN, SCALE_STEPS, SCALE_STEP = 0.7, 15, 0.1  # 0.7 … 2.1


def _scaled_sizes(hw, scale_idx: torch.Tensor, scale_min: float, scale: bool):
    """Per-sample ``(sH, sW)`` int64: ``round(H₀·f)`` in f32, as the JAX op."""
    f = (scale_min + SCALE_STEP * scale_idx.float() if scale
         else torch.ones(scale_idx.shape, dtype=torch.float32))
    return (torch.round(hw[0] * f).long(), torch.round(hw[1] * f).long())


def draw_augment_params(batch: int, hw: Tuple[int, int], crop_hw: Tuple[int, int],
                        generator: torch.Generator, scale_min: float = SCALE_MIN,
                        scale_steps: int = SCALE_STEPS, scale: bool = True,
                        mirror: bool = True):
    """Per-sample draws ``(scale_idx, oy, ox, flip)``, CPU int64/bool ``(B,)``.

    ``oy``, ``ox`` are uniform over the crop offsets of the padded scaled
    canvas; ``flip`` is a fair coin (all False without ``mirror``)."""
    scale_idx = torch.randint(0, scale_steps, (batch,), generator=generator)
    sH, sW = _scaled_sizes(hw, scale_idx, scale_min, scale)
    ch, cw = crop_hw
    u = torch.rand((batch, 3), generator=generator, dtype=torch.float64)
    oy = (u[:, 0] * (torch.clamp(sH, min=ch) - ch + 1)).long()
    ox = (u[:, 1] * (torch.clamp(sW, min=cw) - cw + 1)).long()
    flip = (u[:, 2] < 0.5) & mirror
    return scale_idx, oy, ox, flip


def _sample_coords(n0: int, s: torch.Tensor, off: torch.Tensor, n: int, device):
    """Half-pixel source coords, nearest indices and validity of one axis:
    ``(src (B, n) f32, nearest (B, n) int64, valid (B, n) bool)``; three
    blocking copies of the CPU draws to ``device``."""
    sync("augment.draws", device, 3)
    pos = torch.arange(n, device=device)[None, :] + off.to(device)[:, None]
    ratio = n0 / s.to(device).float()[:, None]  # f32 H₀/sH
    src = torch.clamp((pos.float() + 0.5) * ratio - 0.5, 0.0, n0 - 1)
    nearest = torch.clamp(torch.floor(pos.float() * ratio), 0, n0 - 1).long()
    return src, nearest, pos < s.to(device)[:, None]


def _lerp_taps(src: torch.Tensor, n0: int):
    lo = torch.clamp(torch.floor(src), 0, n0 - 1).long()
    return lo, torch.clamp(lo + 1, 0, n0 - 1), src - lo.float()


def augment_batch(images: torch.Tensor, labels: torch.Tensor, scale_idx: torch.Tensor,
                  oy: torch.Tensor, ox: torch.Tensor, flip: torch.Tensor,
                  crop_hw: Tuple[int, int] = (769, 769),
                  mean: Tuple[float, float, float] = CITYSCAPES_MEAN_BGR,
                  ignore_label: int = 255, scale_min: float = SCALE_MIN,
                  scale: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scale + pad + crop + mirror of a batch with the given draws.

    images ``(B, H₀, W₀, 3)`` raw BGR (any real dtype, uint8 included),
    labels ``(B, H₀, W₀)`` trainIds. Returns ``(B, ch, cw, 3)`` f32
    mean-subtracted images and ``(B, ch, cw)`` int32 labels on the images'
    device (NHWC, the JAX op's layout)."""
    B, H0, W0 = images.shape[:3]
    ch, cw = crop_hw
    device = images.device
    sH, sW = _scaled_sizes((H0, W0), scale_idx.cpu(), scale_min, scale)
    src_y, ny, valid_y = _sample_coords(H0, sH, oy.cpu(), ch, device)
    src_x, nx, valid_x = _sample_coords(W0, sW, ox.cpu(), cw, device)
    b = torch.arange(B, device=device)

    img = images.float()
    lo, hi, w = _lerp_taps(src_y, H0)
    w = w[:, :, None, None]
    img = img[b[:, None], lo] * (1 - w) + img[b[:, None], hi] * w  # (B, ch, W0, 3)
    lo, hi, w = _lerp_taps(src_x, W0)
    rows = torch.arange(ch, device=device)[None, :, None]
    w = w[:, None, :, None]
    img = (img[b[:, None, None], rows, lo[:, None, :]] * (1 - w)
           + img[b[:, None, None], rows, hi[:, None, :]] * w)  # (B, ch, cw, 3)
    sync("augment.mean", device)
    img = img - torch.tensor(mean, dtype=torch.float32, device=device)
    valid = valid_y[:, :, None] & valid_x[:, None, :]
    img = torch.where(valid[..., None], img, torch.zeros((), device=device))

    lbl = labels[b[:, None, None], ny[:, :, None], nx[:, None, :]].to(torch.int32)
    lbl = torch.where(valid, lbl, torch.full((), ignore_label, dtype=torch.int32, device=device))

    sync("augment.draws", device)
    flip = flip.to(device)
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    lbl = torch.where(flip[:, None, None], lbl.flip(2), lbl)
    return img.contiguous(), lbl.contiguous()


def device_augment_batch(images: torch.Tensor, labels: torch.Tensor, seed: int, step: int,
                         crop_hw: Tuple[int, int] = (769, 769),
                         mean: Tuple[float, float, float] = CITYSCAPES_MEAN_BGR,
                         ignore_label: int = 255, scale_min: float = SCALE_MIN,
                         scale_steps: int = SCALE_STEPS, scale: bool = True,
                         mirror: bool = True, rank: int = 0,
                         ranks: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Augment a raw batch on its device with draws seeded from ``(seed, step)``.

    ``images`` is rank ``rank``'s share of a global batch over ``ranks``
    ranks: the draws are made for the global batch and sliced, so each
    rank's crops are the one-process crops of its samples."""
    gen = torch.Generator().manual_seed((seed * 1000003 + step) % (2 ** 63))
    draws = draw_augment_params(images.shape[0] * ranks, tuple(images.shape[1:3]), crop_hw,
                                gen, scale_min, scale_steps, scale, mirror)
    draws = [rank_slice(d, rank, ranks) for d in draws]
    return augment_batch(images, labels, *draws, crop_hw=crop_hw, mean=mean,
                         ignore_label=ignore_label, scale_min=scale_min, scale=scale)


def finish_u8_crops(images_u8: torch.Tensor, labels_u8: torch.Tensor,
                    mean: Tuple[float, float, float] = CITYSCAPES_MEAN_BGR):
    """Device tail of the uint8-crop path: widen + mean-subtract, int32 labels."""
    sync("augment.mean", images_u8.device)
    imgs = images_u8.float() - torch.tensor(mean, dtype=torch.float32, device=images_u8.device)
    return imgs, labels_u8.to(torch.int32)


def host_augment_u8(image: np.ndarray, label: np.ndarray, rng: np.random.RandomState,
                    crop_hw: Tuple[int, int] = (769, 769), mean=CITYSCAPES_MEAN_BGR,
                    ignore_label: int = 255, scale: bool = True, mirror: bool = True,
                    scale_min: float = SCALE_MIN, scale_steps: int = SCALE_STEPS):
    """Host augmentation to uint8 crops (numpy/cv2), the JAX package's
    ``host_augment_u8``: cv2 resizes the uint8 image before any widening, as
    the reference does; the image pad value is the rounded mean, so it lands
    at ≈0 after :func:`finish_u8_crops`."""
    import cv2

    ch, cw = crop_hw
    if scale:
        f = scale_min + SCALE_STEP * rng.randint(0, scale_steps)
        image = cv2.resize(image, None, fx=f, fy=f, interpolation=cv2.INTER_LINEAR)
        label = cv2.resize(label, None, fx=f, fy=f, interpolation=cv2.INTER_NEAREST)
    h, w = label.shape
    pad_h, pad_w = max(ch - h, 0), max(cw - w, 0)
    if pad_h or pad_w:
        pad_val = np.round(np.asarray(mean)).astype(np.uint8)
        image = np.stack([np.pad(image[..., c], ((0, pad_h), (0, pad_w)),
                                 constant_values=int(pad_val[c])) for c in range(3)], -1)
        label = np.pad(label, ((0, pad_h), (0, pad_w)), constant_values=ignore_label)
    h, w = label.shape
    oy = rng.randint(0, h - ch + 1)
    ox = rng.randint(0, w - cw + 1)
    image = image[oy:oy + ch, ox:ox + cw]
    label = label[oy:oy + ch, ox:ox + cw]
    if mirror and rng.randint(0, 2):
        image = image[:, ::-1]
        label = label[:, ::-1]
    return np.ascontiguousarray(image), np.ascontiguousarray(label)


def scaled_size(n: int, f: float) -> int:
    """cv2's output length of ``cv2.resize(fx=f)`` on an ``n``-pixel side:
    ``n·f`` rounded half to even (``saturate_cast<int>``), as Python's
    ``round`` does."""
    return int(round(n * f))


def _linear_taps(idx: np.ndarray, n_in: int, f: float, f32_coords: bool):
    """cv2 INTER_LINEAR's taps of output pixels ``idx`` of one axis: source
    ``(i + 0.5) · (1/f) − 0.5`` and its fraction in double (``f32_coords``:
    the source rounded to f32 first, as cv2 does for an image of one row or
    one column), the weight cast to f32; below 0 the first pixel alone, past
    the last pixel the last alone. ``(lo, hi, weight of hi)``."""
    src = (idx + 0.5) * (1.0 / f) - 0.5
    if f32_coords:
        src = src.astype(np.float32).astype(np.float64)
    lo = np.floor(src).astype(np.int64)
    w = (src - lo).astype(np.float32)
    w[lo < 0] = 0.0
    lo = np.maximum(lo, 0)
    w[lo >= n_in - 1] = 0.0
    lo = np.minimum(lo, n_in - 1)
    return lo, np.minimum(lo + 1, n_in - 1), w


def _resample(image: np.ndarray, f: float, rows: np.ndarray, cols: np.ndarray,
              linear: bool) -> np.ndarray:
    """Pixels ``rows`` × ``cols`` of ``cv2.resize(image, None, fx=f, fy=f)``,
    INTER_LINEAR (f32, each row's lerp across the width first, then down, as
    cv2 does) or INTER_NEAREST (source ``min(floor(i · (1/f)), n − 1)`` in
    double), computed for those pixels alone. An unchanged size is a copy,
    as in cv2."""
    H, W = image.shape[:2]
    if (scaled_size(H, f), scaled_size(W, f)) == (H, W):
        return image[rows][:, cols]
    if not linear:
        ny = np.minimum(np.floor(rows * (1.0 / f)).astype(np.int64), H - 1)
        nx = np.minimum(np.floor(cols * (1.0 / f)).astype(np.int64), W - 1)
        return image[ny][:, nx]
    line = min(H, W) == 1
    xlo, xhi, wx = _linear_taps(cols, W, f, line)
    ylo, yhi, wy = _linear_taps(rows, H, f, line)
    wx = wx.reshape((1, -1) + (1,) * (image.ndim - 2))
    wy = wy.reshape((-1,) + (1,) * (image.ndim - 1))
    top, bottom = image[ylo], image[yhi]
    top = top[:, xlo] * (1.0 - wx) + top[:, xhi] * wx
    bottom = bottom[:, xlo] * (1.0 - wx) + bottom[:, xhi] * wx
    return top * (1.0 - wy) + bottom * wy


def resize_linear(image: np.ndarray, f: float) -> np.ndarray:
    """``cv2.resize(image, None, fx=f, fy=f, interpolation=cv2.INTER_LINEAR)``
    of an (H, W[, C]) f32 image in numpy (within 1e-3 of cv2 on 0–255
    images)."""
    image = np.asarray(image, np.float32)
    H, W = image.shape[:2]
    return _resample(image, f, np.arange(scaled_size(H, f)), np.arange(scaled_size(W, f)), True)


def resize_nearest(label: np.ndarray, f: float) -> np.ndarray:
    """``cv2.resize(label, None, fx=f, fy=f, interpolation=cv2.INTER_NEAREST)``
    in numpy (equal to cv2's)."""
    H, W = label.shape[:2]
    return _resample(label, f, np.arange(scaled_size(H, f)), np.arange(scaled_size(W, f)),
                     False)


def host_augment(image: np.ndarray, label: np.ndarray, rng: np.random.RandomState,
                 crop_hw: Tuple[int, int] = (769, 769), mean=CITYSCAPES_MEAN_BGR,
                 ignore_label: int = 255, scale: bool = True, mirror: bool = True,
                 scale_min: float = SCALE_MIN, scale_steps: int = SCALE_STEPS):
    """Scale, mean-subtract, pad, crop and mirror one (H, W, 3) f32 BGR image
    and its (H, W) labels on the host: ``(crop image f32, crop labels)``.

    The JAX package's ``host_augment`` with numpy resizes of cv2's semantics
    (bilinear image, nearest uint8 label), computed for the crop window
    alone (the scaled size, and so the crop's draws, need no pixel). The rng
    is consumed in its order: scale, oy, ox, mirror."""
    ch, cw = crop_hw
    H, W = label.shape
    if scale:
        f = scale_min + SCALE_STEP * rng.randint(0, scale_steps)
        h, w = scaled_size(H, f), scaled_size(W, f)
    else:
        h, w = H, W
    oy = rng.randint(0, max(h, ch) - ch + 1)
    ox = rng.randint(0, max(w, cw) - cw + 1)
    rows, cols = np.arange(oy, min(oy + ch, h)), np.arange(ox, min(ox + cw, w))
    if scale:
        img = _resample(np.asarray(image, np.float32), f, rows, cols, True)
        lbl = _resample(label.astype(np.uint8), f, rows, cols, False).astype(label.dtype)
    else:
        img, lbl = image[rows][:, cols], label[rows][:, cols]
    out_img = np.zeros((ch, cw, 3), np.float32)  # the pad: 0 after the mean
    out_img[:len(rows), :len(cols)] = img.astype(np.float32) - np.asarray(mean, np.float32)
    out_lbl = np.full((ch, cw), ignore_label, label.dtype)
    out_lbl[:len(rows), :len(cols)] = lbl
    if mirror and rng.randint(0, 2):
        out_img, out_lbl = out_img[:, ::-1], out_lbl[:, ::-1]
    return np.ascontiguousarray(out_img), np.ascontiguousarray(out_lbl)
