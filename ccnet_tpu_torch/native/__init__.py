"""Native (C++/OpenMP) host augmentation behind ctypes.

Counterpart of :mod:`ccnet_tpu.native`. ``augment.cpp`` is a copy of the
JAX package's source: for each sample it fuses the random scale (cv2
INTER_LINEAR half-pixel sampling), the labelId→trainId LUT, pad, crop,
mirror and, in the f32 variant, the mean subtraction, computing only the
crop window.

The library is built at first use with ``g++ -O3 -march=native -fopenmp
-shared -fPIC`` (the JAX package's flags, so both builds round alike) into
``build/ccnet_tpu_torch/`` at the checkout root, under a name that carries
a hash of the source, the flags and the host CPU. :func:`available` says whether it builds
and loads (``engine="auto"`` asks it); :func:`load`, :func:`augment_batch`
and :func:`augment_batch_u8` raise with the compiler's output when it does
not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from ccnet_tpu_torch.ops._build import build_lock

SRC = Path(__file__).resolve().parent / "augment.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "ccnet_tpu_torch"
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None  # why the build or the load failed, once it has

_U8P = ctypes.POINTER(ctypes.c_uint8)
_COMMON = [_U8P, _U8P, _U8P,  # images, labels, lut
           ctypes.c_int, ctypes.c_int, ctypes.c_int,  # B, H0, W0
           ctypes.c_int, ctypes.c_int,  # crop_h, crop_w
           ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int), _U8P]  # scales, offs, flips


def _cpu() -> str:
    """The host CPU's model and flags (``-march=native`` builds for them)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = [line for line in f if line.startswith(("model name", "flags"))]
        return "".join(lines[:2])
    except OSError:
        return platform.processor() or platform.machine()


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SRC.read_bytes())
    h.update(_cpu().encode())
    return BUILD_DIR / f"libccnet_data_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *GXX_FLAGS, str(SRC), "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)} failed (exit {proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file


def load() -> ctypes.CDLL:
    """The loaded library (built if needed); raises why it is not there."""
    global _lib, _error
    with _lock:
        if _lib is not None:
            return _lib
        if _error is not None:
            raise RuntimeError(f"native augment library unavailable: {_error}")
        try:
            so = _library_path()
            with build_lock(so):  # ranks starting at once build it once
                if not so.is_file():
                    _build(so)
            lib = ctypes.CDLL(str(so))
        except Exception as e:  # noqa: BLE001 - remembered, raised to every caller
            _error = str(e)
            raise RuntimeError(f"native augment library unavailable: {_error}") from e
        lib.ccnet_augment_batch.argtypes = [
            *_COMMON, ctypes.POINTER(ctypes.c_float),  # mean
            ctypes.c_int,  # ignore_label
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int32)]  # out images, labels
        lib.ccnet_augment_batch.restype = None
        lib.ccnet_augment_batch_u8.argtypes = [
            *_COMMON, _U8P,  # pad_val (3, uint8)
            ctypes.c_int,  # ignore_label
            _U8P, _U8P]  # out images, labels
        lib.ccnet_augment_batch_u8.restype = None
        _lib = lib
        return lib


def available() -> bool:
    """True when the library builds and loads."""
    try:
        load()
    except RuntimeError:
        return False
    return True


def _p(a: np.ndarray, t):
    return a.ctypes.data_as(ctypes.POINTER(t))


def _inputs(images, labels, lut, scales, offs, flips):
    return (np.ascontiguousarray(images, np.uint8), np.ascontiguousarray(labels, np.uint8),
            np.ascontiguousarray(lut, np.uint8), np.ascontiguousarray(scales, np.float32),
            np.ascontiguousarray(offs, np.int32), np.ascontiguousarray(flips, np.uint8))


def augment_batch(
    images: np.ndarray,   # (B, H0, W0, 3) uint8 BGR
    labels: np.ndarray,   # (B, H0, W0) uint8 raw label ids
    lut: np.ndarray,      # (256,) uint8 id -> trainId (identity if mapped)
    scales: np.ndarray,   # (B,) float32
    offs: np.ndarray,     # (B, 2) int32 (oy, ox) in scaled space
    flips: np.ndarray,    # (B,) uint8
    crop_hw: Tuple[int, int],
    mean,
    ignore_label: int = 255,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fused scale + LUT + pad + crop + mirror + mean subtraction: ``(B, ch,
    cw, 3)`` f32 images and ``(B, ch, cw)`` int32 labels."""
    lib = load()
    images, labels, lut, scales, offs, flips = _inputs(images, labels, lut, scales, offs, flips)
    B, H0, W0, _ = images.shape
    ch, cw = crop_hw
    mean = np.ascontiguousarray(mean, np.float32)
    out_images = np.empty((B, ch, cw, 3), np.float32)
    out_labels = np.empty((B, ch, cw), np.int32)
    c = ctypes
    lib.ccnet_augment_batch(
        _p(images, c.c_uint8), _p(labels, c.c_uint8), _p(lut, c.c_uint8), B, H0, W0, ch, cw,
        _p(scales, c.c_float), _p(offs, c.c_int), _p(flips, c.c_uint8), _p(mean, c.c_float),
        ignore_label, _p(out_images, c.c_float), _p(out_labels, c.c_int32))
    return out_images, out_labels


def augment_batch_u8(
    images: np.ndarray,   # (B, H0, W0, 3) uint8 BGR
    labels: np.ndarray,   # (B, H0, W0) uint8 raw label ids
    lut: np.ndarray,      # (256,) uint8 id -> trainId (identity if mapped)
    scales: np.ndarray,   # (B,) float32
    offs: np.ndarray,     # (B, 2) int32 (oy, ox) in scaled space
    flips: np.ndarray,    # (B,) uint8
    crop_hw: Tuple[int, int],
    mean,                 # float BGR mean; pad pixels get round(mean)
    ignore_label: int = 255,
) -> Tuple[np.ndarray, np.ndarray]:
    """The uint8-crop variant: ``(B, ch, cw, 3)`` uint8 images and ``(B, ch,
    cw)`` uint8 labels, the mean subtraction left to the device
    (:func:`~ccnet_tpu_torch.data.preprocess.finish_u8_crops`)."""
    lib = load()
    images, labels, lut, scales, offs, flips = _inputs(images, labels, lut, scales, offs, flips)
    B, H0, W0, _ = images.shape
    ch, cw = crop_hw
    pad_val = np.round(np.asarray(mean)).astype(np.uint8)
    out_images = np.empty((B, ch, cw, 3), np.uint8)
    out_labels = np.empty((B, ch, cw), np.uint8)
    c = ctypes
    lib.ccnet_augment_batch_u8(
        _p(images, c.c_uint8), _p(labels, c.c_uint8), _p(lut, c.c_uint8), B, H0, W0, ch, cw,
        _p(scales, c.c_float), _p(offs, c.c_int), _p(flips, c.c_uint8), _p(pad_val, c.c_uint8),
        ignore_label, _p(out_images, c.c_uint8), _p(out_labels, c.c_uint8))
    return out_images, out_labels


def draw_augment_params(
    rng: np.random.RandomState,
    batch: int,
    image_hw: Tuple[int, int],
    crop_hw: Tuple[int, int],
    scale_min: float = 0.7,
    scale_steps: int = 15,
    scale_step: float = 0.1,
    mirror: bool = True,
):
    """The reference recipe's draws (``dataset/datasets.py:157-210``):
    discrete scales, a uniform crop offset over the padded scaled canvas, a
    fair-coin mirror; ``(scales (B,) f32, offs (B, 2) int32, flips (B,)
    uint8)``, consuming ``rng`` as the JAX package does."""
    H0, W0 = image_hw
    ch, cw = crop_hw
    scales = (scale_min + scale_step * rng.randint(0, scale_steps, size=batch)).astype(np.float32)
    offs = np.zeros((batch, 2), np.int32)
    for b in range(batch):
        sH = int(round(H0 * scales[b]))
        sW = int(round(W0 * scales[b]))
        offs[b, 0] = rng.randint(0, max(sH, ch) - ch + 1)
        offs[b, 1] = rng.randint(0, max(sW, cw) - cw + 1)
    flips = rng.randint(0, 2 if mirror else 1, size=batch).astype(np.uint8)
    return scales, offs, flips
