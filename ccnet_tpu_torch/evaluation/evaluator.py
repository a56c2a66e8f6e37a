"""End-to-end evaluation driver: val mIoU, result.txt, prediction PNGs.

Counterpart of :mod:`ccnet_tpu.evaluation.evaluator` (the reference's
``evaluate.py`` main loop, ``:197-281``). Raw BGR images (uint8 or f32,
``(B, H, W, 3)``) go to ``device`` as they are; the f32 widen, the mean
subtract, the multi-scale/flip sliding (or whole) prediction, the argmax
and the confusion matrix all run there, under ``torch.inference_mode()``.
:meth:`Evaluator.run` takes its batches through
:func:`~ccnet_tpu_torch.data.loader.device_prefetch`, which pads and copies
batch i+1 while batch i is predicted; predictions come back to the host
only when PNGs are asked for, and a writer thread encodes them.

Over N ranks each rank predicts the images its loader yields (a strided
share: :class:`~ccnet_tpu_torch.data.loader.DataLoader` defaults to the
live group) and writes their PNGs; the confusion matrices are summed over
the ranks once, after the loop (:func:`~ccnet_tpu_torch.evaluation.metrics.
cross_process_sum`; no collective mid-loop, where the running meanIU in the
log is the rank's own), so every rank returns the global result, and rank
0 alone writes ``result.txt``.

With ``space`` (a :class:`~ccnet_tpu_torch.parallel.spatial.SpaceGroup`,
``--whole --space N``) the ranks of a space group load the same images,
each predicts and scores its own rows of every image
(:func:`~ccnet_tpu_torch.evaluation.sliding.predict_multiscale` with
``space``), so every pixel counts once in the summed confusion; for PNGs
the prediction rows are gathered and the group's first rank writes them.
The result's ``collectives`` holds the group's counts (calls, bytes) of
halo exchanges, gathers and sums.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import time
from concurrent.futures import ThreadPoolExecutor
from contextlib import closing
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ccnet_tpu_torch.data.loader import HostToDevice, device_prefetch
from ccnet_tpu_torch.data.palette import cityscapes_palette, save_indexed_png
from ccnet_tpu_torch.data.preprocess import CITYSCAPES_MEAN_BGR
from ccnet_tpu_torch.evaluation.metrics import (
    ConfusionAccumulator,
    cross_process_sum,
    iou_from_confusion,
)
from ccnet_tpu_torch.evaluation.sliding import predict_multiscale
from ccnet_tpu_torch.parallel.distributed import is_primary_host
from ccnet_tpu_torch.utils.trace import count, span, sync


def _mark(device: torch.device):
    """A point in time on ``device``'s timeline: a recorded CUDA event (no host
    synchronisation), or the host clock for the CPU."""
    if device.type == "cuda":
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(device))
        return event
    return time.perf_counter()


def _elapsed(start, end) -> float:
    """Seconds between two :func:`_mark` points (waits for the end event)."""
    if isinstance(start, torch.cuda.Event):
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    return end - start


class Evaluator:
    def __init__(
        self,
        apply_fn: Callable,  # (B, 3, h, w) -> (B, C, h/8, w/8) logits
        num_classes: int = 19,
        tile_hw: Tuple[int, int] = (769, 769),
        scales: Sequence[float] = (1.0,),
        flip: bool = False,
        whole: bool = False,
        ignore_label: int = 255,
        mean=CITYSCAPES_MEAN_BGR,
        class_names: Optional[Sequence[str]] = None,
        bucket: Optional[int] = None,
        palette: Optional[list] = None,
        device: torch.device | str = "cpu",
        space=None,
    ):
        self.apply_fn = apply_fn
        self.num_classes = num_classes
        self.tile_hw = tile_hw
        self.scales = scales
        self.flip = flip
        self.whole = whole
        self.ignore_label = ignore_label
        self.mean = np.asarray(mean, np.float32)
        self.class_names = class_names
        # Pad-to-bucket: H/W rounded up to a multiple of ``bucket`` with the
        # dataset mean (zero after the subtract, the reference's pad_image
        # cval); predictions are cropped back. See the JAX Evaluator for the
        # receptive-field caveat near the padded border.
        self.bucket = bucket
        self.palette = palette
        self.device = torch.device(device)
        if space is not None and not whole:
            raise ValueError("height sharding (space) applies to whole-image evaluation only")
        self.space = space
        self._mean_dev = torch.as_tensor(self.mean, device=self.device)
        self._copier = HostToDevice(self.device)

    def place(self, images: np.ndarray, labels=None) -> tuple:
        """Bucket-pad on the host and copy to the device (uint8 or f32 as given).

        Returns ``(Transfer of (dev_images,) or (dev_images, dev_labels),
        (H, W))``, with the original size for cropping predictions back; it
        runs on :func:`device_prefetch`'s thread, and the consumer waits on
        the transfer."""
        images = np.asarray(images)
        B, H, W = images.shape[0], images.shape[1], images.shape[2]
        if self.bucket:
            Hp = -(-H // self.bucket) * self.bucket
            Wp = -(-W // self.bucket) * self.bucket
            if (Hp, Wp) != (H, W):
                padded = np.empty((B, Hp, Wp, 3), images.dtype)
                padded[...] = (np.round(self.mean).astype(images.dtype)
                               if images.dtype != np.float32 else self.mean)
                padded[:, :H, :W] = images
                images = padded
        arrays = (images,) if labels is None else (images, labels)
        return self._copier(*arrays), (H, W)

    def _rows(self, height: int) -> Tuple[int, int]:
        """The rows of an image of ``height`` rows this rank predicts."""
        return (0, height) if self.space is None else self.space.rows(height)

    def _predict(self, images: torch.Tensor, H: int, W: int) -> Tuple[torch.Tensor, int]:
        """(B, Hp, Wp, 3) raw BGR on the device → ``(trainIds, r0)``: this
        rank's rows ``[r0, …)`` of the (B, H, W) uint8 trainIds, cropped to
        the image's own ``(H, W)``."""
        x = (images.float() - self._mean_dev).permute(0, 3, 1, 2)
        logits = predict_multiscale(self.apply_fn, x, self.tile_hw, self.num_classes,
                                    scales=self.scales, flip=self.flip, whole=self.whole,
                                    space=self.space)
        r0, r1 = self._rows(x.shape[2])
        keep = max(0, min(r1, H) - r0)
        return logits[:, :, :keep, :W].argmax(dim=1).to(torch.uint8), r0

    def _whole(self, preds: torch.Tensor, r0: int, H: int) -> torch.Tensor:
        """The (B, H, W) trainIds of which ``preds`` are this rank's rows
        from ``r0``: gathered over the space group."""
        if self.space is None:
            return preds
        return self.space.gather(preds[:, None], r0, H)[:, 0]

    def predict_batch(self, images: np.ndarray) -> np.ndarray:
        """Raw BGR images (B, H, W, 3), f32 or uint8 → trainIds (B, H, W).
        With ``space`` every rank of the group returns the whole images.
        Spans ``serve.place`` (the copy in) and ``serve.fetch`` (the answer's
        blocking copy out, counted as ``sync.serve.fetch``); counts
        ``serve.requests``."""
        count("serve.requests")
        with torch.inference_mode():
            with span("serve.place"):
                transfer, (H, W) = self.place(images)
                dev, = transfer.wait()
            ids = self._whole(*self._predict(dev, H, W), H)
            with span("serve.fetch"):
                sync("serve.fetch", ids.device)
                return ids.cpu().numpy()

    def run(self, loader, output_dir: Optional[str] = None, save_preds: bool = False,
            log_every: int = 10, logger=None) -> dict:
        acc = ConfusionAccumulator(self.num_classes, self.ignore_label, device=self.device)
        palette = self.palette if self.palette is not None else cityscapes_palette()
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
        n_done = 0
        # (start, end) of each batch on the device, from its prediction to
        # the confusion update, and its host time with the wait on the loader
        marks, wall = [], []
        writes = []
        it = device_prefetch(iter(loader), self.place, depth=2)
        with torch.inference_mode(), ThreadPoolExecutor(max_workers=1) as writer, closing(it):
            t0 = time.perf_counter()
            for transfer, (H, W), names in it:
                dev_images, dev_labels = transfer.wait()
                start = _mark(self.device)
                preds, r0 = self._predict(dev_images, H, W)
                acc.update(dev_labels[:, r0:r0 + preds.shape[1]], preds)
                marks.append((start, _mark(self.device)))
                if save_preds and output_dir:  # PNG encodes overlap the next batch
                    preds = self._whole(preds, r0, H)
                    if self.space is not None and self.space.index:
                        preds = preds[:0]  # the group's first rank writes them
                    for p, name in zip(preds.cpu().numpy(), names):
                        writes.append(writer.submit(
                            save_indexed_png, osp.join(output_dir, f"{name}.png"), p, palette))
                n_done += len(names)
                if logger and n_done % log_every < len(names):
                    logger.info(f"eval {n_done} images, running meanIU {acc.result()[1]:.4f}")
                wall.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
        for w in writes:
            w.result()  # raise a PNG write's error
        cm = cross_process_sum(acc.cm).cpu().numpy()
        iu, mean_iu = iou_from_confusion(cm)
        result = {
            "meanIU": mean_iu,
            "IU_array": [float(x) for x in iu],
            "confusion": cm.tolist(),
            "batch_seconds": [_elapsed(a, b) for a, b in marks],
            "wall_seconds": wall,
        }
        if self.space is not None:
            result["collectives"] = {k: list(v) for k, v in self.space.counts.items()}
        if self.class_names:
            result["per_class"] = {n: float(x) for n, x in zip(self.class_names, iu)}
        if output_dir and is_primary_host():
            with open(osp.join(output_dir, "result.txt"), "w") as f:
                json.dump({"meanIU": result["meanIU"], "IU_array": result["IU_array"]}, f)
        return result
