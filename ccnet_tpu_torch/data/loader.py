"""Host data: datasets, the threaded loader and the device prefetch.

Copies of the JAX package's :mod:`ccnet_tpu.data.loader` pieces that the
training and evaluation paths use, with the same seeds and orders:

* :class:`SyntheticDataset` (same samples);
* :class:`AugmentingDataset`, host augmentation of variable-size samples
  (VOC) to fixed-size f32 crops, and :class:`U8CropDataset`, host
  augmentation to uint8 crops by cv2 or the native library (``engine``),
  both with draws deterministic per ``(seed, epoch, index)``
  (:func:`_epoch_rng`);
* :class:`CachedDataset`, the decode-once RAM cache keyed by sample name
  (``max_items``/``max_bytes`` caps, ``CCNET_TPU_CACHE_GB`` budget);
* :class:`DataLoader`, the JAX loader: epoch order
  ``RandomState(seed + epoch).permutation(n)`` strided by process, samples
  decoded on a thread pool up to ``decode_ahead`` past the consume point
  (across batch boundaries), ``prefetch`` batches queued by a producer
  thread, decode errors raised at the consumer's ``next()``;
* :func:`device_prefetch`, which places batch i+1 while step i runs, and
  :class:`HostToDevice`, its placement on a CUDA card: pinned staging
  buffers and a side stream, the consumer's stream waiting on each copy.

Over N ranks (a live ``torch.distributed`` group, one process per card)
``process_index``/``process_count`` default to the rank and the world
size, so each rank loads its strided share of every epoch; the shares of a
batch, concatenated in rank order, are the global batch.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ccnet_tpu_torch.parallel.distributed import world
from ccnet_tpu_torch.utils.logging import get_logger

logger = get_logger("ccnet_tpu_torch.data")


def _epoch_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """The per-(seed, epoch, index) augmentation rng of the JAX package."""
    return np.random.RandomState((seed * 1000003 + epoch * 7919 + index) % (2 ** 31))


def _shutdown_pipeline(q: "queue.Queue", t: threading.Thread,
                       stop: threading.Event) -> None:
    """Tear down a bounded-queue producer thread without deadlock.

    Setting ``stop`` alone is not enough: a producer blocked in ``q.put``
    never sees it. Drain the queue until the producer exits: each drained
    slot wakes a blocked ``put``, and the producer's ``finally`` may block
    once more on its sentinel, hence the loop."""
    stop.set()
    while t.is_alive():
        try:
            q.get_nowait()
        except queue.Empty:
            t.join(0.02)
    while True:  # drop the remaining references promptly
        try:
            q.get_nowait()
        except queue.Empty:
            break


class SyntheticDataset:
    """Fixed-size random dataset — for tests, benchmarks and smoke CLIs."""

    def __init__(self, n: int = 64, hw: Tuple[int, int] = (1024, 2048),
                 num_classes: int = 19, seed: int = 0):
        self.n, self.hw, self.num_classes, self.seed = n, hw, num_classes, seed

    def __len__(self):
        return self.n

    def name(self, index: int) -> str:
        return f"synthetic_{index:05d}"

    def __getitem__(self, index: int):
        rng = np.random.RandomState(self.seed + index)
        h, w = self.hw
        image = rng.randint(0, 256, size=(h, w, 3)).astype(np.float32)
        label = rng.randint(0, self.num_classes, size=(h, w)).astype(np.int32)
        label[rng.rand(h, w) < 0.05] = 255
        return image, label, self.name(index)


class AugmentingDataset:
    """Host augmentation of a dataset of variable-size raw samples (VOC) to
    fixed-size crops: :func:`~ccnet_tpu_torch.data.preprocess.host_augment`
    (numpy, no cv2) with the rng of ``(seed, epoch, index)``, re-drawn every
    epoch (``set_epoch``); f32 mean-subtracted images and the labels' dtype
    out."""

    def __init__(self, dataset, crop_hw=(321, 321), mean=(128.0, 128.0, 128.0),
                 scale: bool = True, mirror: bool = True, ignore_label: int = 255,
                 scale_min: float = 0.5, scale_steps: int = 12, seed: int = 0):
        self.dataset = dataset
        self.crop_hw = crop_hw
        self.mean = mean
        self.scale, self.mirror = scale, mirror
        self.ignore_label = ignore_label
        self.scale_min, self.scale_steps = scale_min, scale_steps
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.dataset)

    def name(self, index):
        return self.dataset.name(index)

    def __getitem__(self, index):
        from ccnet_tpu_torch.data.preprocess import host_augment

        image, label, name = self.dataset[index]
        img, lbl = host_augment(
            image, label, _epoch_rng(self.seed, self.epoch, index), crop_hw=self.crop_hw,
            mean=self.mean, ignore_label=self.ignore_label, scale=self.scale,
            mirror=self.mirror, scale_min=self.scale_min, scale_steps=self.scale_steps)
        return img, lbl, name


class U8CropDataset:
    """Host augmentation of a raw uint8 dataset to fixed-size uint8 crops;
    the f32 widen and mean subtraction happen on the device
    (:func:`~ccnet_tpu_torch.data.preprocess.finish_u8_crops`). Draws are
    deterministic per ``(seed, epoch, index)`` and re-drawn every epoch.

    ``engine``: ``"cv2"`` resizes the whole image, then crops
    (:func:`~ccnet_tpu_torch.data.preprocess.host_augment_u8`, the
    reference's cv2 chain); ``"native"`` samples only the crop window in
    the C++/OpenMP library (:mod:`ccnet_tpu_torch.native`), with the same
    half-pixel semantics and ±1 uint8 rounding against cv2's fixed point;
    ``"auto"`` takes native when the library builds. Both engines consume
    the same rng stream (scale, oy, ox, mirror), so their geometry is the
    same. An explicit ``"native"`` raises at the first sample when the
    library does not build."""

    def __init__(self, dataset, crop_hw=(769, 769), mean=None, scale: bool = True,
                 mirror: bool = True, ignore_label: int = 255, scale_min: float = 0.7,
                 scale_steps: int = 15, seed: int = 0, engine: str = "auto"):
        from ccnet_tpu_torch.data.preprocess import CITYSCAPES_MEAN_BGR

        self.dataset = dataset
        self.crop_hw = crop_hw
        self.mean = CITYSCAPES_MEAN_BGR if mean is None else mean
        self.scale, self.mirror = scale, mirror
        self.ignore_label = ignore_label
        self.scale_min, self.scale_steps = scale_min, scale_steps
        self.seed = seed
        self.epoch = 0
        if engine == "auto":
            from ccnet_tpu_torch import native

            engine = "native" if native.available() else "cv2"
        if engine not in ("native", "cv2"):
            raise ValueError(f"unknown engine {engine!r}")
        self.engine = engine
        self._identity_lut = np.arange(256, dtype=np.uint8)

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self):
        return len(self.dataset)

    def name(self, index):
        return self.dataset.name(index)

    def __getitem__(self, index):
        image, label, name = self.dataset[index]
        rng = _epoch_rng(self.seed, self.epoch, index)
        if self.engine == "native":
            img, lbl = self._augment_native(image, label, rng)
        else:
            from ccnet_tpu_torch.data.preprocess import host_augment_u8

            img, lbl = host_augment_u8(
                image, label, rng, crop_hw=self.crop_hw, mean=self.mean,
                ignore_label=self.ignore_label, scale=self.scale, mirror=self.mirror,
                scale_min=self.scale_min, scale_steps=self.scale_steps)
        return img, lbl, name

    def _augment_native(self, image, label, rng):
        """The draws of ``host_augment_u8``, in its order, then the library."""
        from ccnet_tpu_torch import native
        from ccnet_tpu_torch.data.preprocess import SCALE_STEP, scaled_size

        ch, cw = self.crop_hw
        H0, W0 = label.shape
        f = (self.scale_min + SCALE_STEP * rng.randint(0, self.scale_steps)
             if self.scale else 1.0)
        sh, sw = scaled_size(H0, f), scaled_size(W0, f)
        oy = rng.randint(0, max(sh, ch) - ch + 1)
        ox = rng.randint(0, max(sw, cw) - cw + 1)
        flip = rng.randint(0, 2) if self.mirror else 0
        imgs, lbls = native.augment_batch_u8(
            image[None], label[None], self._identity_lut, np.asarray([f], np.float32),
            np.asarray([[oy, ox]], np.int32), np.asarray([flip], np.uint8), (ch, cw),
            self.mean, self.ignore_label)
        return imgs[0], lbls[0]


def _default_cache_bytes() -> int:
    """Byte budget from ``CCNET_TPU_CACHE_GB`` (default 8 GB, 0 = no cap):
    full Cityscapes train in uint8 is ~25 GB of host RAM."""
    return int(float(os.environ.get("CCNET_TPU_CACHE_GB", "8")) * (1 << 30))


class CachedDataset:
    """Decode-once RAM cache around any ``(image, label, name)`` dataset.

    The first access of a sample pays the decode; later epochs serve the
    raw arrays from memory. Keyed by sample name, so a file repeated under
    several indices is one entry. Bounded by ``max_bytes`` (default the
    ``CCNET_TPU_CACHE_GB`` budget) and ``max_items``; once a cap is hit,
    further samples are served uncached and one warning says so. Safe for
    the loader's worker threads: the check of the caps and the insert hold a
    lock (a racing double decode is benign)."""

    def __init__(self, dataset, max_items: Optional[int] = None,
                 max_bytes: Optional[int] = None):
        self.dataset = dataset
        self.max_items = max_items
        self.max_bytes = _default_cache_bytes() if max_bytes is None else max_bytes
        self._cache: dict = {}
        self._bytes = 0
        self._warned_full = False
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.dataset)

    def name(self, index: int) -> str:
        return self.dataset.name(index)

    @staticmethod
    def _item_bytes(item) -> int:
        return sum(int(a.nbytes) for a in item if hasattr(a, "nbytes"))

    def _has_room(self, nbytes: int) -> bool:
        if self.max_items is not None and len(self._cache) >= self.max_items:
            return False
        return not (self.max_bytes and self._bytes + nbytes > self.max_bytes)

    def __getitem__(self, index: int):
        key = self.dataset.name(index)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        item = self.dataset[index]
        nbytes = self._item_bytes(item)
        with self._lock:
            if key in self._cache:
                return self._cache[key]
            if self._has_room(nbytes):
                self._cache[key] = item
                self._bytes += nbytes
                return item
            warn, self._warned_full = not self._warned_full, True
        if warn:
            logger.warning(
                f"decoded-sample cache full after {len(self._cache)} samples "
                f"({self._bytes / 2**30:.1f} GB; caps: max_bytes={self.max_bytes}, "
                f"max_items={self.max_items}) — further samples decode per epoch. Raise "
                f"CCNET_TPU_CACHE_GB (0 = unbounded) to cache the full set.")
        return item


class DataLoader:
    """Iterates ``(images, labels, names)`` batches of stacked host arrays.

    The epoch's order is ``RandomState(seed + epoch).permutation(n)`` with
    ``shuffle``, else ``0..n-1``, strided by ``process_index`` over
    ``process_count`` (by default the rank and world size of the live
    group, 0 and 1 without one); ``batch_size`` is this process's share;
    ``drop_last`` drops the short tail batch. A producer
    thread submits sample decodes to ``num_workers`` threads up to
    ``decode_ahead`` samples (default ``(prefetch + 1) * batch_size``) past
    the consume point, across batch boundaries, and queues up to
    ``prefetch`` stacked batches. A decode error is raised at the
    consumer's ``next()``; an iteration the consumer abandons stops its
    threads without waiting for the queued decodes."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: int = 8, drop_last: bool = True, prefetch: int = 2,
                 decode_ahead: Optional[int] = None, process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        rank, size = world()
        process_index = rank if process_index is None else process_index
        process_count = size if process_count is None else process_count
        if not 0 <= process_index < process_count:
            raise ValueError(f"process_index {process_index} not in [0, {process_count})")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.prefetch = prefetch
        # the decoded samples in flight past the consume point, which bound
        # the host memory the lookahead pins
        self.decode_ahead = (decode_ahead if decode_ahead is not None
                             else (prefetch + 1) * batch_size)
        self.process_index = process_index
        self.process_count = process_count
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        set_ds_epoch = getattr(self.dataset, "set_epoch", None)
        if set_ds_epoch is not None:  # augmenting datasets re-draw per epoch
            set_ds_epoch(epoch)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            order = np.random.RandomState(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        return order[self.process_index::self.process_count]

    def __len__(self):
        n = len(self._order())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        order = self._order()
        n_batches = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            ex = ThreadPoolExecutor(max_workers=self.num_workers)
            try:
                flat = list(order[:min(len(order), n_batches * self.batch_size)])
                futures: dict = {}
                submitted = pos = 0
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    while submitted < len(flat) and submitted < pos + self.decode_ahead:
                        futures[submitted] = ex.submit(self.dataset.__getitem__,
                                                       flat[submitted])
                        submitted += 1
                    count = min(self.batch_size, len(flat) - b * self.batch_size)
                    samples = []
                    for _ in range(count):
                        samples.append(futures.pop(pos).result())
                        pos += 1
                    q.put((np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]),
                           [s[2] for s in samples]))
            except Exception as e:  # noqa: BLE001 - re-raised at the consumer
                q.put(e)
            finally:
                # do not wait for lookahead decodes whose results nobody reads
                ex.shutdown(wait=False, cancel_futures=True)
                q.put(None)

        t = threading.Thread(target=producer, daemon=True, name="ccnet-loader-producer")
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            _shutdown_pipeline(q, t, stop)


def device_prefetch(iterator, place_fn, depth: int = 2):
    """Place batch i+1 while the consumer works on batch i.

    A producer thread pulls ``(images, labels, names)`` from ``iterator``
    and queues ``(*place_fn(images, labels), names)`` up to ``depth``
    batches ahead. ``stop`` is checked before each pull, so an abandoned
    iteration decodes and places no further batch. Errors of the iterator
    or of ``place_fn`` are raised at the consumer's ``next()``."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        it = None
        try:
            it = iter(iterator)
            while not stop.is_set():
                try:
                    images, labels, names = next(it)
                except StopIteration:
                    return
                if stop.is_set():
                    return
                q.put((*place_fn(images, labels), names))
        except Exception as e:  # noqa: BLE001 - re-raised at the consumer
            q.put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:  # stop the loader's own threads now
                close()
            q.put(None)

    t = threading.Thread(target=producer, daemon=True, name="ccnet-prefetch-producer")
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        _shutdown_pipeline(q, t, stop)


class Transfer:
    """Tensors whose host→device copy may still be in flight on a side
    stream. :meth:`wait` (on the consumer's thread) makes the consumer's
    current stream wait for the copy, records the tensors' use on that
    stream for the caching allocator, and returns them."""

    def __init__(self, tensors: tuple, done=None):
        self.tensors, self.done = tensors, done

    def wait(self) -> tuple:
        if self.done is not None:
            stream = torch.cuda.current_stream(self.tensors[0].device)
            stream.wait_event(self.done)
            for t in self.tensors:
                t.record_stream(stream)
            self.done = None
        return self.tensors


class HostToDevice:
    """Copies host arrays to ``device``, as :func:`device_prefetch`'s
    placement: ``copier(*arrays)`` returns a :class:`Transfer`.

    On the CPU the tensors are ``torch.from_numpy`` views of the arrays. On
    a CUDA device each array is copied into a pinned host buffer
    (``np.copyto``; ``depth + 1`` buffers per shape and dtype in rotation,
    one reused only after its last copy's event has completed) and from
    there to the device on a side stream, which the calling thread enters
    with its device (both are per thread); an event marks the copy's end.
    Without a card, a CUDA ``device`` raises here."""

    def __init__(self, device, depth: int = 2):
        self.device = torch.device(device)
        self.slots = depth + 1
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(self.device)
            self._buffers: dict = {}  # (shape, dtype) -> [next slot, [[pinned, event]]]

    def _buffer(self, a: np.ndarray) -> torch.Tensor:
        key = (a.shape, a.dtype.str)
        ring = self._buffers.setdefault(key, [0, []])
        i = ring[0]
        ring[0] = (i + 1) % self.slots
        if i == len(ring[1]):
            dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
            ring[1].append([torch.empty(a.shape, dtype=dtype, pin_memory=True), None])
        slot = ring[1][i]
        if slot[1] is not None:
            slot[1].synchronize()  # its last copy has left the buffer
        return slot

    def __call__(self, *arrays) -> Transfer:
        arrays = [np.ascontiguousarray(a) for a in arrays]
        if self.device.type != "cuda":
            return Transfer(tuple(torch.from_numpy(a) for a in arrays))
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            slots, out = [], []
            for a in arrays:
                slot = self._buffer(a)
                np.copyto(slot[0].numpy(), a)
                dev = torch.empty(a.shape, dtype=slot[0].dtype, device=self.device)
                dev.copy_(slot[0], non_blocking=True)
                slots.append(slot)
                out.append(dev)
            done = torch.cuda.Event()
            done.record(self.stream)
        for slot in slots:
            slot[1] = done
        return Transfer(tuple(out), done)
