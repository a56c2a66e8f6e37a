"""Host data: the synthetic dataset, the uint8-crop dataset and the loader.

Copies of the JAX package's :mod:`ccnet_tpu.data.loader` pieces that the
training and evaluation paths use, with the same seeds and orders:

* :class:`SyntheticDataset` (same samples);
* :class:`U8CropDataset`, host augmentation to uint8 crops with draws
  deterministic per ``(seed, epoch, index)`` (:func:`_epoch_rng`);
* :class:`DataLoader`, the JAX loader's signature and defaults
  (``shuffle=True``, ``drop_last=True``, epoch order
  ``RandomState(seed + epoch).permutation(n)``, :meth:`~DataLoader.set_epoch`
  forwarded to the dataset), single-threaded: the worker threads, the
  decoded-sample cache, ``AugmentingDataset``, ``device_prefetch`` and
  multi-process sharding come later.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


def _epoch_rng(seed: int, epoch: int, index: int) -> np.random.RandomState:
    """The per-(seed, epoch, index) augmentation rng of the JAX package."""
    return np.random.RandomState((seed * 1000003 + epoch * 7919 + index) % (2 ** 31))


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


class U8CropDataset:
    """Host augmentation of a raw uint8 dataset to fixed-size uint8 crops
    (:func:`~ccnet_tpu_torch.data.preprocess.host_augment_u8`, numpy/cv2);
    the f32 widen and mean subtraction happen on the device
    (:func:`~ccnet_tpu_torch.data.preprocess.finish_u8_crops`). Draws are
    deterministic per ``(seed, epoch, index)`` and re-drawn every epoch."""

    def __init__(self, dataset, crop_hw=(769, 769), mean=None, scale: bool = True,
                 mirror: bool = True, ignore_label: int = 255, scale_min: float = 0.7,
                 scale_steps: int = 15, seed: int = 0):
        from ccnet_tpu_torch.data.preprocess import CITYSCAPES_MEAN_BGR

        self.dataset = dataset
        self.crop_hw = crop_hw
        self.mean = CITYSCAPES_MEAN_BGR if mean is None else mean
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
        from ccnet_tpu_torch.data.preprocess import host_augment_u8

        image, label, name = self.dataset[index]
        img, lbl = host_augment_u8(
            image, label, _epoch_rng(self.seed, self.epoch, index), crop_hw=self.crop_hw,
            mean=self.mean, ignore_label=self.ignore_label, scale=self.scale,
            mirror=self.mirror, scale_min=self.scale_min, scale_steps=self.scale_steps)
        return img, lbl, name


class DataLoader:
    """Iterates ``(images, labels, names)`` batches of stacked host arrays.

    The epoch's order is ``RandomState(seed + epoch).permutation(n)`` with
    ``shuffle``, else ``0..n-1``; ``drop_last`` drops the short tail batch.
    Samples are read in the calling thread."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = True):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        set_ds_epoch = getattr(self.dataset, "set_epoch", None)
        if set_ds_epoch is not None:  # augmenting datasets re-draw per epoch
            set_ds_epoch(epoch)

    def _order(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            return np.random.RandomState(self.seed + self.epoch).permutation(n)
        return np.arange(n)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        order = self._order()
        for b in range(len(self)):
            samples = [self.dataset[int(i)]
                       for i in order[b * self.batch_size:(b + 1) * self.batch_size]]
            yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]),
                   [s[2] for s in samples])
