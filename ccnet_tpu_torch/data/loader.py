"""Host data: the synthetic dataset and a plain sequential batch iterator.

:class:`SyntheticDataset` is a copy of the JAX package's (same seeds, same
samples). :class:`DataLoader` is a sequential stand-in for the JAX
package's threaded loader: it stacks ``batch_size`` samples at a time, in
order, with no worker threads, shuffling or multi-process sharding (those
come with the training and multi-GPU ports).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np


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


class DataLoader:
    """Iterates ``(images, labels, names)`` batches of stacked host arrays, in order."""

    def __init__(self, dataset, batch_size: int, drop_last: bool = False):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        self.dataset = dataset
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator:
        for b in range(len(self)):
            lo = b * self.batch_size
            samples = [self.dataset[i]
                       for i in range(lo, min(lo + self.batch_size, len(self.dataset)))]
            yield (np.stack([s[0] for s in samples]), np.stack([s[1] for s in samples]),
                   [s[2] for s in samples])
