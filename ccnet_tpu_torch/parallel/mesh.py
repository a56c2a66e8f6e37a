"""What the JAX package's device mesh meant, in PyTorch's idiom.

Counterpart of :mod:`ccnet_tpu.parallel.mesh`. There one ``jit`` runs over a
mesh with the global batch sharded over its ``data`` axis, and XLA inserts
every collective: the gradient mean, the BN moments, the OHEM counts and
the loss means are reductions over the global batch. Here each rank holds
one share of the global batch and the code that reduces over the batch
calls :func:`all_reduce_sum`:

* :func:`rank_slice` — a rank's share of a global batch; the shares
  concatenated in rank order are the global batch, as ``_put`` assembles it
  from the processes' local data;
* :func:`all_reduce_sum` — a sum over the ranks, the identity on one;
* :func:`data_parallel` — the model's replicas, their parameters broadcast
  from rank 0 and their gradients averaged
  (``torch.nn.parallel.DistributedDataParallel``);
* :func:`rank_gather` — every rank's tensor in rank order, where a
  function reads the whole batch (the Lovász losses' sort);
* :class:`RankOrder` — a dataset reordered so that one process loads the
  global batches N ranks load, the one-process reference of an N-rank run.

The ``space`` axis: the ranks form a ``(data, space)`` grid, rank ``r`` at
``(r // space, r % space)`` as ``make_mesh`` reshapes the devices
(:func:`grid`). ``--whole --space N`` inference splits each image's rows
over the ranks of a space group (:func:`space_group`,
:mod:`~ccnet_tpu_torch.parallel.spatial`) and the images over the data
groups; training folds ``space`` into data parallelism, as the JAX
package's ``batch_sharding`` puts the batch over ``(data, space)``: the
batch is sharded over all ranks and nothing else changes.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ccnet_tpu_torch.parallel.distributed import world
from ccnet_tpu_torch.parallel.spatial import SpaceGroup


def rank_slice(t: torch.Tensor, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s share of the global batch ``t`` (dim 0) over ``size``
    ranks: rows ``[rank·B/size, (rank+1)·B/size)``. Raises when B does not
    divide over the ranks."""
    if t.shape[0] % size:
        raise ValueError(f"global batch {t.shape[0]} does not divide over {size} ranks")
    n = t.shape[0] // size
    return t[rank * n:(rank + 1) * n]


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks of the live group, in a new tensor; ``t``
    itself at world size 1. Not differentiable: callers reduce statistics
    and counts, and :class:`~ccnet_tpu_torch.nn.layers.ABN` reduces its
    gradient sums in its own backward."""
    if world()[1] == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def rank_gather(t: torch.Tensor) -> torch.Tensor:
    """``t`` of every rank (one shape on all), concatenated along dim 0 in
    rank order, detached: one ``all_reduce`` of zero-filled slots. ``t``
    itself, detached, at world size 1."""
    rank, size = world()
    if size == 1:
        return t.detach()
    buf = t.new_zeros((size, *t.shape))
    buf[rank] = t.detach()
    dist.all_reduce(buf)
    return buf.reshape(size * t.shape[0], *t.shape[1:])


def grid(space: int = 1) -> tuple:
    """``(data index, data count, space index)`` of this rank in the
    ``(data, space)`` grid of the live group (rank ``r`` at ``(r // space,
    r % space)``). Raises ValueError where ``space`` does not divide the
    ranks."""
    rank, size = world()
    if space < 1 or size % space:
        raise ValueError(f"{size} rank(s) not divisible by space={space}")
    return rank // space, size // space, rank % space


def space_group(space: int) -> SpaceGroup:
    """This rank's :class:`~ccnet_tpu_torch.parallel.spatial.SpaceGroup` of
    the grid of :func:`grid`: ranks ``[d·space, (d+1)·space)`` for data
    index ``d``. Every rank creates every group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    data, count, index = grid(space)
    groups = [dist.new_group(list(range(d * space, (d + 1) * space))) for d in range(count)]
    return SpaceGroup(groups[data], index, space)


def data_parallel(model: torch.nn.Module) -> torch.nn.Module:
    """The module that runs ``model``'s forward in the train step: ``model``
    itself at world size 1, else its ``DistributedDataParallel`` replica on
    the model's device (parameters and buffers broadcast from rank 0 now;
    gradients averaged over the ranks in the backward). Buffers are not
    broadcast again at each forward: the BN running stats are updated from
    the global moments, the same on every rank."""
    if world()[1] == 1:
        return model
    device = next(model.parameters()).device
    return torch.nn.parallel.DistributedDataParallel(
        model, device_ids=[device.index] if device.type == "cuda" else None,
        broadcast_buffers=False)


class RankOrder:
    """``dataset`` reordered so that a one-process shuffling
    :class:`~ccnet_tpu_torch.data.DataLoader` of batch ``batch`` and seed
    ``seed`` yields, in epoch 0, the global batches of ``ranks`` ranks: each
    rank loads a strided share of the epoch's order, and the shares in rank
    order make the global batch (rank r's j-th sample of batch b is
    ``order[b·batch + r + ranks·j]``)."""

    def __init__(self, dataset, batch: int, ranks: int, seed: int):
        from ccnet_tpu_torch.data import DataLoader

        order = DataLoader(dataset, batch, seed=seed, process_index=0, process_count=1)._order()
        self.index = np.arange(len(dataset))
        share = batch // ranks
        for b in range(len(order) // batch):
            chunk = order[b * batch:(b + 1) * batch]
            self.index[chunk] = [chunk[r + ranks * j] for r in range(ranks) for j in range(share)]
        self.dataset = dataset

    def __len__(self) -> int:
        return len(self.dataset)

    def __getitem__(self, index: int):
        return self.dataset[self.index[index]]
