"""The training step: forward in train mode, criterion, backward, SGD update.

Counterpart of :mod:`ccnet_tpu.train.step`. PyTorch runs it eagerly: no
``jit``, no state donation and no mesh. BN layers use the batch statistics
and update their running stats in the forward; the criterion sees
``{'main', 'aux'}``; the loss stays on the device.

Over N ranks the step takes the rank's share of the global batch and runs
``forward``, the model's ``DistributedDataParallel`` replica
(:func:`~ccnet_tpu_torch.parallel.mesh.data_parallel`). The criterion
returns the rank's share of the global loss, whose shares sum to the loss
of the global batch. DDP averages the ranks' gradients, so the step
back-propagates N times the share: the average is then the gradient of the
global loss, which the one-process step on the global batch computes. The
returned loss is the shares summed over the ranks.

Its phases are the spans ``train.forward`` (train mode, the RNG fork and
the model), ``train.loss``, ``train.backward`` and ``train.optimizer``
(zeroing the grads, the SGD update and the schedule) of :mod:`~ccnet_tpu_torch.utils.trace`; each step
counts ``train.steps`` and, over N ranks, DDP's gradient all-reduce.

Dropout draws from the default generator of the model's device, seeded in
a forked RNG state from ``(seed, step)``, so every step draws fresh noise,
runs are reproducible, and the process's global RNG is left as it was
(the JAX package folds the step into its dropout key).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.nn.parallel import DistributedDataParallel

from ccnet_tpu_torch.parallel.distributed import world
from ccnet_tpu_torch.parallel.mesh import all_reduce_sum, count_grad_all_reduce
from ccnet_tpu_torch.train.state import TrainState
from ccnet_tpu_torch.utils.trace import count, span


def make_train_step(criterion: Callable, seed: int = 0,
                    forward: Optional[torch.nn.Module] = None) -> Callable:
    """``train_step(state, images (B, 3, H, W), labels (B, H, W)) -> {"loss"}``;
    updates ``state`` in place. ``forward`` runs the model's forward
    (default ``state.model``; over N ranks its DDP replica)."""
    replica = forward if isinstance(forward, DistributedDataParallel) else None

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model if forward is None else forward
        size = world()[1]
        with span("train.optimizer"):
            state.optimizer.zero_grad(set_to_none=True)
        devices = [images.device] if images.device.type == "cuda" else []
        with span("train.forward"), torch.random.fork_rng(devices=devices):
            torch.manual_seed((seed * 1000003 + state.step) % (2 ** 63))
            outputs = model.train()(images)
        with span("train.loss"):
            loss = criterion(outputs, labels)
        with span("train.backward"):
            (loss * size if size > 1 else loss).backward()
        if replica is not None:
            count_grad_all_reduce(replica)
        with span("train.optimizer"):
            state.optimizer.step()
            state.scheduler.step()
        state.step += 1
        count("train.steps")
        return {"loss": all_reduce_sum(loss.detach(), "loss")}

    return train_step
