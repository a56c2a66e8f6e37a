"""The training step: forward in train mode, criterion, backward, SGD update.

Counterpart of :mod:`ccnet_tpu.train.step`. PyTorch runs it eagerly: no
``jit``, no state donation and no mesh (one device). BN layers use the
batch statistics and update their running stats in the forward; the
criterion sees ``{'main', 'aux'}``; the loss stays on the device.

Dropout draws from the default generator of the model's device, seeded in
a forked RNG state from ``(seed, step)``, so every step draws fresh noise,
runs are reproducible, and the process's global RNG is left as it was
(the JAX package folds the step into its dropout key).
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from ccnet_tpu_torch.train.state import TrainState


def make_train_step(criterion: Callable, seed: int = 0) -> Callable:
    """``train_step(state, images (B, 3, H, W), labels (B, H, W)) -> {"loss"}``;
    updates ``state`` in place."""

    def train_step(state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor) -> Dict[str, torch.Tensor]:
        model = state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        devices = [images.device] if images.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed((seed * 1000003 + state.step) % (2 ** 63))
            outputs = model(images)
        loss = criterion(outputs, labels)
        loss.backward()
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        return {"loss": loss.detach()}

    return train_step
