"""Training state: the model, its optimizer and LR schedule, and the step.

Counterpart of :mod:`ccnet_tpu.train.state`. Where the JAX package keeps
params, batch stats and optimizer state as one immutable pytree, the port
keeps the ``nn.Module`` (parameters and BN running stats), the
``torch.optim.SGD`` (momentum buffers) and the ``LambdaLR`` schedule, which
the train step updates in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ccnet_tpu_torch.train.optim import make_optimizer


@dataclass
class TrainState:
    step: int
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler


def create_train_state(model: torch.nn.Module, base_lr: float = 1e-2, max_steps: int = 60000,
                       power: float = 0.9, momentum: float = 0.9,
                       weight_decay: float = 1e-4) -> TrainState:
    """A step-0 state over ``model``, which is put in train mode."""
    optimizer, scheduler = make_optimizer(model.parameters(), base_lr, max_steps, power,
                                          momentum, weight_decay)
    return TrainState(step=0, model=model.train(), optimizer=optimizer, scheduler=scheduler)
