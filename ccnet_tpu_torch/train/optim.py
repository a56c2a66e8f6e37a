"""Optimizer: SGD with momentum and weight decay + the poly LR schedule.

Counterpart of :mod:`ccnet_tpu.train.optim`: ``base_lr * (1 −
step/max_steps)^power``, SGD momentum 0.9, weight decay 1e-4 by default.
``torch.optim.SGD`` adds the decay to the gradient before the momentum
accumulation (``g += wd·p; buf = mu·buf + g; p −= lr·buf``), as the JAX
package's ``add_decayed_weights`` ahead of ``sgd`` does, and the decay
applies to every parameter (BN affine and ``gamma`` included), as optax's
unmasked ``add_decayed_weights`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch


def poly_lambda(max_steps: int, power: float = 0.9):
    """The LR factor of step ``step``: ``(1 − step/max_steps)^power``."""

    def factor(step: int) -> float:
        return (1.0 - step / max_steps) ** power

    return factor


def make_optimizer(params, base_lr: float = 1e-2, max_steps: int = 60000, power: float = 0.9,
                   momentum: float = 0.9, weight_decay: float = 1e-4
                   ) -> Tuple[torch.optim.SGD, torch.optim.lr_scheduler.LambdaLR]:
    """``(SGD over params, LambdaLR poly schedule)``; step the scheduler
    once after each optimizer step."""
    optimizer = torch.optim.SGD(params, lr=base_lr, momentum=momentum,
                                weight_decay=weight_decay)
    scheduler = torch.optim.lr_scheduler.LambdaLR(optimizer, poly_lambda(max_steps, power))
    return optimizer, scheduler
