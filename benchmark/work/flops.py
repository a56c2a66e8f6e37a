"""Model FLOPs of a forward, counted on the plain reference at the cell's
shapes on the meta device with ``torch.utils.flop_counter``, so the count
does not depend on how the program computes the forward (a recomputation
is not counted). A training step counts three forwards."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.reference.models import build


def forward_flops(config: dict, batch: int, hw) -> tuple:
    """``(FLOPs of one forward, shape of its main logits)`` at ``batch``
    images of ``hw``."""
    net = build(config, device="meta")
    x = torch.empty((batch, 3, *hw), device="meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        main, _ = net(x)
    return float(counter.get_total_flops()), tuple(main.shape)


def train_step_flops(config: dict, batch: int, hw) -> float:
    return 3.0 * forward_flops(config, batch, hw)[0]
