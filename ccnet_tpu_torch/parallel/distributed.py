"""Process-group initialisation: one process per card under torchrun.

Counterpart of :mod:`ccnet_tpu.parallel.distributed`. Where the JAX package
runs one process per host and addresses every local device from one ``jit``,
the port runs one process ("rank") per card, launched by
``python -m torch.distributed.run`` (torchrun), which sets ``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``. Every CLI entry point calls
:func:`maybe_initialize_distributed` first:

* **No torchrun variable set** — single process; nothing is initialised and
  everything runs as on one card.
* **torchrun** — ``torch.distributed.init_process_group`` over those
  variables. A failure is a hard error: the user asked for a group.

The backend follows from the layout, with no flag (:func:`choose_backend`):
NCCL when every local rank has a card of its own, gloo when ranks share a
card (NCCL refuses two ranks on one device) or run on the CPU. Gloo reduces
CUDA tensors through the host, so the train and eval paths use only
``all_reduce`` and ``broadcast``, which gloo supports for CUDA tensors.

Set ``CCNET_TPU_NO_DISTRIBUTED=1`` to force single-process mode.
"""

from __future__ import annotations

import os
from typing import Tuple

import torch
import torch.distributed as dist

from ccnet_tpu_torch.utils.platform import resolve_device

# the JAX package's opt-out (ccnet_tpu/parallel/distributed.py), its own copy
NO_DISTRIBUTED_ENV = "CCNET_TPU_NO_DISTRIBUTED"
TORCHRUN_ENV = ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR")


def choose_backend(local_ranks: int, cards: int) -> str:
    """``"nccl"`` when each of the ``local_ranks`` ranks of this host has a
    card of its own among the ``cards`` visible ones, else ``"gloo"`` (ranks
    sharing a card, or ``cards`` = 0 for the CPU)."""
    return "nccl" if 0 < local_ranks <= cards else "gloo"


def world() -> Tuple[int, int]:
    """``(rank, world size)`` of the live process group; ``(0, 1)`` without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary_host() -> bool:
    """True on the rank that writes checkpoints and results (rank 0), and
    in a single process."""
    return world()[0] == 0


def rank_device(name: str = "cuda") -> torch.device:
    """The device of this rank: ``cuda:LOCAL_RANK % device_count`` inside a
    process group, the resolved ``name`` outside one (``cuda``, ``cuda:N``),
    and the CPU when ``name`` asks for it. Raises where CUDA is asked for
    and absent."""
    device = resolve_device(name)
    if device.type == "cuda" and world()[1] > 1:
        return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                            % torch.cuda.device_count())
    return device


def maybe_initialize_distributed(logger=None, device: str = "cuda",
                                 init_method: str = "env://") -> bool:
    """Initialise the process group when torchrun's variables are set.

    Returns True when a group is (or already was) initialised. ``device``
    is the run's ``--device``: ``cpu`` takes gloo. ``init_method`` is
    torchrun's ``env://`` unless a caller gives another rendezvous (a
    ``file://`` path in the tests)."""
    if os.environ.get(NO_DISTRIBUTED_ENV):
        return False
    if dist.is_initialized():
        return True
    if not any(v in os.environ for v in TORCHRUN_ENV):
        return False
    missing = [v for v in ("WORLD_SIZE", "RANK") if v not in os.environ]
    if missing:
        raise RuntimeError(f"torchrun variables incomplete: {', '.join(missing)} not set")
    size = int(os.environ["WORLD_SIZE"])
    rank = int(os.environ["RANK"])
    cuda = torch.device(device).type == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", size))
    backend = choose_backend(local_ranks, cards)
    if cuda:  # the rank's card is the current device before NCCL binds to it
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")) % max(cards, 1))
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=size)
    if logger:
        logger.info(f"torch.distributed initialised: rank {rank}/{size}, backend {backend} "
                    f"({local_ranks} local rank(s), {cards} visible card(s))")
    return True
