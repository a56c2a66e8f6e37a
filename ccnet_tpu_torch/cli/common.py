"""Shared CLI plumbing. Counterpart of :mod:`ccnet_tpu.cli.common`.

The entry points run one process per card: alone on one card, or N of them
under torchrun (:mod:`ccnet_tpu_torch.parallel`). ``--space`` > 1 is checked
in the entry points and raises."""

from __future__ import annotations

import torch

from ccnet_tpu_torch.parallel.distributed import world


def str2bool(v) -> bool:
    return str(v).lower() in ("yes", "true", "t", "1")


def note_unused_cards(logger, device: torch.device, module: str) -> None:
    """Log, for a single process that sees more than one card, that it uses
    one of them and the torchrun line that uses all (the JAX CLIs log
    "using n/N devices")."""
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    if world()[1] == 1 and cards > 1:
        logger.info(f"using 1/{cards} devices ({device}); run one process per card with "
                    f"python -m torch.distributed.run --nproc_per_node {cards} -m {module} ...")


def check_data_parallel(data_parallel: bool) -> None:
    """``--data-parallel 0`` under torchrun would have every rank score every
    image (``cli.evaluate``, ``cli.predict``): exit and ask for one process."""
    if not data_parallel and world()[1] > 1:
        raise SystemExit(f"--data-parallel 0 asks for one process, but {world()[1]} ranks "
                         "run: launch without torchrun")
