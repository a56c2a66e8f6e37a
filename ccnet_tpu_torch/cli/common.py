"""Shared CLI plumbing. Counterpart of :mod:`ccnet_tpu.cli.common`.

The entry points run one process per card: alone on one card, or N of them
under torchrun (:mod:`ccnet_tpu_torch.parallel`). :func:`resolve_space`
turns ``--whole --space N`` into the ranks' ``(data, space)`` layout for
``cli.evaluate`` and ``cli.predict``, with the JAX CLIs' exits."""

from __future__ import annotations

import torch

from ccnet_tpu_torch.models.registry import MODELS
from ccnet_tpu_torch.parallel.distributed import world
from ccnet_tpu_torch.parallel.mesh import grid, space_group


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


def check_data_parallel(data_parallel: bool, groups: int) -> None:
    """``--data-parallel 0`` over several data groups would have every group
    score every image (``cli.evaluate``, ``cli.predict``): exit and ask for
    one group (one process, or the ranks of one space group)."""
    if not data_parallel and groups > 1:
        raise SystemExit(f"--data-parallel 0 asks for one process, but {groups} groups of "
                         "ranks run: launch without torchrun, or give --space the number of ranks")


def resolve_space(args, logger):
    """``--space`` / ``--whole`` → ``(space group or None, data index, data
    count)``: the port of ``resolve_inference_mesh``. ``--space N`` without
    ``--whole`` exits, and so does an N that does not divide the ranks (so
    ``--space 2`` in one process exits, as the JAX CLI does on one device).
    ``--whole --space N`` splits each image's rows over the N ranks of a
    space group (convolutions exchange halo rows, the criss-cross attention
    gathers q, k and v) and the images over the ``world / N`` data groups;
    ``--space 1`` shards the images over all ranks. ``--space N > 1`` with a
    model that is not ``height_shardable`` (DANet) raises ValueError."""
    if args.space > 1:
        MODELS[args.model].check_shardable()
    if args.space > 1 and not args.whole:
        raise SystemExit("--space N applies to --whole inference only "
                         "(sliding mode shards the images over the ranks instead: "
                         "--data-parallel, the default)")
    size = world()[1]
    if args.space < 1 or size % args.space:
        raise SystemExit(f"--space {args.space} must divide the {size} rank(s)")
    data, count, _ = grid(args.space)
    if args.space == 1:
        return None, data, count
    group = space_group(args.space)
    logger.info(f"--whole --space {args.space}: ranks as (data {count}, space {args.space}); "
                "image height over 'space' (convolutions exchange halo rows, the criss-cross "
                "attention gathers q, k, v), images over 'data'")
    return group, data, count
