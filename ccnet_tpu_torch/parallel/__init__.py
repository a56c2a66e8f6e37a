from ccnet_tpu_torch.parallel.distributed import (
    choose_backend,
    is_primary_host,
    maybe_initialize_distributed,
    rank_device,
    world,
)
from ccnet_tpu_torch.parallel.mesh import (
    RankOrder,
    all_reduce_sum,
    data_parallel,
    grid,
    rank_gather,
    rank_slice,
    space_group,
)
from ccnet_tpu_torch.parallel.spatial import SpaceGroup

__all__ = [
    "RankOrder",
    "SpaceGroup",
    "all_reduce_sum",
    "choose_backend",
    "data_parallel",
    "grid",
    "is_primary_host",
    "maybe_initialize_distributed",
    "rank_device",
    "rank_gather",
    "rank_slice",
    "space_group",
    "world",
]
