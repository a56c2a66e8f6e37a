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
    count_grad_all_reduce,
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
    "count_grad_all_reduce",
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
