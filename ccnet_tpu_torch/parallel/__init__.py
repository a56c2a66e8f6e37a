from ccnet_tpu_torch.parallel.distributed import (
    choose_backend,
    is_primary_host,
    maybe_initialize_distributed,
    rank_device,
    world,
)
from ccnet_tpu_torch.parallel.mesh import RankOrder, all_reduce_sum, data_parallel, rank_slice

__all__ = [
    "RankOrder",
    "all_reduce_sum",
    "choose_backend",
    "data_parallel",
    "is_primary_host",
    "maybe_initialize_distributed",
    "rank_device",
    "rank_slice",
    "world",
]
