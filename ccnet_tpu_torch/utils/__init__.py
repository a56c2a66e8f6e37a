from ccnet_tpu_torch.utils.checkpoint import (
    jax_variables_to_state_dict,
    latest_checkpoint_step,
    load_pth,
    restore_checkpoint,
    save_checkpoint,
    save_pth,
)
from ccnet_tpu_torch.utils.logging import get_logger
from ccnet_tpu_torch.utils.platform import is_hopper, resolve_device

__all__ = [
    "get_logger",
    "is_hopper",
    "jax_variables_to_state_dict",
    "latest_checkpoint_step",
    "load_pth",
    "resolve_device",
    "restore_checkpoint",
    "save_checkpoint",
    "save_pth",
]
