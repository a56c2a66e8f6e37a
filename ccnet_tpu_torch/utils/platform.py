"""Device resolution and the Hopper check.

Counterpart of :mod:`ccnet_tpu.utils.platform`. Where the JAX package asks
"is the default backend a TPU?" to gate its Pallas routes, the port asks of
each tensor where it lives: a CUDA tensor goes to the hand-written kernels,
a CPU tensor to their plain-torch versions. :func:`is_hopper` says whether
the card is the one the kernels are compiled for (``sm_90a``).
"""

from __future__ import annotations

import torch


def resolve_device(name: str) -> torch.device:
    """``"cuda"``, ``"cuda:N"`` or ``"cpu"`` → a ``torch.device``.

    Raises when CUDA is asked for and absent: there is no quiet CPU fallback.
    """
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {name!r} requested but CUDA is not available")
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"device {name!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s) exist")
        return torch.device("cuda", index)
    if device.type != "cpu":
        raise ValueError(f"unsupported device {name!r}; use 'cuda[:N]' or 'cpu'")
    return device


def is_hopper(device: torch.device | None = None) -> bool:
    """True on a CUDA device of compute capability (9, 0) (H100/H200)."""
    if not torch.cuda.is_available():
        return False
    return torch.cuda.get_device_capability(device) == (9, 0)
