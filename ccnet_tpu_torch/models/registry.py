"""Model registry — explicit name→builder mapping.

Counterpart of :mod:`ccnet_tpu.models.registry`. Only CCNet is ported;
PSPNet and DeepLabv3 come later.
"""

from __future__ import annotations

import torch

from ccnet_tpu_torch.models.ccnet import CCNet

_DEPTH_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def build_model(name: str, num_classes: int = 19, recurrence: int = 2, depth: int = 101,
                dtype=torch.float32, impl: str = "auto", seed: int = 0,
                device: torch.device | str = "cpu", drop_rate: float = 0.1):
    """Build a segmentation model by name, its initial weights drawn from
    ``seed`` (without touching the global torch generator), in eval mode on
    ``device``."""
    if depth not in _DEPTH_LAYERS:
        raise ValueError(f"unknown depth {depth}; available: {sorted(_DEPTH_LAYERS)}")
    if name in ("pspnet", "deeplabv3"):
        raise NotImplementedError(f"model {name!r} is not ported yet")
    if name != "ccnet":
        raise ValueError(f"unknown model {name!r}; available: ccnet, pspnet, deeplabv3")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = CCNet(num_classes=num_classes, layers=_DEPTH_LAYERS[depth],
                      recurrence=recurrence, impl=impl, drop_rate=drop_rate, dtype=dtype)
    return model.eval().to(device)
