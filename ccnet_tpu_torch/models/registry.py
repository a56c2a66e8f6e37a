"""Model registry — explicit name→builder mapping.

Counterpart of :mod:`ccnet_tpu.models.registry`: ``ccnet``, ``pspnet`` and
``deeplabv3``, and the port's own ``danet`` (which the JAX package does not
build). The heads without criss-cross attention accept and ignore
``recurrence`` and ``impl``, as the JAX registry does.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ccnet_tpu_torch.models.ccnet import CCNet
from ccnet_tpu_torch.models.danet import DANet
from ccnet_tpu_torch.models.deeplabv3 import DeepLabV3
from ccnet_tpu_torch.models.pspnet import PSPNet

#: Every model the port builds, by the name the CLIs' ``--model`` takes.
MODELS = {"ccnet": CCNet, "pspnet": PSPNet, "deeplabv3": DeepLabV3, "danet": DANet}
_DEPTH_LAYERS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def build_model(name: str, num_classes: int = 19, recurrence: int = 2, depth: int = 101,
                dtype=torch.float32, impl: str = "auto", seed: int = 0,
                device: torch.device | str = "cpu", drop_rate: float = 0.1,
                remat: Any = False):
    """Build a segmentation model by name, its initial weights drawn from
    ``seed`` (without touching the global torch generator), in eval mode on
    ``device``. ``remat``: the backbone's activation recompute in training
    (:func:`~ccnet_tpu_torch.models.backbone.remat_plan`)."""
    if depth not in _DEPTH_LAYERS:
        raise ValueError(f"unknown depth {depth}; available: {sorted(_DEPTH_LAYERS)}")
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; available: {', '.join(MODELS)}")
    extra = {"recurrence": recurrence, "impl": impl} if name == "ccnet" else {}
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = MODELS[name](num_classes=num_classes, layers=_DEPTH_LAYERS[depth],
                             drop_rate=drop_rate, dtype=dtype, remat=remat, **extra)
    return model.eval().to(device)


def randomize_(model: torch.nn.Module, seed: int = 0) -> None:
    """Seeded perturbation of ``model``'s weights in place, for checks that
    need every part of the network to matter: gamma = 0.5, BN running stats
    and every 1-D parameter (BN weight/bias, conv bias) perturbed, so the
    attention path and every BN move the logits."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("gamma"):
                t.fill_(0.5)
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif t.dim() == 1:
                t.add_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1).to(t))
