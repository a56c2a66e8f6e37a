"""Weights across the two packages: flax variables → state_dict, ``.pth`` load.

Counterpart of the ``.pth`` half of :mod:`ccnet_tpu.utils.checkpoint`:

* :func:`jax_variables_to_state_dict` takes the JAX model's variables as
  nested dicts of numpy arrays (``{'params': ..., 'batch_stats': ...}``)
  and returns the port's state_dict, with the same name mapping as the JAX
  package's ``.pth`` export and conv kernels transposed HWIO → OIHW. It
  needs no jax: the caller converts the arrays.
* :func:`load_pth` loads a reference-named ``.pth`` into a model with the
  reference's lenient ``load_model`` semantics (``utils/pyt_utils.py:47-85``):
  a ``'model'`` wrapper is unwrapped, ``module.`` prefixes are stripped, and
  missing / unexpected keys are reported, raising only under ``strict``.

Only CCNet's modules are mapped; PSPNet/DeepLabv3 come with their port.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

from ccnet_tpu_torch.utils.logging import get_logger

logger = get_logger("ccnet_tpu_torch.checkpoint")

_LAYER_RE = re.compile(r"^layer(\d+)_(\d+)$")

# RCCA head Sequential-index mapping (reference networks/ccnet.py:99-114)
_RCCA_MAP = {
    "conva_conv": "head.conva.0", "conva_bn": "head.conva.1",
    "convb_conv": "head.convb.0", "convb_bn": "head.convb.1",
    "bottleneck_conv": "head.bottleneck.0", "bottleneck_bn": "head.bottleneck.1",
    "classifier": "head.bottleneck.3",
}
_DSN_MAP = {"conv": "dsn.0", "bn": "dsn.1", "classifier": "dsn.3"}


def _module_to_torch(mods: Tuple[str, ...]) -> str:
    """Map a flax module path (without the leaf) to the torch module name."""
    top = mods[0]
    if top == "backbone":
        parts = []
        for m in mods[1:]:
            lm = _LAYER_RE.match(m)
            if lm:
                parts.append(f"layer{lm.group(1)}.{lm.group(2)}")
            elif m == "downsample_conv":
                parts.append("downsample.0")
            elif m == "downsample_bn":
                parts.append("downsample.1")
            else:
                parts.append(m)
        return ".".join(parts)
    if top == "dsn":
        return _DSN_MAP[mods[1]]
    if top == "head":
        if mods[1] == "cca":
            return "head.cca." + ".".join(mods[2:]) if len(mods) > 2 else "head.cca"
        return _RCCA_MAP[mods[1]]
    if top in ("psp", "aspp", "classifier"):
        raise NotImplementedError(f"flax module path {mods}: PSPNet/DeepLabv3 are not ported yet")
    raise KeyError(f"no torch mapping for flax module path {mods}")


def flax_path_to_torch_key(path: Tuple[str, ...]) -> str:
    *mods, leaf = path
    return f"{_module_to_torch(tuple(mods))}.{leaf}"


def jax_variables_to_state_dict(variables) -> Dict[str, torch.Tensor]:
    """Flax ``{'params', 'batch_stats'}`` (nested dicts of numpy) → state_dict."""
    out: Dict[str, torch.Tensor] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
                continue
            arr = np.asarray(v)
            if k == "weight" and arr.ndim == 4:  # conv HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            out[flax_path_to_torch_key(prefix + (k,))] = torch.from_numpy(
                np.ascontiguousarray(arr).copy())

    walk(variables["params"], ())
    walk(variables.get("batch_stats", {}), ())
    return out


def _normalise_keys(state_dict) -> Dict[str, torch.Tensor]:
    """Unwrap ``{'model': ...}``, strip ``module.`` prefixes, keep tensors."""
    if "model" in state_dict and isinstance(state_dict["model"], dict):
        state_dict = state_dict["model"]
    out = {}
    for k, v in state_dict.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if isinstance(v, torch.Tensor):
            out[k] = v
        elif isinstance(v, np.ndarray):
            out[k] = torch.from_numpy(v)
    return out


def load_pth(path: str, model: torch.nn.Module,
             strict: bool = False) -> Tuple[List[str], List[str]]:
    """Load a reference-named ``.pth`` into ``model``; returns (missing, unexpected)."""
    sd = _normalise_keys(torch.load(path, map_location="cpu", weights_only=False))
    result = model.load_state_dict(sd, strict=False)
    missing, unexpected = list(result.missing_keys), list(result.unexpected_keys)
    if missing:
        logger.warning(f"{len(missing)} keys missing from checkpoint, e.g. {missing[:5]}")
    if unexpected:
        logger.warning(f"{len(unexpected)} unexpected checkpoint keys, e.g. {unexpected[:5]}")
    if strict and (missing or unexpected):
        raise KeyError(f"strict load failed: missing={missing[:10]} unexpected={unexpected[:10]}")
    return missing, unexpected
