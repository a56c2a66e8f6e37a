"""Checkpoints: ``.pth`` weights in the reference's names, and full train state.

Counterpart of :mod:`ccnet_tpu.utils.checkpoint`:

* :func:`jax_variables_to_state_dict` takes the JAX model's variables as
  nested dicts of numpy arrays (``{'params': ..., 'batch_stats': ...}``)
  and returns the port's state_dict, with the same name mapping as the JAX
  package's ``.pth`` export and conv kernels transposed HWIO → OIHW. It
  needs no jax: the caller converts the arrays.
* :func:`load_pth` loads a reference-named ``.pth`` into a model with the
  reference's lenient ``load_model`` semantics (``utils/pyt_utils.py:47-85``):
  a ``'model'`` wrapper is unwrapped, ``module.`` prefixes are stripped, and
  missing / unexpected keys are reported, raising only under ``strict``.
  ``restore_last=False`` drops the final classifiers (the reference's
  ``--not-restore-last``); ``skip_mismatch`` skips keys whose shape differs.
* :func:`save_pth` writes the model's reference-named state_dict.
* :func:`save_checkpoint`, :func:`latest_checkpoint_step` and
  :func:`restore_checkpoint` keep the full train state (weights, BN stats,
  SGD momentum, LR schedule, step) as ``step_XXXXXXXX.pt`` files written
  by ``torch.save``, in place of the JAX package's orbax directories.

CCNet's, PSPNet's and DeepLabv3's modules are mapped.
"""

from __future__ import annotations

import os
import os.path as osp
import re
from typing import Dict, List, Optional, Tuple

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
# PSP head (reference networks/pspnet.py:62-113); stage i is psp.stage{i}_conv/_bn
_PSP_MAP = {"bottleneck_conv": "head.0.bottleneck.0", "bottleneck_bn": "head.0.bottleneck.1"}
_PSP_STAGE_RE = re.compile(r"^stage(\d+)_(conv|bn)$")
# ASPP head (reference networks/deeplabv3.py:62-126)
_ASPP_MAP = {
    "image_pool_conv": "head.0.conv1.1", "image_pool_bn": "head.0.conv1.2",
    "conv1x1": "head.0.conv2.0", "conv1x1_bn": "head.0.conv2.1",
    "atrous0_conv": "head.0.conv3.0", "atrous0_bn": "head.0.conv3.1",
    "atrous1_conv": "head.0.conv4.0", "atrous1_bn": "head.0.conv4.1",
    "atrous2_conv": "head.0.conv5.0", "atrous2_bn": "head.0.conv5.1",
    "bottleneck_conv": "head.0.bottleneck.0", "bottleneck_bn": "head.0.bottleneck.1",
}


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
    if top == "psp":
        stage = _PSP_STAGE_RE.match(mods[1])
        if stage:
            return f"head.0.stages.{stage.group(1)}.{1 if stage.group(2) == 'conv' else 2}"
        return _PSP_MAP[mods[1]]
    if top == "aspp":
        return _ASPP_MAP[mods[1]]
    if top == "classifier":  # the PSP/ASPP top-level 1x1 classifier
        return "head.1"
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


# the final per-class classifier convs (RCCA head, DSN aux head, the PSP/ASPP
# classifier): what --not-restore-last skips
_CLASSIFIER_KEYS = ("head.bottleneck.3", "dsn.3", "head.1")


def load_pth(path: str, model: torch.nn.Module, strict: bool = False,
             skip_mismatch: bool = False,
             restore_last: bool = True) -> Tuple[List[str], List[str]]:
    """Load a reference-named ``.pth`` into ``model``; returns (missing, unexpected).

    ``restore_last=False`` drops the classifier keys before loading (they
    keep the model's values); ``skip_mismatch`` turns a shape mismatch into
    a skipped (missing) key instead of an error."""
    sd = _normalise_keys(torch.load(path, map_location="cpu", weights_only=False))
    if not restore_last:
        sd = {k: v for k, v in sd.items()
              if not any(k.startswith(c + ".") for c in _CLASSIFIER_KEYS)}
    own = model.state_dict()
    mismatched = [k for k, v in sd.items() if k in own and tuple(v.shape) != tuple(own[k].shape)]
    if mismatched and not skip_mismatch:
        k = mismatched[0]
        raise ValueError(f"shape mismatch for {k}: ckpt {tuple(sd[k].shape)} vs model "
                         f"{tuple(own[k].shape)}")
    if mismatched:
        logger.warning(f"{len(mismatched)} keys skipped on shape mismatch: {mismatched[:5]}")
        sd = {k: v for k, v in sd.items() if k not in mismatched}
    result = model.load_state_dict(sd, strict=False)
    missing, unexpected = list(result.missing_keys), list(result.unexpected_keys)
    if missing:
        logger.warning(f"{len(missing)} keys missing from checkpoint, e.g. {missing[:5]}")
    if unexpected:
        logger.warning(f"{len(unexpected)} unexpected checkpoint keys, e.g. {unexpected[:5]}")
    if strict and (missing or unexpected):
        raise KeyError(f"strict load failed: missing={missing[:10]} unexpected={unexpected[:10]}")
    return missing, unexpected


def save_pth(model: torch.nn.Module, path: str) -> None:
    """Export the model's reference-named state_dict (CPU tensors) to ``path``."""
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()}, path)


def _ckpt_path(ckpt_dir: str, step: int) -> str:
    return osp.join(ckpt_dir, f"step_{step:08d}.pt")


def save_checkpoint(ckpt_dir: str, state, step: int) -> str:
    """Write the full train state (weights, BN stats, SGD momentum, LR
    schedule, step) to ``ckpt_dir/step_XXXXXXXX.pt``; returns the path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = _ckpt_path(ckpt_dir, step)
    torch.save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
                "scheduler": state.scheduler.state_dict(), "step": step}, path)
    logger.info(f"saved checkpoint {path}")
    return path


def latest_checkpoint_step(ckpt_dir: str) -> Optional[int]:
    if not osp.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for m in map(re.compile(r"^step_(\d+)\.pt$").match,
                                          os.listdir(ckpt_dir)) if m]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, state, step: Optional[int] = None):
    """Load a full train state into ``state`` in place; ``step=None`` takes
    the latest. Returns ``state``."""
    if step is None:
        step = latest_checkpoint_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = _ckpt_path(ckpt_dir, step)
    device = next(state.model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=False)
    state.model.load_state_dict(ckpt["model"], strict=True)
    state.optimizer.load_state_dict(ckpt["optimizer"])
    state.scheduler.load_state_dict(ckpt["scheduler"])
    state.step = int(ckpt["step"])
    logger.info(f"restored checkpoint {path}")
    return state
