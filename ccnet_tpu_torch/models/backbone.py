"""Deep-stem dilated ResNet backbone (output stride 8), NCHW.

Counterpart of :mod:`ccnet_tpu.models.backbone`, with the same geometry:

* deep stem: three 3×3 convs (3→64 s2, 64→64, 64→128), BN(identity)+ReLU
  each, then the 3×3/s2 ceil-mode maxpool;
* layers of ``Bottleneck`` (expansion 4);
* layer3 at stride 1 / dilation 2, layer4 at stride 1 / dilation 4 with
  multi_grid (1, 1, 1) → output stride 8;
* the layer3 feature is returned for the DSN auxiliary head.

Module names are the reference's torch names (``conv1``, ``layer1.0``,
``downsample.0``), which the JAX package's ``.pth`` export writes.

``remat`` recomputes bottleneck blocks in the backward instead of keeping
their activations, with the JAX package's modes: ``True`` (``--remat
blocks`` in the CLI) each block of layers 3 and 4, a tuple of layer indices each block
of those layers, ``"conv12"`` the blocks of layers 3 and 4 keeping conv1's
and conv2's outputs (only the BN/ReLU chain, conv3 and the shortcut are
recomputed) and ``"convs"`` also keeping conv3's. A block is wrapped in
``torch.utils.checkpoint`` (non-reentrant); the string modes add a
selective-checkpoint policy that saves the first two (three) convolutions
the block runs, which are conv1, conv2 (and conv3), before the shortcut's.
The recompute runs inside :func:`~ccnet_tpu_torch.nn.layers.recomputing`,
so BN's running stats are updated once per step, as in the JAX package.
"""

from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Any, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ccnet_tpu_torch.nn.layers import ABN, Conv, recomputing
from ccnet_tpu_torch.ops.pooling import max_pool_ceil

# remat mode -> (the layers whose blocks are recomputed, convolutions kept per block)
_REMAT_KEEP = {"conv12": 2, "convs": 3}


def remat_plan(remat: Any) -> Tuple[frozenset, int | None]:
    """``(layers, kept)``: the layers whose blocks are checkpointed, and how
    many of each block's first convolution outputs are kept (None: none)."""
    if remat is True:
        return frozenset({3, 4}), None
    if not remat:
        return frozenset(), None
    if remat in _REMAT_KEEP:
        return frozenset({3, 4}), _REMAT_KEEP[remat]
    if isinstance(remat, str):
        raise ValueError(f"unknown remat mode {remat!r}")
    return frozenset(int(li) for li in remat), None


def _keep_first_convs(n: int):
    """A selective-checkpoint policy saving the first ``n`` convolutions of
    one call (counted apart in the forward and, where torch asks the policy
    again, in the recompute)."""
    seen = {False: 0, True: 0}

    def policy(ctx, op, *args, **kwargs):
        if op is torch.ops.aten.convolution.default:
            seen[ctx.is_recompute] += 1
            if seen[ctx.is_recompute] <= n:
                return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


@contextmanager
def _recompute(selective):
    with selective, recomputing():
        yield


def _remat_block(block: nn.Module, x: torch.Tensor, kept: int | None) -> torch.Tensor:
    def contexts():
        if kept is None:
            return nullcontext(), recomputing()
        forward, recompute = create_selective_checkpoint_contexts(_keep_first_convs(kept))
        return forward, _recompute(recompute)

    # a bottleneck draws no random numbers, so no RNG state is stashed
    return checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                      context_fn=contexts)


class Bottleneck(nn.Module):
    """ResNet bottleneck, expansion 4, optional dilation + multi-grid."""

    def __init__(self, inplanes: int, planes: int, stride: int = 1, dilation: int = 1,
                 multi_grid: int = 1, has_downsample: bool = False, dtype=torch.float32):
        super().__init__()
        d = dilation * multi_grid
        self.conv1 = Conv(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = ABN(planes, "identity")
        self.conv2 = Conv(planes, planes, 3, stride=stride, padding=d, dilation=d,
                          bias=False, dtype=dtype)
        self.bn2 = ABN(planes, "identity")
        self.conv3 = Conv(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = ABN(planes * 4, "identity")
        self.downsample = (
            nn.Sequential(Conv(inplanes, planes * 4, 1, stride=stride, bias=False, dtype=dtype),
                          ABN(planes * 4, "identity"))
            if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(x), relu=True)
        out = self.bn2(self.conv2(out), relu=True)
        out = self.conv3(out)  # before the shortcut's conv: remat keeps the first convs
        residual = self.downsample(x) if self.downsample is not None else x
        return self.bn3(out, residual=residual, relu=True)


class DilatedResNet(nn.Module):
    """Deep-stem dilated ResNet trunk; :meth:`forward` returns (layer3, layer4).
    ``remat``: see the module's note (:func:`remat_plan`)."""

    def __init__(self, layers: Sequence[int] = (3, 4, 23, 3), dtype=torch.float32,
                 remat: Any = False):
        super().__init__()
        self.dtype = dtype
        self.remat_layers, self.remat_kept = remat_plan(remat)
        self.conv1 = Conv(3, 64, 3, stride=2, padding=1, bias=False, dtype=dtype)
        self.bn1 = ABN(64, "identity")
        self.conv2 = Conv(64, 64, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = ABN(64, "identity")
        self.conv3 = Conv(64, 128, 3, padding=1, bias=False, dtype=dtype)
        self.bn3 = ABN(128, "identity")
        specs = [  # (planes, stride, dilation, multi_grid tuple)
            (64, 1, 1, None),
            (128, 2, 1, None),
            (256, 1, 2, None),
            (512, 1, 4, (1, 1, 1)),
        ]
        inplanes = 128
        for li, ((planes, stride, dilation, grids), blocks) in enumerate(zip(specs, layers), 1):
            mods = []
            for bi in range(blocks):
                mods.append(Bottleneck(
                    inplanes, planes, stride=stride if bi == 0 else 1, dilation=dilation,
                    multi_grid=grids[bi % len(grids)] if grids else 1,
                    has_downsample=bi == 0 and (stride != 1 or inplanes != planes * 4),
                    dtype=dtype))
                inplanes = planes * 4
            setattr(self, f"layer{li}", nn.Sequential(*mods))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.to(self.dtype)
        x = self.bn1(self.conv1(x), relu=True)
        x = self.bn2(self.conv2(x), relu=True)
        x = self.bn3(self.conv3(x), relu=True)
        x = max_pool_ceil(x, 3, 2, 1)
        feats = []
        for li in (1, 2, 3, 4):
            remat = li in self.remat_layers and self.training and torch.is_grad_enabled()
            for block in getattr(self, f"layer{li}"):
                x = _remat_block(block, x, self.remat_kept) if remat else block(x)
            feats.append(x)
        return feats[2], feats[3]
