"""What the benchmark makes from ``--seed``: the frame pool and the weights.

Both are drawn on the run's device by a ``torch.Generator`` of that device,
in a few large calls, and handed unchanged to the program and to the
reference. One seed gives the same frames and weights on every run.
"""

from __future__ import annotations

import hashlib
import math

import torch


def sub_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for one use of the run's ``seed`` (any whole number)."""
    digest = hashlib.sha256(f"{seed}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def frames(seed: int, count: int, hw, classes: int, ignore_label: int, block: int,
           border: int, noise: float, device) -> tuple:
    """``count`` Cityscapes-shaped frames: ``(count, H, W, 3)`` uint8 BGR
    images and ``(count, H, W)`` uint8 labels. A label map is a grid of
    ``block``-pixel squares of one class each with ``border``-pixel
    ignore-label edges; an image is its classes' colours (one per class, drawn
    once per seed) plus Gaussian noise of ``noise`` grey levels, clipped."""
    H, W = hw
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "frames"))
    gh, gw = -(-H // block), -(-W // block)
    grid = torch.randint(0, classes, (count, gh, gw), generator=gen, device=device,
                         dtype=torch.int32)
    labels = grid.repeat_interleave(block, 1).repeat_interleave(block, 2)[:, :H, :W]
    colours = torch.rand((classes, 3), generator=gen, device=device) * 215.0 + 20.0
    images = colours[labels.long()]
    images += torch.randn(images.shape, generator=gen, device=device) * noise
    images = images.round_().clamp_(0, 255).to(torch.uint8)
    ys = torch.arange(H, device=device) % block
    xs = torch.arange(W, device=device) % block
    edge = ((ys < border) | (ys >= block - border))[:, None] | (
        (xs < border) | (xs >= block - border))[None, :]
    labels = torch.where(edge, ignore_label, labels).to(torch.uint8)
    return images, labels


def weights(names_shapes, seed: int, device) -> dict:
    """A state dict of reference names drawn from ``seed``, f32 on ``device``.

    One uniform draw ``u`` in [-1, 1) covers every entry; each takes its
    slice, scaled by its kind: convolution weights ``u/√fan_in`` (torch's
    default init of a convolution), biases ``0.1·u``, BN weights
    ``1 + 0.1·u`` but for the last BN of each residual branch
    (``layer*.bn3``), ``0.1·(1 + 0.1·u)`` (Goyal et al. 2017 start it at 0:
    each block starts near the identity), BN running means ``0.1·u`` and
    variances ``1 + 0.2·u``, and the attention's ``gamma`` ``0.5 + 0.25·u``,
    so that the attention moves the logits (at 0, as the program initialises
    it, the attention would change nothing).

    The residual BN and the convolutions' scale keep the random network out
    of the chaotic regime, where bf16 rounding is amplified block by block:
    with He-scaled convolutions and every BN weight near 1, the bf16 program
    and the f32 reference answer differently on most served pixels (PERF.md
    §2)."""
    total = sum(math.prod(s) for _, s in names_shapes)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape in names_shapes:
        n = math.prod(shape)
        t = u[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            t = t / math.sqrt(math.prod(shape[1:]))
        elif leaf == "gamma":
            t = 0.5 + 0.25 * t
        elif leaf == "running_var":
            t = 1.0 + 0.2 * t
        elif leaf == "weight" and name.startswith("layer") and name.endswith(".bn3.weight"):
            t = 0.1 * (1.0 + 0.1 * t)
        elif leaf == "weight":
            t = 1.0 + 0.1 * t
        else:  # bias, running_mean
            t = 0.1 * t
        out[name] = t.clone()
    return out
