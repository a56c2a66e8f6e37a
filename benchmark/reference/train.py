"""The plain reference of one training step of the recipe: augmentation,
forward, OHEM + DSN criterion, backward and SGD, in f32 with TF32 off.

Inputs are the benchmark's raw frames and seeded weights, as the program
gets them. What the program draws at random it draws by a rule of its own,
which the reference follows to draw the same numbers again:

* the augmentation of step ``s`` draws, per sample, a scale step, a crop
  offset and a mirror coin from a CPU ``torch.Generator`` seeded with
  ``(seed + 1) · 1000003 + s``: ``randint(0, scale_steps)`` then
  ``rand((B, 3), float64)``, the offsets ``floor(u · (max(sH, crop) − crop
  + 1))`` over the padded scaled frame, the mirror ``u < 0.5``;
* the dropout masks of step ``s`` come from the card's default generator
  seeded with ``(seed + 2) · 1000003 + s``, one elementwise mask per
  dropout in forward order, drawn by ``F.dropout`` on tensors of the
  compute dtype (:func:`dropout_masks`).

Everything else is computed here from its published definition: the crop
by separable bilinear interpolation matrices in f64 (cv2's half-pixel
source ``(i + 0.5)·H₀/sH − 0.5``, padding with the mean, i.e. 0 after its
subtraction, and the ignore label), nearest-neighbour labels
(``floor(i·H₀/sH)``), the upsampling of the logits by ``F.interpolate``,
the OHEM threshold by ``torch.kthvalue`` (the exact k-th smallest correct-
class probability), and SGD with the weight decay added to the gradient
before the momentum, on the poly schedule.
"""

from __future__ import annotations

import math
from contextlib import contextmanager

import numpy as np
import torch

from benchmark.reference.models import precision

F = torch.nn.functional


@contextmanager
def no_tf32():
    """f32 products in f32: TF32 off for matmuls and cuDNN inside."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def augment_draws(seed: int, step: int, batch: int, frame_hw, crop_hw, scale_min: float,
                  scale_step: float, scale_steps: int, mirror: bool):
    """Per-sample ``(scaled size (sH, sW), offset (oy, ox), mirror)`` of step
    ``step``, as Python numbers."""
    gen = torch.Generator().manual_seed(((seed + 1) * 1000003 + step) % (2 ** 63))
    idx = torch.randint(0, scale_steps, (batch,), generator=gen).tolist()
    u = torch.rand((batch, 3), generator=gen, dtype=torch.float64).tolist()
    out = []
    for k, (uy, ux, uf) in zip(idx, u):
        f = scale_min + scale_step * k
        sh, sw = int(round(frame_hw[0] * f)), int(round(frame_hw[1] * f))
        oy = int(uy * (max(sh, crop_hw[0]) - crop_hw[0] + 1))
        ox = int(ux * (max(sw, crop_hw[1]) - crop_hw[1] + 1))
        out.append(((sh, sw), (oy, ox), bool(mirror and uf < 0.5)))
    return out


def _taps(n0: int, scaled: int, offset: int, n: int):
    """One axis: the (n, n0) f64 bilinear interpolation matrix of output
    pixels ``offset … offset + n − 1`` of a side of ``n0`` scaled to
    ``scaled``, rows past the scaled side zero; and their nearest source
    indices (−1 past it)."""
    pos = np.arange(n) + offset
    inside = pos < scaled
    ratio = n0 / scaled
    src = np.clip((pos + 0.5) * ratio - 0.5, 0.0, n0 - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n0 - 1)
    w = src - lo
    m = np.zeros((n, n0))
    rows = np.arange(n)
    np.add.at(m, (rows, lo), 1.0 - w)
    np.add.at(m, (rows, hi), w)
    m[~inside] = 0.0
    nearest = np.minimum(np.floor(pos * ratio).astype(np.int64), n0 - 1)
    nearest[~inside] = -1
    return m, nearest


def augment(images: torch.Tensor, labels: torch.Tensor, draws, crop_hw, mean,
            ignore_label: int):
    """Raw frames ``(B, H₀, W₀, 3)`` uint8 BGR and labels ``(B, H₀, W₀)`` →
    ``(B, 3, ch, cw)`` f32 mean-subtracted crops and ``(B, ch, cw)`` int64
    labels, one sample at a time in f64."""
    H0, W0 = images.shape[1:3]
    ch, cw = crop_hw
    dev = images.device
    mean64 = torch.tensor(mean, dtype=torch.float64, device=dev)
    out_i, out_l = [], []
    for b, ((sh, sw), (oy, ox), flip) in enumerate(draws):
        my, ny = _taps(H0, sh, oy, ch)
        mx, nx = _taps(W0, sw, ox, cw)
        my, mx = torch.from_numpy(my).to(dev), torch.from_numpy(mx).to(dev)
        img = images[b].to(torch.float64).permute(2, 0, 1)  # (3, H0, W0)
        crop = my @ img @ mx.T  # (3, ch, cw)
        inside = (torch.from_numpy(ny >= 0).to(dev)[:, None]
                  & torch.from_numpy(nx >= 0).to(dev)[None, :])
        crop = torch.where(inside, crop - mean64[:, None, None], 0.0)
        ly = torch.from_numpy(np.maximum(ny, 0)).to(dev)
        lx = torch.from_numpy(np.maximum(nx, 0)).to(dev)
        lbl = labels[b].long()[ly[:, None], lx[None, :]]
        lbl = torch.where(inside, lbl, ignore_label)
        if flip:
            crop, lbl = crop.flip(-1), lbl.flip(-1)
        out_i.append(crop.float())
        out_l.append(lbl)
    return torch.stack(out_i), torch.stack(out_l)


def dropout_masks(seed: int, step: int, shapes, dtype, p: float, device) -> list:
    """The elementwise keep-masks of step ``step``, one per shape, in the
    order the program's forward draws them."""
    devices = [device] if torch.device(device).type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(((seed + 2) * 1000003 + step) % (2 ** 63))
        return [F.dropout(torch.ones(s, dtype=dtype, device=device), p, True) != 0
                for s in shapes]


def nll_map(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int):
    """Per-pixel NLL of the logits upsampled (align corners) to the labels."""
    up = F.interpolate(logits, size=labels.shape[1:], mode="bilinear", align_corners=True)
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0)
    nll = -torch.log_softmax(up, dim=1).gather(1, safe[:, None])[:, 0]
    return nll, valid


def criterion(main, aux, labels, ignore_label: int, thresh: float, min_kept: int):
    """OHEM cross-entropy of the main head + 0.4 · cross-entropy of the
    auxiliary head (means over the kept and the valid pixels)."""
    nll, valid = nll_map(main, labels, ignore_label)
    p = torch.exp(-nll.detach())
    n_valid = int(valid.sum())
    if n_valid <= min_kept:
        keep = valid
    else:
        kth = torch.kthvalue(p[valid], min(min_kept, n_valid)).values
        keep = valid & (p <= torch.maximum(kth, torch.tensor(thresh, device=p.device)))
    loss1 = (nll * keep).sum() / keep.sum()
    nll_aux, _ = nll_map(aux, labels, ignore_label)
    loss2 = (nll_aux * valid).sum() / valid.sum()
    return loss1 + 0.4 * loss2


def poly_lr(base: float, step: int, max_steps: int, power: float) -> float:
    return base * (1.0 - step / max_steps) ** power


def train_steps(net, frames, labels, batches, config: dict, traffic: dict, seed: int,
                steps: int, prec: str = "f32", fault: str | None = None) -> dict:
    """Train the reference ``net`` (f32, loaded with the run's weights) for
    ``steps`` steps on ``batches[s]`` (frame indices of step ``s``).

    Returns the per-step losses, the per-leaf norms of the first step's loss
    gradient and of the gradient with the weight decay as SGD gets it, the
    per-leaf norms of the weights' change over the steps, and each step's
    crops. ``prec`` is :func:`~benchmark.reference.models.precision`;
    ``fault`` plants a fault for the benchmark's check of its own limits:
    ``"half_batch"`` trains on the first half of each batch, ``"mirror"``
    mirrors the crops the draws leave unmirrored and the other way round."""
    opt = config["sgd"]
    crop = tuple(traffic["crop"])
    dtype = getattr(torch, config["dtype"])
    names = [n for n, _ in net.named_parameters()]
    params = [p for _, p in net.named_parameters()]
    start = [p.detach().clone() for p in params]
    bufs = [None] * len(params)
    out = {"losses": [], "crops": []}
    net.train()
    with no_tf32(), precision(prec):
        for s in range(steps):
            idx = batches[s]
            draws = augment_draws(seed, s, len(idx), frames.shape[1:3], crop,
                                  traffic["scale_min"], traffic["scale_step"],
                                  traffic["scale_steps"], traffic["mirror"])
            if fault == "mirror":
                draws = [(size, off, not flip) for size, off, flip in draws]
            imgs, lbls = augment(frames[idx], labels[idx], draws, crop,
                                 config["mean_bgr"], config["ignore_label"])
            out["crops"].append((imgs, lbls))
            # each dropout acts on an output-stride-8 feature of its own width
            shapes = [(imgs.shape[0], mod.channels, os8(crop[0]), os8(crop[1]))
                      for mod in net.dropouts()]
            masks = dropout_masks(seed, s, shapes, dtype, config.get("dropout", 0.1),
                                  imgs.device)
            if fault == "half_batch":
                half = imgs.shape[0] // 2
                imgs, lbls, masks = imgs[:half], lbls[:half], [m[:half] for m in masks]
            for mod, m in zip(net.dropouts(), masks):
                mod.mask = m
            main, aux = net(imgs)
            for mod in net.dropouts():
                mod.mask = None
            loss = criterion(main, aux, lbls, config["ignore_label"],
                             config["ohem"]["thresh"], config["ohem"]["min_kept"])
            for p in params:
                p.grad = None
            loss.backward()
            out["losses"].append(float(loss.detach()))
            lr = poly_lr(opt["lr"], s, opt["max_steps"], opt["power"])
            with torch.no_grad():
                if s == 0:
                    out["loss_grad"] = norms(names, [p.grad for p in params])
                for i, p in enumerate(params):
                    d = p.grad + opt["weight_decay"] * p
                    if bufs[i] is None:
                        bufs[i] = d.clone()
                    else:
                        bufs[i].mul_(opt["momentum"]).add_(d)
                    p.sub_(lr * bufs[i])
                if s == 0:
                    out["grad"] = norms(names, bufs)
    with torch.no_grad():
        out["change"] = norms(names, [p - p0 for p, p0 in zip(params, start)])
    return out


def os8(n: int) -> int:
    """A side after the stride-2 stem conv, the ceil-mode max pool (whose
    last window must start inside the padded input) and layer2's stride-2
    conv, each 3 wide with padding 1."""
    n = (n + 2 - 3) // 2 + 1
    pooled = math.ceil((n + 2 - 3) / 2) + 1
    if (pooled - 1) * 2 >= n + 1:
        pooled -= 1
    return (pooled + 2 - 3) // 2 + 1


def norms(names, tensors) -> dict:
    """``{name: f64 norm}`` of each tensor, read back at once."""
    norms = torch.stack([t.detach().double().norm() for t in tensors]).tolist()
    return dict(zip(names, norms))
