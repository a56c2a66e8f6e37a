"""The plain reference of a served sliding-window prediction, f32, TF32 off.

``predict_sliding`` follows speedinghzl/CCNet ``evaluate.py``: tiles of the
crop size at stride ``ceil(tile · (1 − overlap))``, the last tile of a row
or column pulled back inside the image, each tile's output-stride-8 logits
upsampled (align corners) to the tile, summed into the image and divided by
the number of tiles over each pixel; the image is the raw BGR frame less
the mean. Tiles go through the network in groups, which changes nothing
in eval mode.

``calibrate`` sets a freshly drawn network's BN running statistics to the
moments of one batch, so that the served network normalises its
activations as a trained one does (with the drawn statistics the residual
stream would grow block by block). The benchmark runs it on its own
reference before the weights go to the program.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.models import ABN, precision
from benchmark.reference.train import no_tf32

F = torch.nn.functional


def tiles(hw, tile, overlap: float) -> list:
    """``(y1, x1, y2, x2)`` of each tile, row by row."""
    H, W = hw
    th, tw = tile
    stride = int(math.ceil(th * (1 - overlap)))
    rows = int(math.ceil(max(H - th, 0) / stride) + 1)
    cols = int(math.ceil(max(W - tw, 0) / stride) + 1)
    out = []
    for r in range(rows):
        for c in range(cols):
            x1, y1 = c * stride, r * stride
            x2, y2 = min(x1 + tw, W), min(y1 + th, H)
            out.append((max(y2 - th, 0), max(x2 - tw, 0), y2, x2))
    return out


@torch.no_grad()
def predict_sliding(net, image_u8: torch.Tensor, mean, tile, overlap: float, classes: int,
                    group: int = 8, prec: str = "f32") -> torch.Tensor:
    """``(H, W, 3)`` uint8 BGR → ``(classes, H, W)`` f32 averaged logits."""
    H, W = image_u8.shape[:2]
    x = image_u8.double() - torch.tensor(mean, dtype=torch.float64, device=image_u8.device)
    x = x.float().permute(2, 0, 1)
    boxes = tiles((H, W), tile, overlap)
    total = torch.zeros((classes, H, W), device=x.device)
    count = torch.zeros((H, W), device=x.device)
    with no_tf32(), precision(prec):
        for g in range(0, len(boxes), group):
            part = boxes[g:g + group]
            batch = torch.stack([x[:, y1:y2, x1:x2] for y1, x1, y2, x2 in part])
            logits = F.interpolate(net(batch)[0], size=tuple(tile), mode="bilinear",
                                   align_corners=True)
            for (y1, x1, y2, x2), lg in zip(part, logits):
                total[:, y1:y2, x1:x2] += lg
                count[y1:y2, x1:x2] += 1
    return total / count


@torch.no_grad()
def calibrate(net, batch: torch.Tensor) -> None:
    """Set every BN's running mean and (unbiased) variance to the moments of
    ``batch`` (B, 3, h, w) through the network; leaves it in eval mode."""
    bns = [m for m in net.modules() if isinstance(m, ABN)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # a cumulative average: one batch sets the moments
    net.train()
    with no_tf32():
        net(batch)
    for m in bns:
        m.momentum = 0.1
    net.eval()
