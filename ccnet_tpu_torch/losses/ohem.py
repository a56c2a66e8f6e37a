"""Online hard example mining (OHEM) cross-entropy.

Counterpart of :mod:`ccnet_tpu.losses.ohem`, with the same selection rule:
keep the valid pixels whose probability for their correct class is ``<=
max(thresh, p_k)``, where ``p_k`` is the k-th smallest such probability
over the valid pixels, ``k = min_kept``; keep every valid pixel when no
more than ``min_kept`` are valid. ``p_k`` is found as the JAX package finds
it (:func:`ohem_threshold`, :func:`kth_smallest_bisect`): a count at
``thresh``, then quaternary count bisection of ``(thresh, 1]``, choosing
with ``torch.where``-style indexing, with no sort and no read back to the
host; its bounds are copied to the device (``sync.ohem.bounds``).

Over N ranks every count (each pass's three, the count at ``thresh`` and
the number of valid pixels) is summed over the ranks with one
``all_reduce``, so ``p_k`` is the k-th smallest over the global batch and
every rank keeps what the one-process selection on the global batch keeps.
One function serves one rank and N.
"""

from __future__ import annotations

import math

import torch

from ccnet_tpu_torch.losses.cross_entropy import masked_mean
from ccnet_tpu_torch.parallel.distributed import world
from ccnet_tpu_torch.parallel.mesh import all_reduce_sum
from ccnet_tpu_torch.utils.trace import sync


def kth_smallest_bisect(x: torch.Tensor, k: int, iters: int = 25, lo: float = 0.0,
                        hi: float = 1.0) -> torch.Tensor:
    """k-th smallest of the flat values ``x`` (over all ranks) in ``[lo, hi]``
    by count bisection: each pass counts ``x <= m`` at the three quarter
    points of ``[lo, hi]`` (one ``all_reduce`` of the three counts over N
    ranks) and keeps the smallest quarter whose upper edge still has ``>= k``
    values, in f32 as the JAX function computes it. Values above ``hi``
    (+inf for invalid pixels) never win. Returns the final upper edge, an
    f32 0-d tensor on ``x``'s device."""
    sync("ohem.bounds", x.device, 2)
    lo = torch.tensor(lo, dtype=torch.float32, device=x.device)
    hi = torch.tensor(hi, dtype=torch.float32, device=x.device)
    for _ in range(iters):
        d = hi - lo
        mids = torch.stack([lo + 0.25 * d, lo + 0.5 * d, lo + 0.75 * d])
        counts = all_reduce_sum((x[None, :] <= mids[:, None]).sum(dim=1), "ohem")
        # the counts grow with the edge: the first quarter whose upper edge
        # has >= k values is the number of edges with fewer
        j = (counts < k).sum()
        edges = torch.cat([lo[None], mids, hi[None]])
        lo, hi = edges.index_select(0, torch.stack([j, j + 1])).unbind()
    return hi


def ohem_threshold(flat: torch.Tensor, k: int, thresh: float, num_valid: torch.Tensor,
                   min_kept: int) -> torch.Tensor:
    """The keep threshold ``max(thresh, p_k)`` (1 when ``num_valid <=
    min_kept``), exactly. ``num_valid`` is the global count. The k-th
    statistic matters only above ``thresh``: one count at ``thresh`` decides
    that, and the bisection brackets ``(thresh, 1]`` until the bracket is
    narrower than one f32 ulp at ``thresh`` (13 quaternary passes at 0.7),
    where ``p <= hi`` and ``p <= p_k`` select the same pixels."""
    sync("ohem.bounds", flat.device)
    t = torch.tensor(thresh, dtype=torch.float32, device=flat.device)
    if thresh <= 0.0:
        kth = kth_smallest_bisect(flat, k)
    else:
        c_t = all_reduce_sum((flat <= t).sum(), "ohem")
        width = 1.0 - thresh
        ulp = 2.0 ** (math.floor(math.log2(thresh)) - 23)
        iters = max(1, min(25, math.ceil(math.log(max(width, 1e-9) / ulp, 4)) + 1))
        kth = kth_smallest_bisect(flat, k, iters=iters, lo=thresh, hi=1.0)
        kth = torch.where(c_t >= k, t, kth)
    return torch.where(num_valid <= min_kept, torch.ones_like(t), torch.maximum(t, kth))


def ohem_keep_mask(p_correct: torch.Tensor, valid: torch.Tensor, thresh: float,
                   min_kept: int) -> torch.Tensor:
    """The selection rule on precomputed correct-class probabilities. Over N
    ranks the map is the global batch's, of which every rank holds an equal
    share."""
    flat = torch.where(valid, p_correct.float(), torch.full_like(p_correct.float(), float("inf")))
    flat = flat.reshape(-1)
    k = min(min_kept, flat.numel() * world()[1])
    if k <= 0:
        sync("ohem.bounds", flat.device)
        threshold = torch.tensor(thresh, dtype=torch.float32, device=flat.device)
    else:
        threshold = ohem_threshold(flat, k, thresh, all_reduce_sum(valid.sum(), "ohem"),
                                   min_kept)
    return valid & (p_correct <= threshold)


def ohem_mask(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255,
              thresh: float = 0.7, min_kept: int = 100000) -> torch.Tensor:
    """Boolean keep-mask over pixels. logits ``(B, C, ...)``, labels ``(B, ...)``."""
    logits = logits.detach().float()  # selection is not differentiated
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    p_correct = torch.softmax(logits, dim=1).gather(1, safe[:, None])[:, 0]
    return ohem_keep_mask(p_correct, valid, thresh, min_kept)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_label: int = 255,
                       thresh: float = 0.7, min_kept: int = 100000) -> torch.Tensor:
    """OHEM-masked mean CE (scalar f32); selection on ``exp(−nll)`` of the
    same log-softmax the loss uses, as the JAX package does."""
    valid = labels != ignore_label
    safe = torch.where(valid, labels, 0).long()
    nll = -torch.log_softmax(logits.float(), dim=1).gather(1, safe[:, None])[:, 0]
    p_correct = torch.exp(-nll.detach())
    return masked_mean(nll, ohem_keep_mask(p_correct, valid, thresh, min_kept))
