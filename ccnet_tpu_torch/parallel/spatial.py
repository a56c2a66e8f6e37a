"""Height sharding of whole-image inference over the ranks of a space group.

Counterpart of the JAX package's ``space`` mesh axis for ``--whole``
inference (``ccnet_tpu/parallel/mesh.py`` ``spatial_sharding``): there XLA
partitions the convolutions with halo exchange and gathers the criss-cross
attention (``tests/test_spatial_eval.py`` asserts that pattern); here each
rank of a :class:`SpaceGroup` runs the network on its own rows of the image
and the layers that read across a row boundary call this module:

* :class:`RowPlan` — the rows each shard owns at each stride of the trunk
  (1, 2, 4, 8). Shard ``s`` owns the stride-8 rows ``[s·⌈h8/S⌉, …)`` (the
  last shard takes the remainder) and, at stride ``k``, those rows times
  ``8/k``: every boundary lines up with the strides of ``conv1``, the max
  pool and ``layer2``, also at an odd height (1025 → 513 → 257 → 129);
* :meth:`RowPlan.halo` — a padded convolution's or pool's input rows,
  extended by the rows its window reads beyond the shard: the other
  shards' rows through one exchange (from further shards where a halo is
  wider than a neighbour's rows), the pad value beyond the image's top and
  bottom (0 for a convolution, −∞ for the max pool);
* :meth:`RowPlan.gather` — a stride-8 map's rows of all shards (the
  attention's q, k, v and the logits); :meth:`SpaceGroup.sum` — a sum over
  the shards (the adaptive pools' row shares).

Every collective is one ``all_reduce`` (sum) of a zero-filled buffer in
which each rank writes the rows it owns, so one code path serves gloo (CUDA
and CPU tensors: it has no ``all_gather`` and no ``send``/``recv`` for CUDA
tensors) and NCCL. The buffers of an exchange hold only the rows some shard
reads from another. Each rank of a space group must run the same forwards
on images of the same height, in the same order: the collectives run on the
space group only, never on the world group.

:meth:`SpaceGroup.sharded` makes a plan current on this thread for the
length of one forward (:func:`current`); without a current plan the layers
compute what they compute in one process. The group counts each kind of
collective, calls and bytes, in :attr:`SpaceGroup.counts`, and keeps the
latest sharded forward's in :attr:`SpaceGroup.events`.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

KINDS = ("exchange", "gather", "sum")

_STATE = threading.local()


def current() -> Optional["RowPlan"]:
    """The plan of the sharded forward running on this thread, or None."""
    return getattr(_STATE, "plan", None)


def out_size(n: int, k: int, d: int, s: int, p: int, ceil: bool = False) -> int:
    """Output length of a window ``k``, dilation ``d``, stride ``s`` and
    padding ``p`` over ``n`` rows, with torch's ceil-mode rule (the last
    window starts inside the input or its leading pad)."""
    out = (n + 2 * p - d * (k - 1) - 1 + (s - 1 if ceil else 0)) // s + 1
    if ceil and (out - 1) * s >= n + p:
        out -= 1
    return out


class SpaceGroup:
    """The ranks that split each image's rows: the process ``group``, this
    rank's ``index`` in it and its ``size``. ``counts[kind]`` is ``[calls,
    bytes]`` of each kind of collective issued through it; ``events`` the
    ``(kind, rows, bytes)`` of each collective of the latest sharded
    forward, with ``rows`` the rows an exchange moves."""

    def __init__(self, group, index: int, size: int):
        self.group, self.index, self.size = group, index, size
        self.counts = {kind: [0, 0] for kind in KINDS}
        self.events: List[Tuple[str, int, int]] = []

    def _all_reduce(self, buf: torch.Tensor, kind: str, rows: int) -> torch.Tensor:
        nbytes = buf.numel() * buf.element_size()
        self.counts[kind][0] += 1
        self.counts[kind][1] += nbytes
        self.events.append((kind, rows, nbytes))
        dist.all_reduce(buf, group=self.group)
        return buf

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the shards, in a new tensor."""
        return self._all_reduce(x.detach().clone(), "sum", 0)

    def gather(self, x: torch.Tensor, start: int, total: int) -> torch.Tensor:
        """The map of ``total`` rows (dim 2) of which this rank holds rows
        ``[start, start + x.shape[2])``, assembled from every shard's rows."""
        buf = x.new_zeros((*x.shape[:2], total, *x.shape[3:]))
        buf[:, :, start:start + x.shape[2]] = x
        return self._all_reduce(buf, "gather", total)

    def rows(self, height: int) -> Tuple[int, int]:
        """The image rows this rank owns in an image of ``height`` rows."""
        return RowPlan(self, height).spans[0][self.index]

    @contextmanager
    def sharded(self, height: int):
        """Make the plan of an image of ``height`` rows current on this
        thread for one forward of this rank's rows; yields the plan."""
        before = current()
        _STATE.plan = plan = RowPlan(self, height)
        self.events = []
        try:
            yield plan
        finally:
            _STATE.plan = before

    def forward(self, apply_fn, image: torch.Tensor) -> torch.Tensor:
        """``apply_fn`` of the whole NCHW ``image``: this rank runs it on its
        rows under the image's plan, and the stride-8 output of every shard
        is gathered."""
        with self.sharded(image.shape[2]) as plan:
            lo, hi = plan.spans[0][self.index]
            local = apply_fn(image[:, :, lo:hi])
        return plan.gather(local)


class RowPlan:
    """The rows of an image of ``height`` rows that each of the ``size``
    shards of ``group`` owns at the trunk's strides 1, 2, 4 and 8:
    ``heights[level]`` the map's height, ``spans[level][shard]`` the shard's
    rows ``(start, end)``. Raises ValueError where a shard would own no
    stride-8 row, or where two levels of a shard's rows could not be told
    apart by their count (images of a few rows)."""

    def __init__(self, group: SpaceGroup, height: int):
        self.group = group
        h2 = out_size(height, 3, 1, 2, 1)  # conv1
        h4 = out_size(h2, 3, 1, 2, 1, ceil=True)  # the max pool
        h8 = out_size(h4, 3, 1, 2, 1)  # layer2
        self.heights = (height, h2, h4, h8)
        size = group.size
        step = -(-h8 // size)
        if step * (size - 1) >= h8:
            raise ValueError(f"an image of {height} rows has {h8} rows at stride 8, too few "
                             f"for {size} shards")
        self.spans = tuple(
            tuple((s * step * f, (s + 1) * step * f if s < size - 1 else h)
                  for s in range(size))
            for h, f in zip(self.heights, (8, 4, 2, 1)))
        if len(set(self.heights)) < 4 or any(
                len({b - a for a, b in (level[s] for level in self.spans)}) < 4
                for s in range(size)):
            raise ValueError(f"an image of {height} rows is too small to shard over {size}")

    def level(self, rows: int) -> int:
        """The level whose span of this shard holds ``rows`` rows."""
        for level, spans in enumerate(self.spans):
            a, b = spans[self.group.index]
            if b - a == rows:
                return level
        raise ValueError(f"{rows} rows are no level of this shard's spans {self.spans}")

    def span(self, rows: int) -> Tuple[int, int, int]:
        """``(height, start, end)``: the global map of a tensor of this shard
        with ``rows`` rows, and the rows it holds."""
        level = self.level(rows)
        return (self.heights[level], *self.spans[level][self.group.index])

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map of which ``x`` holds this shard's rows."""
        height, start, _ = self.span(x.shape[2])
        return self.group.gather(x, start, height)

    def halo(self, xs: Sequence[torch.Tensor], k: int, d: int, s: int, p: int,
             value: float = 0.0, ceil: bool = False) -> List[torch.Tensor]:
        """Each of ``xs`` (this shard's rows of one level, one dtype) as the
        rows a window ``k``, dilation ``d``, stride ``s`` and row padding
        ``p`` reads to give this shard's output rows: run it with no row
        padding. Rows of other shards come through one exchange for all of
        ``xs``; rows beyond the map are ``value``."""
        level = self.level(xs[0].shape[2])
        h = self.heights[level]
        out_level = self.heights.index(out_size(h, k, d, s, p, ceil))
        need = []  # per shard: the global rows its output reads
        for (o0, o1) in self.spans[out_level]:
            need.append((s * o0 - p, s * (o1 - 1) - p + d * (k - 1) + 1))
        union = sorted({r for (lo, hi), (a, b) in zip(need, self.spans[level])
                        for r in (*range(max(lo, 0), a), *range(b, min(hi, h)))})
        (lo, hi), (a, b) = need[self.group.index], self.spans[level][self.group.index]
        if union:
            at = {r: j for j, r in enumerate(union)}
            mine = [r for r in union if a <= r < b]
            B, W = xs[0].shape[0], xs[0].shape[3]
            flat = xs[0].new_zeros(sum(B * x.shape[1] * len(union) * W for x in xs))
            slots, off = [], 0
            for x in xs:
                n = B * x.shape[1] * len(union) * W
                slot = flat[off:off + n].view(B, x.shape[1], len(union), W)
                off += n
                if mine:
                    index = torch.tensor(mine, device=x.device) - a
                    slot[:, :, at[mine[0]]:at[mine[0]] + len(mine)] = x.index_select(2, index)
                slots.append(slot)
            self.group._all_reduce(flat, "exchange", len(union))
        out = []
        for i, x in enumerate(xs):
            parts = []
            if lo < 0:
                parts.append(x.new_full((*x.shape[:2], -lo, x.shape[3]), value))
            if max(lo, 0) < a:
                parts.append(slots[i][:, :, at[max(lo, 0)]:at[a - 1] + 1])
            parts.append(x[:, :, max(lo, a) - a:min(hi, b) - a])
            if b < min(hi, h):
                parts.append(slots[i][:, :, at[b]:at[min(hi, h) - 1] + 1])
            if hi > h:
                parts.append(x.new_full((*x.shape[:2], hi - max(h, lo), x.shape[3]), value))
            out.append(torch.cat(parts, dim=2) if len(parts) > 1 else parts[0])
        return out
