"""A profiled stretch of a run's window, reduced in memory.

The traced run profiles a steady stretch of its window through a
``torch.profiler`` schedule (whole steps or requests, marked by the
schedule's ``ProfilerStep#`` ranges) and hands the raw events here; no
trace file is written. :class:`Stretch` keeps the device operations
(kernels, copies, fills) with their intervals, and the host ranges with
their threads, and answers what the per-layer metrics ask:

* ``window_s``: from the first profiled step's start on the host to the
  last one's end (the run synchronises the card before it ends);
* ``busy_s``: the union of the device operations' intervals in the window;
* ``device_s(names)``: device time of the operations whose name holds one
  of ``names``;
* ``device_s_within(range_name)``: device time of the operations launched
  from inside a host range whose name holds ``range_name`` (an autograd
  function's forward, or its backward on the autograd thread);
* ``top_ops`` and ``idle_gaps``: the breakdown of the result line.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Stretch:
    steps: int  # profiled steps (a train step, or one served image)
    window_s: float
    busy_s: float
    ops: list  # (name, start_ns, end_ns, launch (start_ns, thread) or None)
    ranges: list  # (name, start_ns, end_ns, thread)
    gaps: list  # (seconds, what the host was doing)
    info: dict = field(default_factory=dict)  # shapes and counts of the run

    def device_s(self, names) -> float:
        return sum(e - s for n, s, e, _ in self.ops if any(k in n for k in names)) / 1e9

    def device_s_within(self, range_name: str) -> float:
        spans = {}
        for n, s, e, th in self.ranges:
            if range_name in n:
                spans.setdefault(th, []).append((s, e))
        total = 0
        for _, s, e, launch in self.ops:
            if launch is None:
                continue
            t, th = launch
            if any(a <= t <= b for a, b in spans.get(th, ())):
                total += e - s
        return total / 1e9

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, e, _ in self.ops:
            by[name] = by.get(name, 0) + (e - s)
        ranked = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns / 1e9] for name, ns in ranked]

    def idle_gaps(self, n: int = 10) -> list:
        return [[what[:200], sec] for sec, what in sorted(self.gaps, reverse=True)[:n]]


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def reduce(events, steps_expected: int | None = None, info: dict | None = None) -> Stretch:
    """Reduce a profiler's raw events (``prof.profiler.kineto_results.events()``,
    or objects with the same methods) to a :class:`Stretch`."""
    cpu, dev = [], []
    for ev in events:
        kind = str(ev.device_type())
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if kind.endswith("CUDA"):
            # the schedule's step ranges and other annotations are mirrored on
            # the device's timeline: they are no device work
            if ev.name().startswith("ProfilerStep#") or getattr(
                    ev, "is_user_annotation", lambda: False)():
                continue
            dev.append((ev.name(), start, end, ev.linked_correlation_id()))
        elif kind.endswith("CPU"):
            cpu.append((ev.name(), start, end, ev.start_thread_id(), ev.correlation_id()))
    step_ranges = [c for c in cpu if c[0].startswith("ProfilerStep#")]
    if not step_ranges:
        raise ValueError("the profiled stretch holds no ProfilerStep range")
    w0 = min(c[1] for c in step_ranges)
    w1 = max(c[2] for c in step_ranges)
    main_thread = step_ranges[0][3]
    launches = {c[4]: (c[1], c[3]) for c in cpu if c[4]}
    ops = []
    for name, s, e, corr in dev:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            ops.append((name, s, e, launches.get(corr)))
    busy = _merge([(s, e) for _, s, e, _ in ops])
    busy_ns = sum(e - s for s, e in busy)
    # the longest gaps between device work, each named by the innermost host
    # range of the main thread that covers its middle, or by the ranges
    # before and after it where none does
    gaps, edge = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > edge:
            gaps.append((s - edge, (edge + s) // 2))
        edge = max(edge, e)
    host = [c for c in cpu if c[3] == main_thread and not c[0].startswith("ProfilerStep#")]
    named = []
    for ns, mid in sorted(gaps, reverse=True)[:10]:
        covering = [c for c in host if c[1] <= mid <= c[2]]
        if covering:
            what = min(covering, key=lambda c: c[2] - c[1])[0]
        else:
            before = max((c for c in host if c[2] < mid), key=lambda c: c[2], default=None)
            after = min((c for c in host if c[1] > mid), key=lambda c: c[1], default=None)
            what = (f"host between {before[0] if before else 'start'} and "
                    f"{after[0] if after else 'end'}")
        named.append((ns / 1e9, what))
    n = len(step_ranges) if steps_expected is None else steps_expected
    return Stretch(steps=n, window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9, ops=ops,
                   ranges=[(c[0], c[1], c[2], c[3]) for c in cpu], gaps=named,
                   info=dict(info or {}))
