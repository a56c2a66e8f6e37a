"""The program's own spans and counters, read for the per-layer metrics.

The port names its layer boundaries as ``torch.profiler`` ranges
``ccnet.<span>`` (``ccnet_tpu_torch/utils/trace.py``), on the trace's own
clock, so a stretch (:class:`benchmark.trace.Stretch`) holds them among its
host ranges beside the device's operations:

* :func:`idle_within`: seconds of the stretch in which the card runs
  nothing while one of the named spans is open (on any thread);
* :func:`host_within`: seconds the host spends inside spans whose name
  starts with a prefix, each thread's spans merged, summed over threads.

The counters are the program's process-wide totals
(:func:`program_counts`, read in the run's own process, rank 0's), from which
:func:`per` forms ratios per step or request. A program without the
spans or the counters (one older than them) reads None everywhere.
"""

from __future__ import annotations

from benchmark.trace import _merge


def idle(t) -> list:
    """The intervals of the profiled steps (their ``ProfilerStep#`` ranges)
    in which no device operation runs."""
    steps = [(s, e) for n, s, e, _ in t.ranges if n.startswith("ProfilerStep#")]
    w0, w1 = min(s for s, _ in steps), max(e for _, e in steps)
    out, edge = [], w0
    for s, e in _merge([(s, e) for _, s, e, _ in t.ops]) + [[w1, w1]]:
        if s > edge:
            out.append((edge, s))
        edge = max(edge, e)
    return out


def overlap_ns(a: list, b: list) -> int:
    """The length both of two sorted lists of disjoint intervals cover."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_within(t, names):
    """Seconds the card is idle while a range named one of ``names`` is
    open; None where the stretch holds none of them."""
    covered = _merge([(s, e) for n, s, e, _ in t.ranges if n in names])
    if not covered:
        return None
    return overlap_ns(idle(t), covered) / 1e9


def host_within(t, prefix: str):
    """Seconds of host time inside ranges whose name starts with
    ``prefix``, merged per thread and summed over threads; None where
    there is none."""
    by_thread = {}
    for n, s, e, th in t.ranges:
        if n.startswith(prefix):
            by_thread.setdefault(th, []).append((s, e))
    if not by_thread:
        return None
    return sum(e - s for iv in by_thread.values() for s, e in _merge(iv)) / 1e9


def program_counts():
    """The program's counters (``ccnet_tpu_torch.utils.trace.counts()``),
    or None where the program has none."""
    try:
        from ccnet_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace.counts()


def per(counts, prefix: str, suffix: str, base: str):
    """The sum of the counters named ``prefix…suffix`` over the counter
    ``base``; None where ``base`` is missing or 0."""
    if not counts or not counts.get(base):
        return None
    total = sum(v for k, v in counts.items() if k.startswith(prefix) and k.endswith(suffix))
    return total / counts[base]
