"""collective_host_ms.train4: host milliseconds per training step that
rank 0 spends inside the program's ``ccnet.collective.*`` spans, on any
thread (global BN's backward runs on the autograd thread). DDP's gradient
all-reduce runs in its C++ reducer, outside these spans."""

from benchmark.work.spans import host_within


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) < 2 or not t.ops:
        return None
    host = host_within(t, "ccnet.collective.")
    return None if host is None else 1e3 * host / t.steps
