"""augment_idle_ms.train4: augment_idle_ms.train on rank 0 of a run over
several cards (each rank augments its share of the global batch)."""

from benchmark.work.spans import idle_within


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) < 2 or not t.ops:
        return None
    idle = idle_within(t, {"ccnet.train.augment"})
    return None if idle is None else 1e3 * idle / t.steps
