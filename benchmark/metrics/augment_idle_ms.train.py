"""augment_idle_ms.train: milliseconds per training step in which the card
is idle while the program's span ``ccnet.train.augment`` is open (the
device augmenter, whose draws and mean are copied to the card from
pageable memory, each copy a host sync), on one card."""

from benchmark.work.spans import idle_within


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) != 1 or not t.ops:
        return None
    idle = idle_within(t, {"ccnet.train.augment"})
    return None if idle is None else 1e3 * idle / t.steps
