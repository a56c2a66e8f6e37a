"""collective_mib.train4: MiB rank 0's collectives carry per training step
over several cards: the program's ``collective.<kind>.bytes`` counters
over its ``train.steps``, over the whole run (DDP's gradient buckets
counted from the reducer's bucket plan)."""

from benchmark.work.spans import per, program_counts


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) < 2 or not t.ops:
        return None
    value = per(program_counts(), "collective.", ".bytes", "train.steps")
    return None if value is None else value / 2 ** 20
