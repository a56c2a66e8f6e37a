"""collective_calls.train4: collectives rank 0 issues per training step
over several cards: the program's ``collective.<kind>.calls`` counters
(global BN's moments and gradient sums, OHEM's counts, the loss means and
sum, DDP's gradient buckets) over its ``train.steps``, over the whole run."""

from benchmark.work.spans import per, program_counts


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) < 2 or not t.ops:
        return None
    return per(program_counts(), "collective.", ".calls", "train.steps")
