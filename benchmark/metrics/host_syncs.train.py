"""host_syncs.train: blocking transfers between the host and the card per
training step, on one card: the program's ``sync.*`` counters over its
``train.steps``, both over the whole run. None without a card."""

from benchmark.work.spans import per, program_counts


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) != 1 or not t.ops:
        return None
    return per(program_counts(), "sync.", "", "train.steps")
