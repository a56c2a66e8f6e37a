"""step_idle_ms.train: milliseconds per training step in which the card is
idle while one of the train step's phase spans is open
(``ccnet.train.forward``, ``.loss``, ``.backward``, ``.optimizer``): the
host's launch pace and its syncs inside the step, on one card."""

from benchmark.work.spans import idle_within

PHASES = {f"ccnet.train.{p}" for p in ("forward", "loss", "backward", "optimizer")}


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) != 1 or not t.ops:
        return None
    idle = idle_within(t, PHASES)
    return None if idle is None else 1e3 * idle / t.steps
