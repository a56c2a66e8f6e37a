"""step_idle_ms.train4: step_idle_ms.train on rank 0 of a run over several
cards, where the phases also wait on the collectives."""

from benchmark.work.spans import idle_within

PHASES = {f"ccnet.train.{p}" for p in ("forward", "loss", "backward", "optimizer")}


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) < 2 or not t.ops:
        return None
    idle = idle_within(t, PHASES)
    return None if idle is None else 1e3 * idle / t.steps
