"""copy_idle_ms.serve: milliseconds per served image in which the card is
idle while the program's span ``ccnet.serve.place`` (the image's copy in)
or ``ccnet.serve.fetch`` (the trainIds' blocking copy out) is open."""

from benchmark.work.spans import idle_within


def read(t):
    if t.info.get("kind") != "serve" or not t.ops:
        return None
    idle = idle_within(t, {"ccnet.serve.place", "ccnet.serve.fetch"})
    return None if idle is None else 1e3 * idle / t.steps
