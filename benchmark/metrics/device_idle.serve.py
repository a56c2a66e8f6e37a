"""device_idle.serve: the share of the traced stretch of serving in which
no operation runs on the card."""


def read(t):
    if t.info.get("kind") != "serve" or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
