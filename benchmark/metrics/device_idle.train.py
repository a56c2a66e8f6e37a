"""device_idle.train: the share of the traced stretch of training in which
no operation runs on the card (one less the union of the device
operations' intervals over the stretch)."""


def read(t):
    if t.info.get("kind") != "train" or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
