"""device_idle.train4: ``device_idle.train`` read in the 4-card training cell, which reports
``train4_crops_per_s`` (its runs spread too widely to share a bound with one card's)."""


def read(t):
    if t.info.get("kind") != "train" or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
