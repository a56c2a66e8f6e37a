"""layout_ms.train4: ``layout_ms.train`` read in the 4-card training cell, which reports
``train4_crops_per_s`` (its runs spread too widely to share a bound with one card's)."""

NAMES = ("nchwToNhwc", "nhwcToNchw")


def read(t):
    if t.info.get("kind") != "train" or not t.ops:
        return None
    return 1e3 * t.device_s(NAMES) / t.steps
