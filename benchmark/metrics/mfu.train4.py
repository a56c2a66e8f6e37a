"""mfu.train4: ``mfu.train`` read in the 4-card training cell, which reports
``train4_crops_per_s`` (its runs spread too widely to share a bound with one card's)."""


def read(t):
    if t.info.get("kind") != "train" or t.window_s <= 0:
        return None
    return 100.0 * t.info["flops_per_step"] * t.steps / t.window_s / t.info["peak_flops"]
