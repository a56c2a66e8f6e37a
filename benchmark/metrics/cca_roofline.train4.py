"""cca_roofline.train4: ``cca_roofline.train`` read in the 4-card training cell, which reports
``train4_crops_per_s`` (its runs spread too widely to share a bound with one card's)."""

from benchmark.work.ops import cca_bound_s


def read(t):
    if t.info.get("kind") != "train" or not t.info.get("recurrence"):
        return None
    spent = t.device_s_within("CrissCrossAttentionFn")
    if spent <= 0:
        return None
    shape = (t.info["batch"], *t.info["feature_hw"], t.info["qk"], t.info["v"])
    dtype = t.info["dtype"]
    size = 2 if dtype in ("bfloat16", "float16") else 4
    per_call = cca_bound_s(shape, True, size, dtype) + cca_bound_s(shape, False, size, dtype)
    return 100.0 * t.info["recurrence"] * per_call * t.steps / spent
