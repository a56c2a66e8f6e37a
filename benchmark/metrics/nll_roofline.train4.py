"""nll_roofline.train4: ``nll_roofline.train`` read in the 4-card training cell, which reports
``train4_crops_per_s`` (its runs spread too widely to share a bound with one card's)."""

from benchmark.work.ops import nll_bound_s


def read(t):
    if t.info.get("kind") != "train":
        return None
    spent = t.device_s_within("UpsampledNLLFn")
    if spent <= 0:
        return None
    B, C = t.info["batch"], t.info["classes"]
    logits = (B, C, *t.info["feature_hw"])
    labels = (B, *t.info["crop"])
    per_call = nll_bound_s(logits, labels, True) + nll_bound_s(logits, labels, False)
    return 100.0 * t.info["nll_calls"] * per_call * t.steps / spent
