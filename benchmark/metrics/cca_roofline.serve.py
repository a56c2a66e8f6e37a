"""cca_roofline.serve: the criss-cross attention's forward bound over its
device time in serving (R calls an image over its batch of tiles)."""

from benchmark.work.ops import cca_bound_s


def read(t):
    if t.info.get("kind") != "serve" or not t.info.get("recurrence"):
        return None
    spent = t.device_s_within("CrissCrossAttentionFn")
    if spent <= 0:
        return None
    shape = (t.info["batch"], *t.info["feature_hw"], t.info["qk"], t.info["v"])
    dtype = t.info["dtype"]
    size = 2 if dtype in ("bfloat16", "float16") else 4
    return 100.0 * t.info["recurrence"] * cca_bound_s(shape, True, size, dtype) * t.steps / spent
