"""cca_roofline.train: the criss-cross attention's bound over its device time
in training.

The time is that of the device operations launched inside the ranges of
``CrissCrossAttentionFn``'s forward and backward (K1–K4 and what the
wrapper runs around them); the bound counts the op's own inputs and outputs
at the value dtype and ``benchmark.work.ops.cca_flops``, R calls a step
forward and backward. Where the program renames the op the reading is
empty, and the benchmark's next change points it at the new one."""

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
