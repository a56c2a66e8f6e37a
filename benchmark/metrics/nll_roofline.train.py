"""nll_roofline.train: the upsampled NLL's bound over its device time.

The time is that of the device operations launched inside the ranges of
``UpsampledNLLFn``'s forward and backward (the port's K5/K6 and what its
wrapper runs around them); the bound counts, per call, the op's own inputs
and outputs (``benchmark.work.ops.nll_bound_s``), one call per DSN head a
step, forward and backward. Where the program renames the op the reading
is empty, and the benchmark's next change points it at the new one."""

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
