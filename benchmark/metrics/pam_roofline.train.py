"""pam_roofline.train: DANet's position attention's bound over its device
time in training.

The time is that of the device operations launched inside the ranges of
``PositionAttentionFn``'s forward and backward (whichever route runs the
op, and what the op runs around it); the bound counts the op's own inputs
and outputs at the value dtype and its FLOPs (``benchmark.work.pam``), one
call a step forward and backward. None where no such range exists: every
model but DANet, and a program that names the op otherwise."""

from benchmark.work.pam import pam_bound_s


def read(t):
    if t.info.get("kind") != "train" or not t.info.get("qk") or not t.info.get("v"):
        return None
    spent = t.device_s_within("PositionAttentionFn")
    if spent <= 0:
        return None
    h, w = t.info["feature_hw"]
    shape = (t.info["batch"], h * w, t.info["qk"], t.info["v"])
    dtype = t.info["dtype"]
    per_call = pam_bound_s(shape, True, dtype) + pam_bound_s(shape, False, dtype)
    return 100.0 * per_call * t.steps / spent
