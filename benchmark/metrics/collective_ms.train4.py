"""collective_ms.train4: device milliseconds per training step of rank 0 in
NCCL's kernels (global BN's moments, OHEM's counts, the loss sum and DDP's
gradient all-reduce)."""


def read(t):
    if t.info.get("kind") != "train" or t.info.get("ranks", 1) < 2 or not t.ops:
        return None
    return 1e3 * t.device_s(("nccl",)) / t.steps
