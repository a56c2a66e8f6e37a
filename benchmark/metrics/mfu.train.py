"""mfu.train: the training step's model FLOPs (three forwards of the plain
reference at the cell's per-card batch, recomputation not counted) per
second of the traced stretch, as a share of the card's bf16 peak."""


def read(t):
    if t.info.get("kind") != "train" or t.window_s <= 0:
        return None
    return 100.0 * t.info["flops_per_step"] * t.steps / t.window_s / t.info["peak_flops"]
