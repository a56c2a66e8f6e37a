"""mfu.serve: a served image's model FLOPs (one forward of the plain
reference over its tiles) per second of the traced stretch, as a share of
the card's bf16 peak."""


def read(t):
    if t.info.get("kind") != "serve" or t.window_s <= 0:
        return None
    return 100.0 * t.info["flops_per_step"] * t.steps / t.window_s / t.info["peak_flops"]
