"""layout_ms.train: device milliseconds per training step in cuDNN's layout
transposes (``nchwToNhwc``, ``nhwcToNchw``): work a channels-last trunk
would not do."""

NAMES = ("nchwToNhwc", "nhwcToNchw")


def read(t):
    if t.info.get("kind") != "train" or not t.ops:
        return None
    return 1e3 * t.device_s(NAMES) / t.steps
