"""layout_ms.serve: device milliseconds per served image in cuDNN's layout
transposes (``nchwToNhwc``, ``nhwcToNchw``)."""

NAMES = ("nchwToNhwc", "nhwcToNchw")


def read(t):
    if t.info.get("kind") != "serve" or not t.ops:
        return None
    return 1e3 * t.device_s(NAMES) / t.steps
