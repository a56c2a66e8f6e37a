"""cam_ms.train: device milliseconds a training step launched inside the
ranges of DANet's ``ChannelAttentionFn``, forward and backward (its f32
energies and softmax and the products around them). None where no such
range exists: every model but DANet."""


def read(t):
    if t.info.get("kind") != "train" or t.steps <= 0:
        return None
    spent = t.device_s_within("ChannelAttentionFn")
    if spent <= 0:
        return None
    return 1e3 * spent / t.steps
