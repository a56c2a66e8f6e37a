"""The yardstick's counts pinned against hand counts at tiny shapes."""

import pytest
import torch

from benchmark.reference import models as R
from benchmark.reference.heads.ccnet import TorchCCA
from benchmark.work import flops, ops, peaks

TINY = {"model": "ccnet", "num_classes": 19, "layers": [1, 1, 1, 1], "recurrence": 2}


def _hand_count(config, batch, hw):
    """2 · (multiply-adds) of every convolution, from its output shape, plus
    the attention's four products per call."""
    net = R.build(config, device="meta")
    total = []

    def conv(mod, inp, out):
        k = mod.weight.shape[1] * mod.weight.shape[2] * mod.weight.shape[3]
        total.append(2 * out.numel() * k)

    def cca(mod, inp, out):
        B, C, H, W = inp[0].shape
        cq = mod.query_conv.out_channels
        total.append(2 * B * H * W * (H + W) * (cq + C))

    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            m.register_forward_hook(conv)
        if isinstance(m, TorchCCA):
            m.register_forward_hook(cca)
    with torch.no_grad():
        net(torch.empty((batch, 3, *hw), device="meta"))
    return sum(total)


@pytest.mark.parametrize("model", ["ccnet", "deeplabv3"])
def test_forward_flops_equal_hand_count(model):
    config = dict(TINY, model=model)
    counted, shape = flops.forward_flops(config, 2, (65, 65))
    assert counted == _hand_count(config, 2, (65, 65))
    assert shape == (2, 19, 9, 9)
    assert flops.train_step_flops(config, 2, (65, 65)) == 3 * counted


def test_cca_flops_hand_count():
    # (B, H, W, Cq, Cv) = (1, 2, 3, 4, 5): columns 1·3·2² = 12 pairs, rows
    # 1·2·3² = 18; forward 2·(4 + 5) = 18 a pair, backward 2·(12 + 10) = 44
    shape = (1, 2, 3, 4, 5)
    assert ops.cca_flops(shape, True, "col") == 12 * 18
    assert ops.cca_flops(shape, True, "row") == 18 * 18
    assert ops.cca_flops(shape, False, "col") == 12 * 44
    assert ops.cca_flops(shape, False, "row") == 18 * 44


def test_cca_bound_hand_count():
    # 6 pixels; forward bytes 6·(4 + 4 + 5 + 5)·2 = 216, backward
    # 6·(4 + 4 + 5 + 5 + 4 + 4 + 5)·2 = 372; operations far below
    shape = (1, 2, 3, 4, 5)
    assert ops.cca_bound_s(shape, True, 2, "bfloat16") == 216 / peaks.HBM_BYTES_PER_S
    assert ops.cca_bound_s(shape, False, 2, "bfloat16") == 372 / peaks.HBM_BYTES_PER_S
    big = (1, 100, 100, 64, 512)
    fwd_ops = ops.cca_flops(big, True, "col") + ops.cca_flops(big, True, "row")
    assert ops.cca_bound_s(big, True, 2, "bfloat16") == max(
        10000 * 1152 * 2 / peaks.HBM_BYTES_PER_S, fwd_ops / peaks.FLOPS["bfloat16"])


def test_nll_bound_hand_count():
    # logits (1, 2, 3, 3) f32 = 72 bytes, labels and loss (1, 17, 17) = 1156
    # bytes each; 289 pixels · 2 classes · 8 (forward) or 14 operations
    fwd = ops.nll_bound_s((1, 2, 3, 3), (1, 17, 17), True)
    bwd = ops.nll_bound_s((1, 2, 3, 3), (1, 17, 17), False)
    assert fwd == max((72 + 2 * 1156) / peaks.HBM_BYTES_PER_S, 289 * 2 * 8 / 67e12)
    assert bwd == max((2 * 72 + 2 * 1156) / peaks.HBM_BYTES_PER_S, 289 * 2 * 14 / 67e12)


def test_published_sizes():
    """The counts the predictions in PERF.md rest on, at the cells' shapes."""
    full = dict(TINY, layers=[3, 4, 23, 3])
    assert flops.forward_flops(full, 8, (769, 769))[0] == 11166292622336
    assert flops.forward_flops(dict(full, model="deeplabv3"), 8, (769, 769))[0] \
        == 9790873218048
