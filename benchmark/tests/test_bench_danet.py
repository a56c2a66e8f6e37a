"""The DANet cell on the CPU: its files found by name, the reference built,
counted and trained at small sizes, the position attention's bound and the
three readers that only this cell reports, on hand-built stretches.

The no-import walk of ``reference/`` (``test_bench_reference.py``) covers
``heads/danet.py``."""

import os
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import harness, inputs
from benchmark.reference import models as R
from benchmark.reference import train as RT
from benchmark.reference.heads.danet import PAM
from benchmark.trace import Stretch
from benchmark.work import flops, pam, peaks

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import _tiny  # noqa: E402
from test_bench_spans import _reader  # noqa: E402

CELL = "danet_r101.train769"
OWN = ("pam_roofline.train", "cam_ms.train", "pam_fused_share.train")
SEED = 2 ** 31 + 17


def test_cell_builds_counts_and_trains_tiny(tmp_path):
    cell = harness.find_cell(CELL, _tiny.tiny_root(tmp_path))
    cfg, tr = cell.config, cell.traffic
    assert cfg["model"] == "danet" and cell.chips == 1 and tr["driver"] == "train"
    assert set(OWN) <= {m["name"] for m in cell.per_layer}
    assert "cca_roofline.train" not in {m["name"] for m in cell.per_layer}
    counted, shape = flops.forward_flops(cfg, 2, (65, 65))
    assert counted > 0 and shape == (2, 19, 9, 9)
    net = R.build(cfg)
    R.load(net, inputs.weights(R.state_names(R.build(cfg, device="meta")), SEED, "cpu"))
    assert [m.channels for m in net.dropouts()] == [512, 512]  # the DSN's, then conv8's
    pool, labels = inputs.frames(SEED, tr["pool"], tr["frame_hw"], cfg["num_classes"],
                                 cfg["ignore_label"], tr["block"], tr["border"], tr["noise"],
                                 "cpu")
    got = RT.train_steps(net, pool, labels, [[0, 1]], cfg, tr, SEED, 1)
    assert len(got["losses"]) == 1 and torch.isfinite(torch.tensor(got["losses"])).all()
    assert got["loss_grad"]["head.sa.gamma"] > 0 and got["loss_grad"]["head.sc.gamma"] > 0


def test_train_step_flops_at_cell_size():
    """Three forwards of the reference at batch 8 of 769² (the number the
    card printed too); 0.82 TFLOP of each forward is the position
    attention's two products (B·N²·2·(64 + 512), N = 97²)."""
    cfg = harness.find_cell(CELL).config
    assert flops.train_step_flops(cfg, 8, (769, 769)) == 35934395559936.0
    assert pam.pam_flops((8, 97 * 97, 64, 512), True) == 8 * 9409 ** 2 * 2 * 576


def test_pam_flops_equal_reference_count():
    """The reference's position attention counted on the meta device: its
    three 1×1 convolutions plus exactly :func:`pam_flops`'s forward."""
    B, C, H, W = 2, 64, 5, 7
    mod = PAM(C).to("meta")
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        mod(torch.empty((B, C, H, W), device="meta"))
    convs = 2 * B * H * W * C * (C // 8 + C // 8 + C)
    assert counter.get_total_flops() - convs == pam.pam_flops((B, H * W, C // 8, C), True)


def test_pam_bound_hand_count():
    # (B, N, Cq, Cv) = (2, 100, 8, 16): 20000 pairs; forward 2·(8 + 16) = 48
    # operations a pair, backward 2·(24 + 32) = 112; forward bytes
    # 200·((16 + 32)·2 + 4) = 20000, backward 200·(16 + 48 + 16 + 16)·2 = 38400
    shape = (2, 100, 8, 16)
    assert pam.pam_flops(shape, True) == 20000 * 48
    assert pam.pam_flops(shape, False) == 20000 * 112
    assert pam.pam_bound_s(shape, True, "bfloat16") == 20000 / peaks.HBM_BYTES_PER_S
    assert pam.pam_bound_s(shape, False, "bfloat16") == 38400 / peaks.HBM_BYTES_PER_S
    big = (8, 9409, 64, 512)
    assert pam.pam_bound_s(big, True, "bfloat16") == pam.pam_flops(big, True) / 989e12
    assert pam.pam_bound_s(big, False, "bfloat16") == pam.pam_flops(big, False) / 989e12


def _stretch(ranges, ops, info):
    steps = [("ProfilerStep#3", 0, 1000, 1), ("ProfilerStep#4", 1000, 2000, 1)]
    return Stretch(steps=2, window_s=2e-6, busy_s=1e-6, ops=ops, ranges=steps + ranges,
                   gaps=[], info=info)


INFO = {"kind": "train", "batch": 8, "feature_hw": (97, 97), "qk": 64, "v": 512,
        "dtype": "bfloat16", "ranks": 1}
# 1.5 ms of the position attention a step (forward on thread 1, backward on
# the autograd thread 2) and 0.25 ms of the channel attention, launched
# inside their ranges; a convolution outside both
RANGES = [("PositionAttentionFn", 100, 200, 1), ("PositionAttentionFnBackward", 1100, 1200, 2),
          ("ChannelAttentionFn", 300, 320, 1), ("ChannelAttentionFnBackward", 1300, 1320, 2)]
OPS = [("fmha_fwd", 150, 1_000_150, (150, 1)), ("fmha_bwd", 1150, 2_001_150, (1150, 2)),
       ("gemm", 310, 250_310, (310, 1)), ("gemm", 1310, 250_310, (1310, 2)),
       ("conv", 400, 900, (400, 1))]


def test_readers_by_hand():
    t = _stretch(RANGES, OPS, INFO)
    bound = (pam.pam_bound_s((8, 9409, 64, 512), True, "bfloat16")
             + pam.pam_bound_s((8, 9409, 64, 512), False, "bfloat16"))
    spent = (1_000_000 + 2_000_000) / 1e9
    assert _reader("pam_roofline.train")(t) == pytest.approx(100 * bound * 2 / spent)
    assert _reader("cam_ms.train")(t) == pytest.approx(1e3 * (250_000 + 249_000) / 1e9 / 2)


@pytest.mark.parametrize("name", OWN[:2])
def test_readers_silent_elsewhere(name):
    """No such range (every other model, or a program without DANet), or a
    serving stretch: None."""
    read = _reader(name)
    assert read(_stretch([], OPS, INFO)) is None
    assert read(_stretch(RANGES, OPS, dict(INFO, kind="serve"))) is None


def test_fused_share_reader(monkeypatch):
    from ccnet_tpu_torch.utils import trace

    read = _reader("pam_fused_share.train")
    t = _stretch(RANGES, OPS, INFO)
    monkeypatch.setattr(trace, "COUNTS", {"danet.pam.sdpa": 15, "danet.cam.calls": 15})
    assert read(t) == 100.0
    monkeypatch.setattr(trace, "COUNTS", {"danet.pam.sdpa": 3, "danet.pam.plain": 1})
    assert read(t) == 75.0
    assert read(_stretch(RANGES, [], INFO)) is None  # no card
    monkeypatch.setattr(trace, "COUNTS", {"train.steps": 4})
    assert read(t) is None  # no position attention counted: every other model


@pytest.mark.gpu
def test_control_and_faults_fail_at_cell_size():
    """At the cell's own size and limits: the fp8 control, half a batch and
    mirrored crops each fail at least one limit (the program's f32 readings
    pass them all, PERF.md §2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    from benchmark import calibrate

    cell = harness.find_cell(CELL)
    got = calibrate._train_variants(cell, 2 ** 31 + 1234, torch.device("cuda:0"),
                                    cell.driver())
    for name in ("control_fp8", "half_batch", "mirror"):
        assert any(got[name][k] > limit for k, limit in cell.limits.items()), name
