"""The readers of the program's spans and counters, on hand-built stretches."""

import importlib.util
import os
import sys

import pytest

from benchmark.trace import Stretch
from benchmark.work import spans

METRICS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "metrics")


def _reader(name):
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  os.path.join(METRICS, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _stretch(kind="train", ranks=1, ops=None, ranges=()):
    """Two steps of 1000 ns; by default device work in [100, 300), [500, 600)
    and [1200, 1900): idle [0, 100), [300, 500), [600, 1200), [1900, 2000)."""
    ops = [("k", 100, 300, None), ("k", 500, 600, None), ("k", 1200, 1900, None)] \
        if ops is None else ops
    steps = [("ProfilerStep#3", 0, 1000, 1), ("ProfilerStep#4", 1000, 2000, 1)]
    return Stretch(steps=2, window_s=2e-6, busy_s=1e-6, ops=ops, ranges=steps + list(ranges),
                   gaps=[], info={"kind": kind, "ranks": ranks})


TRAIN = [("ccnet.train.augment", 0, 150, 1), ("ccnet.train.forward", 150, 700, 1),
         ("aten::to", 20, 40, 1), ("ccnet.train.backward", 1000, 1300, 1),
         ("ccnet.train.optimizer", 1850, 1990, 1), ("ccnet.collective.bn_grad", 1100, 1150, 2),
         ("ccnet.collective.bn_grad", 1120, 1160, 2), ("ccnet.collective.loss", 1950, 1960, 1)]


def test_idle_and_overlap_by_hand():
    t = _stretch(ranges=TRAIN)
    assert spans.idle(t) == [(0, 100), (300, 500), (600, 1200), (1900, 2000)]
    assert spans.overlap_ns([(0, 10), (20, 30)], [(5, 25)]) == 10
    # augment [0, 150): idle [0, 100)
    assert spans.idle_within(t, {"ccnet.train.augment"}) == pytest.approx(100e-9)
    # forward [150, 700): 200 + 100; backward [1000, 1300): 200; optimizer
    # [1850, 1990): 90
    assert spans.idle_within(t, {"ccnet.train.forward", "ccnet.train.backward",
                                 "ccnet.train.optimizer"}) == pytest.approx(590e-9)
    assert spans.idle_within(t, {"ccnet.serve.place"}) is None
    # thread 2's two overlapping spans merge to [1100, 1160); thread 1's 10
    assert spans.host_within(t, "ccnet.collective.") == pytest.approx(70e-9)
    assert spans.host_within(t, "ccnet.nothing.") is None


@pytest.mark.parametrize("name,kind,ranks,want", [
    ("augment_idle_ms.train", "train", 1, 100e-9 * 1e3 / 2),
    ("augment_idle_ms.train4", "train", 4, 100e-9 * 1e3 / 2),
    ("step_idle_ms.train", "train", 1, 590e-9 * 1e3 / 2),
    ("step_idle_ms.train4", "train", 4, 590e-9 * 1e3 / 2),
    ("collective_host_ms.train4", "train", 4, 70e-9 * 1e3 / 2),
])
def test_span_readers_per_step(name, kind, ranks, want):
    read = _reader(name)
    assert read(_stretch(kind, ranks, ranges=TRAIN)) == pytest.approx(want)
    assert read(_stretch(kind, ranks)) is None  # a program without the spans
    assert read(_stretch(kind, ranks, ops=[], ranges=TRAIN)) is None  # no card
    other = 4 if ranks == 1 else 1
    assert read(_stretch(kind, other, ranges=TRAIN)) is None  # the other cells' reader


def test_copy_idle_per_image():
    read = _reader("copy_idle_ms.serve")
    ranges = [("ccnet.serve.place", 0, 120, 1), ("ccnet.serve.fetch", 1850, 2000, 1),
              ("ccnet.serve.place", 1300, 1350, 1)]
    # place [0, 120) idle 100, [1300, 1350) none; fetch [1900, 2000) 100
    assert read(_stretch("serve", ranges=ranges)) == pytest.approx(200e-9 * 1e3 / 2)
    assert read(_stretch("serve")) is None
    assert read(_stretch("train", ranges=ranges)) is None


COUNTS = {"train.steps": 4, "serve.requests": 5, "sync.augment.draws": 28,
          "sync.augment.mean": 4, "sync.ohem.bounds": 12, "sync.serve.fetch": 5,
          "collective.bn.calls": 400, "collective.bn.bytes": 3 * 2 ** 20,
          "collective.ddp_grad.calls": 40, "collective.ddp_grad.bytes": 1000 * 2 ** 20,
          "collective.loss.calls": 12, "collective.loss.bytes": 48}


@pytest.mark.parametrize("name,kind,ranks,want", [
    ("host_syncs.train", "train", 1, (28 + 4 + 12 + 5) / 4),
    ("host_syncs.serve", "serve", 1, (28 + 4 + 12 + 5) / 5),
    ("collective_calls.train4", "train", 4, (400 + 40 + 12) / 4),
    ("collective_mib.train4", "train", 4, (3 + 1000 + 48 / 2 ** 20) / 4),
])
def test_counter_readers(monkeypatch, name, kind, ranks, want):
    import ccnet_tpu_torch.utils
    from ccnet_tpu_torch.utils import trace

    read = _reader(name)
    monkeypatch.setattr(trace, "COUNTS", dict(COUNTS))
    assert read(_stretch(kind, ranks)) == pytest.approx(want)
    assert read(_stretch(kind, ranks, ops=[])) is None  # no card: no device number
    monkeypatch.setattr(trace, "COUNTS", {})
    assert read(_stretch(kind, ranks)) is None  # nothing counted
    monkeypatch.delattr(ccnet_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "ccnet_tpu_torch.utils.trace", None)
    assert spans.program_counts() is None  # a program without the counters
    assert read(_stretch(kind, ranks)) is None
