"""The port's spans and counters (``ccnet_tpu_torch/utils/trace.py``).

* With no profiler recording, :func:`span` enters no ``record_function``;
  under ``torch.profiler`` a train step of a small trunk and a served image
  leave their ``ccnet.*`` ranges in order, inside the schedule's
  ``ProfilerStep#`` ranges, and the benchmark's reduction of the trace
  finds the same device work with the spans as without them;
* the counters: ``train.steps`` and ``serve.requests``; the blocking
  transfers between the host and a card (``sync.*``), counted by hand with
  the crossing predicate forced on the CPU, and none on the CPU itself;
  no collective counted in one process;
* on the card (``gpu``): every ``sync.*`` the train step and a served image
  count is a synchronising CUDA operation that torch's sync debug mode
  reports, and none goes uncounted.

The file imports no JAX; on the card it runs as
``python -m pytest --noconftest tests/test_torch_trace.py -q``.
"""

import contextlib
import types
import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, schedule

from benchmark.trace import reduce
from ccnet_tpu_torch.data.preprocess import device_augment_batch
from ccnet_tpu_torch.evaluation import Evaluator
from ccnet_tpu_torch.losses.ohem import ohem_keep_mask
from ccnet_tpu_torch.models import build_model, registry
from ccnet_tpu_torch.parallel import all_reduce_sum, rank_gather
from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer
from ccnet_tpu_torch.utils import trace

LAYERS = (1, 1, 1, 1)
CLASSES = 5
STEP_SPANS = ["ccnet.train.augment", "ccnet.train.optimizer", "ccnet.train.forward",
              "ccnet.train.loss", "ccnet.train.backward", "ccnet.train.optimizer"]
SERVE_SPANS = ["ccnet.serve.place", "ccnet.serve.fetch"]


@pytest.fixture(autouse=True)
def _small(monkeypatch):
    """``depth=50`` builds the one-block-a-layer trunk; two threads."""
    monkeypatch.setitem(registry._DEPTH_LAYERS, 50, LAYERS)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _trainer(device="cpu") -> Trainer:
    return Trainer(TrainConfig(depth=50, num_classes=CLASSES, input_size=(33, 33),
                               batch_size=2, bf16=False, ohem=True, ohem_keep=500,
                               export_pth=False, device=device))


def _frames(device="cpu", seed=0):
    rng = np.random.RandomState(seed)
    images = torch.from_numpy(rng.randint(0, 256, (2, 48, 64, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.randint(0, CLASSES, (2, 48, 64)).astype(np.uint8))
    return images.to(device), labels.to(device)


def _train(trainer, images, labels, step):
    imgs, lbls = trainer._augment(images, labels, step)
    return trainer.train_step(trainer.state, imgs, lbls)


def _evaluator(device="cpu") -> Evaluator:
    model = build_model("ccnet", num_classes=CLASSES, depth=50, seed=1, device=device).eval()
    return Evaluator(lambda x: model(x)["main"], num_classes=CLASSES, tile_hw=(33, 33),
                     device=device)


def _image(seed=0) -> np.ndarray:
    return np.random.RandomState(seed).randint(0, 256, (1, 40, 56, 3)).astype(np.uint8)


def _profiled(work, steps: int = 2, device="cpu"):
    """The raw events of ``steps`` calls of ``work(i)`` recorded after one
    skipped call and a warm-up call, as the benchmark's schedule does."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    box = []
    with profile(activities=activities, schedule=schedule(wait=1, warmup=1, active=steps,
                                                          repeat=1),
                 on_trace_ready=lambda p: box.append(p.profiler.kineto_results.events())) as p:
        for i in range(steps + 2):
            work(i)
            p.step()
    return box[0]


def _host(events) -> list:
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in events if str(e.device_type()).endswith("CPU")),
                  key=lambda r: r[1])


def _spans_by_step(events) -> list:
    """The ``ccnet.*`` range names inside each ``ProfilerStep#`` range, in
    order; every ``ccnet.*`` range must lie inside one."""
    host = _host(events)
    steps = [r for r in host if r[0].startswith("ProfilerStep#")]
    spans = [r for r in host if r[0].startswith("ccnet.")]
    inside = [[n for n, s, e in spans if s0 <= s and e <= e0] for _, s0, e0 in steps]
    assert sum(map(len, inside)) == len(spans)
    return inside


def test_span_without_profiler_enters_no_record_function(monkeypatch):
    """(torch's optimizer enters its own ranges through the same function.)"""
    entered = []
    monkeypatch.setattr(trace._profiler, "record_function",
                        lambda name: entered.append(name) or contextlib.nullcontext())
    trainer, (images, labels) = _trainer(), _frames()
    _train(trainer, images, labels, 0)
    _evaluator().predict_batch(_image())
    assert [n for n in entered if n.startswith("ccnet.")] == []
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("probe"):
            pass
    assert [n for n in entered if n.startswith("ccnet.")] == ["ccnet.probe"]


def test_train_step_spans_in_order_inside_profiler_steps():
    trainer, (images, labels) = _trainer(), _frames()
    events = _profiled(lambda i: _train(trainer, images, labels, i))
    assert _spans_by_step(events) == [STEP_SPANS, STEP_SPANS]


def test_predict_batch_spans_in_order_inside_profiler_steps():
    evaluator = _evaluator()
    events = _profiled(lambda i: evaluator.predict_batch(_image(i)))
    assert _spans_by_step(events) == [SERVE_SPANS, SERVE_SPANS]


@pytest.mark.parametrize("work", ["train", "serve"])
def test_spans_add_no_device_work_to_the_stretch(work):
    """The benchmark's reduction with the program's ranges and without them
    finds the same window, device operations and busy time."""
    if work == "train":
        trainer, (images, labels) = _trainer(), _frames()
        events = _profiled(lambda i: _train(trainer, images, labels, i))
    else:
        evaluator = _evaluator()
        events = _profiled(lambda i: evaluator.predict_batch(_image(i)))
    with_spans = reduce(events, 2)
    without = reduce([e for e in events if not e.name().startswith("ccnet.")], 2)
    assert any(r[0].startswith("ccnet.") for r in with_spans.ranges)
    assert (with_spans.window_s, with_spans.busy_s) == (without.window_s, without.busy_s)
    assert with_spans.ops == without.ops


def test_steps_and_requests_are_counted():
    before = trace.counts()
    trainer, (images, labels) = _trainer(), _frames()
    for step in range(2):
        _train(trainer, images, labels, step)
    evaluator = _evaluator()
    for i in range(3):
        evaluator.predict_batch(_image(i))
    after = trace.counts()
    assert after["train.steps"] - before.get("train.steps", 0) == 2
    assert after["serve.requests"] - before.get("serve.requests", 0) == 3


def _gained(before: dict, prefix: str) -> dict:
    return {k: v - before.get(k, 0) for k, v in trace.counts().items()
            if k.startswith(prefix) and v != before.get(k, 0)}


@pytest.mark.parametrize("crossing", [True, False])
def test_sync_counter_counts_each_blocking_transfer(monkeypatch, crossing):
    """By hand, with the crossing predicate forced: the augmenter copies 3
    draws an axis and the mirror flags (7) and the mean (1) to the card;
    OHEM its threshold and the bisection's two bounds (3); a served image's
    trainIds come back once. On the CPU itself: none."""
    if crossing:
        monkeypatch.setattr(trace, "crosses", lambda device: True)
    images, labels = _frames()
    before = trace.counts()
    device_augment_batch(images, labels, seed=1, step=0, crop_hw=(33, 33))
    p = torch.rand(2, 33, 33)
    ohem_keep_mask(p, torch.ones(2, 33, 33, dtype=torch.bool), thresh=0.7, min_kept=100)
    _evaluator().predict_batch(_image())
    want = {"sync.augment.draws": 7, "sync.augment.mean": 1, "sync.ohem.bounds": 3,
            "sync.serve.fetch": 1}
    assert _gained(before, "sync.") == (want if crossing else {})


def test_trainer_train_step_syncs_by_hand(monkeypatch):
    """One augmented OHEM train step: the augmenter's 8 transfers and
    OHEM's 3 (the main head; the auxiliary head takes no OHEM)."""
    monkeypatch.setattr(trace, "crosses", lambda device: True)
    trainer, (images, labels) = _trainer(), _frames()
    before = trace.counts()
    _train(trainer, images, labels, 0)
    assert sum(_gained(before, "sync.").values()) == 11


def test_one_process_counts_no_collective():
    before = trace.counts()
    t = torch.ones(3)
    assert all_reduce_sum(t, "loss") is t
    assert torch.equal(rank_gather(t, "gather"), t)
    assert _gained(before, "collective.") == {}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync count is of transfers to a card")
    return torch.device("cuda")


def _synchronising(work) -> list:
    """The call sites (``file:line``) of the synchronising CUDA operations
    ``work()`` makes, as torch's sync debug mode reports them."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            work()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [f"{w.filename}:{w.lineno}" for w in caught
            if "synchronizing CUDA operation" in str(w.message)]


@pytest.mark.gpu
def test_host_syncs_match_cuda_sync_debug(cuda):
    trainer, (images, labels) = _trainer("cuda"), _frames(cuda)
    evaluator = _evaluator("cuda")
    _train(trainer, images, labels, 0)  # builds the kernels
    evaluator.predict_batch(_image())
    torch.cuda.synchronize()
    before = trace.counts()
    seen = _synchronising(lambda: _train(trainer, images, labels, 1))
    counted = _gained(before, "sync.")
    assert sum(counted.values()) == len(seen) == 11, (counted, seen)
    before = trace.counts()
    seen = _synchronising(lambda: evaluator.predict_batch(_image(1)))
    counted = _gained(before, "sync.")
    assert counted == {"sync.serve.fetch": 1} and len(seen) == 1, (counted, seen)


@pytest.mark.gpu
def test_spans_are_not_device_work_on_the_card(cuda, monkeypatch):
    """On the card the profiler mirrors each span onto the device's timeline
    as an annotation: the reduction keeps none of them as device work, and
    a step traced with the spans shows the device operations of a step
    traced without them."""
    trainer, (images, labels) = _trainer("cuda"), _frames(cuda)

    def work(i):
        _train(trainer, images, labels, i)
        torch.cuda.synchronize()

    work(0)
    events = _profiled(work, device=cuda)
    mirrored = [e for e in events if str(e.device_type()).endswith("CUDA")
                and e.name().startswith("ccnet.")]
    with_spans = reduce(events, 2)
    monkeypatch.setattr(trace, "_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
    without = reduce(_profiled(work, device=cuda), 2)
    assert mirrored and not any(n.startswith("ccnet.") for n, *_ in with_spans.ops)
    assert sorted(n for n, *_ in with_spans.ops) == sorted(n for n, *_ in without.ops)
