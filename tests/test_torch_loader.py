"""The port's threaded loader, decoded-sample cache and device prefetch.

* ``DataLoader`` against ``ccnet_tpu.data.loader.DataLoader`` (both at
  ``process_index=0, process_count=1``): the same names, images and labels
  per batch for ``num_workers`` 1 and 4, shuffle on and off, ``drop_last``
  on and off, over two epochs; ``decode_ahead`` bounds the decodes
  submitted; a decode error is raised at ``next()``; an abandoned iteration
  stops its threads;
* ``CachedDataset`` against JAX's: hits by name, the ``max_items`` and
  ``max_bytes`` caps and the ``CCNET_TPU_CACHE_GB`` budget, one warning;
* ``device_prefetch`` on the CPU: the same batches in order, the
  producer's errors at ``next()``; ``HostToDevice`` on the CPU;
* ``Trainer.run`` (which prefetches) against the same two steps taken
  batch by batch without prefetch, on each augment backend;
* the evaluator raises a PNG writer's error at the end of its run;
* the CLIs pass ``--num-workers`` and ``--cache-decoded`` through.
"""

import logging
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ccnet_tpu.data.loader import CachedDataset as JaxCachedDataset
from ccnet_tpu.data.loader import DataLoader as JaxDataLoader
from ccnet_tpu.data.loader import SyntheticDataset as JaxSynthetic

from ccnet_tpu_torch.data import loader as L
from ccnet_tpu_torch.data import CachedDataset, DataLoader, SyntheticDataset, device_prefetch

THREADS = ("ccnet-loader-producer", "ccnet-prefetch-producer")


def _live(names=THREADS) -> list:
    return [t.name for t in threading.enumerate() if t.name in names and t.is_alive()]


def _wait_until(cond, seconds: float = 5.0) -> bool:
    end = time.monotonic() + seconds
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.01)
    return cond()


@pytest.fixture(autouse=True)
def no_threads_left():
    """Every test ends with its producer threads gone."""
    assert _wait_until(lambda: not _live()), _live()
    yield
    assert _wait_until(lambda: not _live()), f"threads left running: {_live()}"


@pytest.mark.parametrize("num_workers", [1, 4])
@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (True, False), (False, True),
                                               (False, False)])
def test_batches_match_jax_loader(num_workers, shuffle, drop_last):
    kw = dict(n=11, hw=(5, 7), num_classes=5, seed=3)
    common = dict(shuffle=shuffle, seed=9, num_workers=num_workers, drop_last=drop_last,
                  process_index=0, process_count=1)
    jl = JaxDataLoader(JaxSynthetic(**kw), 3, **common)
    tl = DataLoader(SyntheticDataset(**kw), 3, **common)
    assert len(tl) == len(jl)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        want, got = list(jl), list(tl)
        assert len(got) == len(want) == len(jl)
        for (gi, gl, gn), (wi, wl, wn) in zip(got, want):
            assert gn == wn
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
            assert gi.dtype == wi.dtype and gl.dtype == wl.dtype


def test_order_is_strided_by_process():
    kw = dict(n=13, hw=(2, 3), num_classes=3)
    for index in range(3):
        common = dict(shuffle=True, seed=4, num_workers=2, process_index=index,
                      process_count=3, drop_last=False)
        want = [n for _, _, b in JaxDataLoader(JaxSynthetic(**kw), 2, **common) for n in b]
        got = [n for _, _, b in DataLoader(SyntheticDataset(**kw), 2, **common) for n in b]
        assert got == want
    with pytest.raises(ValueError, match="process_index"):
        DataLoader(SyntheticDataset(**kw), 2, process_index=3, process_count=3)


class _Gated(SyntheticDataset):
    """Index 0 decodes only once ``gate`` is set; every call is recorded."""

    def __init__(self, n=12):
        super().__init__(n=n, hw=(2, 2), num_classes=3)
        self.gate, self.calls, self._lock = threading.Event(), [], threading.Lock()

    def __getitem__(self, index):
        with self._lock:
            self.calls.append(index)
        if index == 0:
            self.gate.wait(10)
        return super().__getitem__(index)


def test_decode_ahead_bounds_the_samples_in_flight():
    ds = _Gated()
    loader = DataLoader(ds, 2, shuffle=False, num_workers=8, decode_ahead=5)
    it = iter(loader)
    first = []
    t = threading.Thread(target=lambda: first.append(next(it)))
    t.start()
    # the producer waits on sample 0 with 5 decodes submitted, and no more
    assert _wait_until(lambda: len(ds.calls) == 5)
    time.sleep(0.2)
    assert sorted(ds.calls) == [0, 1, 2, 3, 4]
    ds.gate.set()
    t.join(10)
    rest = list(it)
    names = [n for _, _, b in first + rest for n in b]
    assert names == [ds.name(i) for i in range(12)]
    assert sorted(ds.calls) == list(range(12))
    assert DataLoader(ds, 3, prefetch=4).decode_ahead == 15  # (prefetch + 1) * batch


class _Broken(SyntheticDataset):
    def __getitem__(self, index):
        if index == 3:
            raise ValueError("cannot decode sample 3")
        return super().__getitem__(index)


@pytest.mark.parametrize("num_workers", [1, 4])
def test_decode_error_raised_at_next(num_workers):
    it = iter(DataLoader(_Broken(n=8, hw=(2, 2)), 2, shuffle=False, num_workers=num_workers))
    _, _, names = next(it)
    assert names == ["synthetic_00000", "synthetic_00001"]
    with pytest.raises(ValueError, match="cannot decode sample 3"):
        next(it)


def test_abandoned_iteration_stops_its_threads():
    loader = DataLoader(SyntheticDataset(n=64, hw=(8, 8)), 2, num_workers=4, prefetch=1)
    it = iter(loader)
    next(it)
    assert "ccnet-loader-producer" in _live()
    it.close()  # the consumer walks away with the queue full and decodes pending
    assert _wait_until(lambda: not _live())
    # the same through device_prefetch: both producers stop
    it = device_prefetch(iter(loader), lambda a, b: (a, b), depth=1)
    next(it)
    assert set(_live()) == set(THREADS)
    it.close()
    assert _wait_until(lambda: not _live())


class _Counting:
    """Samples whose names repeat: index i is file ``i % files``."""

    def __init__(self, n=9, files=3, size=100):
        self.n, self.files, self.size, self.decodes = n, files, size, 0

    def __len__(self):
        return self.n

    def name(self, index):
        return f"file_{index % self.files}"

    def __getitem__(self, index):
        self.decodes += 1
        f = index % self.files
        return (np.full(self.size, f, np.uint8), np.full(self.size, f, np.uint8), self.name(index))


@pytest.mark.parametrize("caps", [{}, {"max_items": 2}, {"max_bytes": 450},
                                  {"max_items": 1, "max_bytes": 10_000}, {"max_bytes": 0}])
def test_cached_dataset_matches_jax(caps, caplog):
    runs = []
    for cls in (JaxCachedDataset, CachedDataset):
        base = _Counting()
        ds = cls(base, **caps)
        assert len(ds) == 9 and ds.name(4) == "file_1"
        items = [ds[i] for i in list(range(9)) * 2]
        runs.append((base.decodes, sorted(ds._cache), ds._bytes, ds.max_bytes, items))
    (jd, jk, jb, jm, ji), (td, tk, tb, tm, ti) = runs
    assert (td, tk, tb, tm) == (jd, jk, jb, jm)
    for a, b in zip(ti, ji):
        assert a[2] == b[2] and np.array_equal(a[0], b[0])


def test_cached_dataset_hits_by_name_and_warns_once(caplog):
    base = _Counting(n=12, files=4)
    ds = CachedDataset(base, max_items=3)
    with caplog.at_level(logging.WARNING):
        L.logger.propagate = True  # let caplog see the port's logger
        try:
            for i in list(range(12)) * 2:
                ds[i]
        finally:
            L.logger.propagate = False
    # three files cached at their first access; file_3 decodes every time
    assert sorted(ds._cache) == ["file_0", "file_1", "file_2"]
    assert base.decodes == 3 + 6
    assert sum("cache full" in r.getMessage() for r in caplog.records) == 1


@pytest.mark.parametrize("caps", [{"max_items": 40}, {"max_bytes": 40 * 200}])
def test_cached_dataset_keeps_its_caps_under_racing_threads(caps):
    """More decode threads than cores, switching often, on 100 files read
    in a scrambled order: the cache's byte count equals what it holds, and
    neither cap is passed (a lost update would break one or the other)."""
    from concurrent.futures import ThreadPoolExecutor

    base = _Counting(n=600, files=100, size=100)
    ds = CachedDataset(base, **caps)
    order = np.random.RandomState(0).permutation(600)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=4 * (os.cpu_count() or 1) + 4) as ex:
            items = list(ex.map(ds.__getitem__, order, timeout=60))
    finally:
        sys.setswitchinterval(interval)
    assert [it[2] for it in items] == [base.name(i) for i in order]
    assert ds._bytes == sum(CachedDataset._item_bytes(v) for v in ds._cache.values())
    assert len(ds._cache) == 40 and ds._bytes <= ds.max_bytes


def test_cache_budget_from_the_environment(monkeypatch):
    monkeypatch.setenv("CCNET_TPU_CACHE_GB", "0.5")
    assert CachedDataset(_Counting()).max_bytes == JaxCachedDataset(_Counting()).max_bytes
    assert CachedDataset(_Counting()).max_bytes == 1 << 29
    monkeypatch.delenv("CCNET_TPU_CACHE_GB")
    assert CachedDataset(_Counting()).max_bytes == 8 << 30


def test_device_prefetch_yields_the_batches_in_order():
    loader = DataLoader(SyntheticDataset(n=10, hw=(3, 4)), 3, shuffle=True, seed=2,
                        num_workers=2, drop_last=False)
    want = list(loader)
    copier = L.HostToDevice("cpu")
    got = list(device_prefetch(iter(loader), lambda a, b: (copier(a, b),), depth=2))
    assert len(got) == len(want) == 4
    for (transfer, names), (wi, wl, wn) in zip(got, want):
        images, labels = transfer.wait()
        assert names == wn and isinstance(images, torch.Tensor)
        np.testing.assert_array_equal(images.numpy(), wi)
        np.testing.assert_array_equal(labels.numpy(), wl)


def test_device_prefetch_raises_the_producers_errors():
    def batches():
        yield np.zeros(2), np.zeros(2), ["a"]
        raise OSError("lost the disk")

    it = device_prefetch(batches(), lambda a, b: (a, b))
    assert next(it)[2] == ["a"]
    with pytest.raises(OSError, match="lost the disk"):
        next(it)

    def place(a, b):
        raise RuntimeError("copy refused")

    with pytest.raises(RuntimeError, match="copy refused"):
        next(device_prefetch(batches(), place))
    # an iterator that cannot even start
    with pytest.raises(TypeError):
        next(device_prefetch(42, place))


def test_host_to_device_on_the_cpu_views_the_arrays():
    a = np.arange(12, dtype=np.uint8).reshape(3, 4)
    b = np.arange(6, dtype=np.int32)[::2]  # not contiguous: copied once
    images, labels = L.HostToDevice("cpu")(a, b).wait()
    assert images.dtype == torch.uint8 and labels.tolist() == [0, 2, 4]
    a[0, 0] = 99
    assert images[0, 0] == 99  # a view, no copy


class _Crops:
    """Fixed-size crops for the ``host_u8`` and ``precropped`` backends."""

    def __init__(self, dtype, n=6, hw=(33, 33)):
        self.dtype, self.n, self.hw = dtype, n, hw

    def __len__(self):
        return self.n

    def name(self, index):
        return f"crop_{index}"

    def __getitem__(self, index):
        rng = np.random.RandomState(index)
        image = rng.randint(0, 256, (*self.hw, 3)).astype(self.dtype)
        label = rng.randint(0, 19, self.hw).astype(np.uint8)
        label[rng.rand(*self.hw) < 0.05] = 255
        return image, label, self.name(index)


@pytest.mark.parametrize("backend", ["device", "host_u8", "precropped"])
def test_trainer_losses_unchanged_by_prefetch(backend, tmp_path):
    """Two steps of ``Trainer.run`` (batches through ``device_prefetch``)
    equal two steps taken batch by batch from the same loader, placed and
    augmented in line, from the same init."""
    from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer

    dataset = {"device": SyntheticDataset(n=6, hw=(40, 48), num_classes=19),
               "host_u8": _Crops(np.uint8), "precropped": _Crops(np.float32)}[backend]
    cfg = dict(depth=50, input_size=(33, 33), batch_size=2, num_steps=2, ohem=True,
               ohem_keep=200, bf16=False, device="cpu", augment_backend=backend,
               save_every=100, export_pth=False, log_every=1)
    loader = DataLoader(dataset, 2, shuffle=True, seed=5, num_workers=2)
    trainer = Trainer(TrainConfig(snapshot_dir=str(tmp_path / "a"), **cfg))
    got = trainer.run(loader)["losses"]

    inline = Trainer(TrainConfig(snapshot_dir=str(tmp_path / "b"), **cfg))
    loader.set_epoch(0)
    want = []
    for step, (images, labels, _) in zip(range(2), loader):
        imgs, lbls = inline._augment(torch.from_numpy(images), torch.from_numpy(labels), step)
        want.append(float(inline.train_step(inline.state, imgs, lbls)["loss"]))
    assert len(got) == 2 and all(np.isfinite(got))
    assert got == want


def test_evaluator_raises_a_png_write_error_at_the_end(tmp_path, monkeypatch):
    from ccnet_tpu_torch.evaluation import evaluator as E

    written = []

    def failing_write(path, pred, palette):
        written.append(path)
        raise OSError("disk full")

    monkeypatch.setattr(E, "save_indexed_png", failing_write)
    ev = E.Evaluator(lambda x: torch.zeros(x.shape[0], 3, x.shape[2] // 8, x.shape[3] // 8),
                     num_classes=3, tile_hw=(16, 16), whole=True, device="cpu")
    loader = DataLoader(SyntheticDataset(n=3, hw=(16, 24), num_classes=3), 1, shuffle=False,
                        num_workers=2, drop_last=False)
    with pytest.raises(OSError, match="disk full"):
        ev.run(loader, output_dir=str(tmp_path), save_preds=True)
    assert len(written) == 3  # every batch was predicted and handed to the writer


class _Stop(Exception):
    pass


def _capture_loader(monkeypatch, module):
    seen = {}

    def fake(dataset, batch_size, **kw):
        seen.update(kw, dataset=dataset, batch_size=batch_size)
        raise _Stop

    monkeypatch.setattr(module, "DataLoader", fake)
    return seen


class _FakeCityscapes(SyntheticDataset):
    def __init__(self, data_dir, data_list, split="train", raw_dtype="float32"):
        super().__init__(n=4, hw=(40, 48))
        self.raw_dtype = raw_dtype


@pytest.mark.parametrize("cache", ["1", "0"])
@pytest.mark.parametrize("backend", ["host_u8", "device"])
def test_train_cli_passes_workers_and_cache(monkeypatch, cache, backend):
    from ccnet_tpu_torch.cli import train as cli

    seen = _capture_loader(monkeypatch, cli)
    monkeypatch.setattr(cli, "CityscapesDataset", _FakeCityscapes)
    with pytest.raises(_Stop):
        cli.main(["--device", "cpu", "--num-workers", "3", "--cache-decoded", cache,
                  "--augment-backend", backend, "--input-size", "33,33"])
    assert seen["num_workers"] == 3 and seen["shuffle"] is True
    ds = seen["dataset"]
    if backend == "host_u8":  # the cache holds raw samples, under the augmentation
        ds = ds.dataset
    assert isinstance(ds, CachedDataset) == (cache == "1")
    raw = ds.dataset if cache == "1" else ds
    assert isinstance(raw, _FakeCityscapes) and raw.raw_dtype == "uint8"


def test_train_cli_never_caches_the_synthetic_set(monkeypatch):
    from ccnet_tpu_torch.cli import train as cli

    seen = _capture_loader(monkeypatch, cli)
    with pytest.raises(_Stop):
        cli.main(["--device", "cpu", "--synthetic", "--num-workers", "5",
                  "--cache-decoded", "1"])
    assert seen["num_workers"] == 5 and type(seen["dataset"]) is SyntheticDataset


def test_evaluate_cli_passes_workers(monkeypatch):
    from ccnet_tpu_torch.cli import evaluate as cli

    seen = _capture_loader(monkeypatch, cli)
    monkeypatch.setattr(cli, "build_model", lambda *a, **k: None)
    with pytest.raises(_Stop):
        cli.main(["--device", "cpu", "--synthetic", "--num-workers", "6"])
    assert seen["num_workers"] == 6 and seen["shuffle"] is False and seen["drop_last"] is False
