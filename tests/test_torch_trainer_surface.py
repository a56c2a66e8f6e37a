"""The trainer's surface beyond the main recipe, on the CPU.

* ``remat`` (``blocks``, ``conv12``, ``convs`` and a tuple of layers): the
  train step's loss and grads equal those without remat (the recompute runs
  the same f32 operations, so they are held to ``REMAT_RTOL``), the string
  modes recompute only the convolutions they do not keep, and BN's running
  stats after one remat step equal those after one plain step;
* ``profile_steps`` writes a chrome trace, ``tensorboard`` an event file;
* ``cli.evaluate --restore-dir`` on ``cli.train``'s snapshots gives the
  confusion matrix of ``--restore-from`` the ``.pth`` of the same step;
* ``cli.train --augment-backend native`` and ``cli.train --dataset voc``;
* ``space``: in one process ``TrainConfig(space=2)`` takes the ``space=1``
  steps (JAX's one-device mesh is ``None``), and a ``space`` that does not
  divide the ranks raises (over two ranks: ``tests/test_torch_space.py``).
"""

import json
import os

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import ccnet_tpu_torch.models.registry as registry
from ccnet_tpu_torch import native
from ccnet_tpu_torch.data import SyntheticDataset
from ccnet_tpu_torch.losses import build_criterion
from ccnet_tpu_torch.models import build_model
from ccnet_tpu_torch.models.backbone import remat_plan
from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer

from _torch_port import torch_threads

REMAT_RTOL = 1e-6  # x max |grad|: the same CPU operations, recomputed
LAYERS = (1, 1, 2, 2)  # layers 3 and 4 hold a block with and one without a downsample
MODES = [False, True, "conv12", "convs", (2, 3)]


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with torch_threads(2):
        yield


@pytest.fixture
def small_depth(monkeypatch):
    """``depth=50`` builds LAYERS (the CLIs take only 50, 101 and 152)."""
    monkeypatch.setitem(registry._DEPTH_LAYERS, 50, LAYERS)


def _batch(seed=0, batch=2, hw=(65, 65), classes=5):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy((rng.rand(batch, 3, *hw) * 255 - 120).astype(np.float32))
    y = rng.randint(0, classes, (batch, *hw)).astype(np.int32)
    y[rng.rand(batch, *hw) < 0.1] = 255
    return x, torch.from_numpy(y)


class _ConvCount(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func is torch.ops.aten.convolution.default
        return func(*args, **(kwargs or {}))


def _one_step(remat, x, y):
    """One OHEM step of the LAYERS CCNet: ``(loss, grads, BN buffers, the
    convolutions the backward ran)``."""
    model = build_model("ccnet", num_classes=5, depth=50, remat=remat, drop_rate=0.0).train()
    out = model(x)
    loss = build_criterion(ohem=True, min_kept=500)(out, y)
    with _ConvCount() as counter:
        loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers()}
    return loss.item(), grads, stats, counter.n


@pytest.fixture(scope="module")
def remat_step():
    """``remat_step(mode)``: :func:`_one_step` of ``mode`` on one batch, once
    per mode for the module."""
    runs = {}

    def get(remat):
        if str(remat) not in runs:
            saved, registry._DEPTH_LAYERS[50] = registry._DEPTH_LAYERS[50], LAYERS
            try:
                runs[str(remat)] = _one_step(remat, *_batch())
            finally:
                registry._DEPTH_LAYERS[50] = saved
        return runs[str(remat)]

    return get


@pytest.mark.parametrize("remat", MODES[1:], ids=str)
def test_remat_grads_and_bn_stats_equal_plain(remat_step, remat):
    loss, grads, stats, _ = remat_step(remat)
    want_loss, want_grads, want_stats, _ = remat_step(False)
    assert loss == pytest.approx(want_loss, rel=REMAT_RTOL)
    for name, g in grads.items():
        want = want_grads[name]
        assert (g - want).abs().max() <= REMAT_RTOL * max(want.abs().max().item(), 1e-30), name
    for name, s in stats.items():  # the recompute leaves the running stats alone
        np.testing.assert_array_equal(s.numpy(), want_stats[name].numpy(), err_msg=name)


@pytest.mark.parametrize("remat,recomputed", [(False, 0), (True, 14), ("conv12", 6),
                                              ("convs", 2)], ids=str)
def test_remat_recomputes_only_what_it_does_not_keep(remat_step, remat, recomputed):
    """Layers 3-4 hold 4 blocks, 2 with a downsample: 14 convolutions. The
    backward reruns all of them (True: whole blocks), conv3 and the shortcut
    (conv12: 4 + 2) or the shortcut alone (convs)."""
    assert remat_step(remat)[3] == recomputed


def test_remat_plan_modes():
    assert remat_plan(False) == (frozenset(), None)
    assert remat_plan(True) == (frozenset({3, 4}), None)
    assert remat_plan("conv12") == (frozenset({3, 4}), 2)
    assert remat_plan("convs") == (frozenset({3, 4}), 3)
    assert remat_plan((1, 4)) == (frozenset({1, 4}), None)
    for mode in ("blocks", "everything"):  # the CLI maps --remat blocks to True
        with pytest.raises(ValueError):
            remat_plan(mode)


def test_remat_trainer_bn_stats_equal_plain_trainer(small_depth, tmp_path):
    """One Trainer step with remat="blocks" and one without, from the same
    seed: equal loss and BN running stats."""
    ds = SyntheticDataset(n=2, hw=(40, 50), num_classes=5)
    from ccnet_tpu_torch.data import DataLoader

    runs = {}
    for remat in (False, True):
        cfg = TrainConfig(num_classes=5, depth=50, input_size=(33, 33), batch_size=2,
                          num_steps=1, bf16=False, remat=remat, device="cpu", export_pth=False,
                          snapshot_dir=str(tmp_path / str(remat)))
        trainer = Trainer(cfg)
        result = trainer.run(DataLoader(ds, 2, shuffle=False, num_workers=1))
        runs[remat] = (result["losses"], {n: b.clone() for n, b in
                                          trainer.state.model.named_buffers()})
    assert runs[True][0] == pytest.approx(runs[False][0], rel=REMAT_RTOL)
    for name, s in runs[True][1].items():
        np.testing.assert_array_equal(s.numpy(), runs[False][1][name].numpy(), err_msg=name)


@pytest.mark.parametrize("bf16", [False, True])
def test_f32_trainer_turns_tf32_off(small_depth, tmp_path, monkeypatch, bf16):
    """f32 training is f32 products: the Trainer turns TF32 off in cuBLAS
    and cuDNN (the reference implementations' numerics); bf16 training
    leaves both settings as they were."""
    for flags in (torch.backends.cuda.matmul, torch.backends.cudnn):
        monkeypatch.setattr(flags, "allow_tf32", True)
    Trainer(TrainConfig(num_classes=5, depth=50, input_size=(33, 33), batch_size=2,
                        num_steps=1, bf16=bf16, device="cpu", export_pth=False,
                        snapshot_dir=str(tmp_path)))
    assert torch.backends.cuda.matmul.allow_tf32 is bf16
    assert torch.backends.cudnn.allow_tf32 is bf16


def _train(tmp_path, *flags, dataset=None):
    from ccnet_tpu_torch.cli.train import main

    return main(["--device", "cpu", "--depth", "50", "--fp32", "1", "--input-size", "33,33",
                 "--batch-size", "2", "--num-classes", "5", "--num-workers", "2",
                 "--snapshot-dir", str(tmp_path / "snap"), *flags], dataset=dataset)


def test_profile_steps_write_a_trace(small_depth, tmp_path):
    result = _train(tmp_path, "--synthetic", "--synthetic-size", "40,50", "--num-steps", "3",
                    "--save-pred-every", "3", "--profile-steps", "1,2")
    assert result["final_step"] == 3
    traces = os.listdir(tmp_path / "snap" / "profile")
    assert traces == ["trace_1_2.json"]
    events = json.load(open(tmp_path / "snap" / "profile" / traces[0]))["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("convolution" in n for n in names)  # the traced step's operators


def _scalars(tb_dir) -> dict:
    """{tag: [steps]} of the scalar summaries in ``tb_dir``'s event files
    (TFRecord framing: length, its CRC, the record, its CRC)."""
    import struct

    from tensorboard.compat.proto import event_pb2

    tags = {}
    for f in sorted(os.listdir(tb_dir)):
        data, pos = open(os.path.join(tb_dir, f), "rb").read(), 0
        while pos < len(data):
            (n,) = struct.unpack("<Q", data[pos:pos + 8])
            event = event_pb2.Event.FromString(data[pos + 12:pos + 12 + n])
            pos += 16 + n
            for v in event.summary.value:
                tags.setdefault(v.tag, []).append(event.step)
    return tags


def test_tensorboard_writes_an_event_file(small_depth, tmp_path, monkeypatch):
    import sys

    pytest.importorskip("tensorboard")
    if "tensorflow" not in sys.modules:  # torch's writer needs none; its import takes seconds
        monkeypatch.setitem(sys.modules, "tensorflow", None)
    _train(tmp_path, "--synthetic", "--synthetic-size", "40,50", "--num-steps", "1",
           "--save-pred-every", "1", "--tensorboard", "1")
    files = os.listdir(tmp_path / "snap" / "tb")
    assert any(f.startswith("events.out.tfevents") for f in files)
    assert _scalars(tmp_path / "snap" / "tb") == {"train/loss": [1], "train/lr": [1],
                                                  "train/img_per_s": [1]}


def test_tensorboard_unavailable_warns_and_trains(small_depth, tmp_path, monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    result = _train(tmp_path, "--synthetic", "--synthetic-size", "40,50", "--num-steps", "1",
                    "--save-pred-every", "1", "--tensorboard", "1")
    assert result["final_step"] == 1
    assert not os.path.exists(tmp_path / "snap" / "tb")


def test_restore_dir_equals_restore_from(small_depth, tmp_path):
    from ccnet_tpu_torch.cli.evaluate import main as evaluate

    _train(tmp_path, "--synthetic", "--synthetic-size", "40,50", "--num-steps", "2",
           "--save-pred-every", "2")
    common = ["--device", "cpu", "--depth", "50", "--fp32", "1", "--input-size", "33,33",
              "--num-classes", "5", "--synthetic", "--synthetic-size", "40,50",
              "--save-preds", "0"]
    by_dir = evaluate(common + ["--restore-dir", str(tmp_path / "snap"),
                                "--output-dir", str(tmp_path / "a")])
    by_pth = evaluate(common + ["--restore-from", str(tmp_path / "snap" / "CS_scenes_2.pth"),
                                "--output-dir", str(tmp_path / "b")])
    np.testing.assert_array_equal(np.asarray(by_dir["confusion"]),
                                  np.asarray(by_pth["confusion"]))
    assert np.asarray(by_dir["confusion"]).sum() > 0


def test_cli_train_native_backend(small_depth, tmp_path):
    if not native.available():
        pytest.skip("no g++/OpenMP toolchain")
    result = _train(tmp_path, "--synthetic", "--synthetic-size", "40,50", "--num-steps", "2",
                    "--save-pred-every", "2", "--augment-backend", "native")
    assert result["final_step"] == 2 and all(np.isfinite(result["losses"]))


def test_native_backend_crops_equal_the_library_with_jax_draws(small_depth, tmp_path):
    """The trainer's native batch of step s: the library's crops of the JAX
    package's draws from ``RandomState(seed + s * 1009)``."""
    if not native.available():
        pytest.skip("no g++/OpenMP toolchain")
    import itertools

    cfg = TrainConfig(num_classes=5, depth=50, input_size=(33, 33), batch_size=2, num_steps=1,
                      bf16=False, augment_backend="native", device="cpu", seed=9,
                      snapshot_dir=str(tmp_path))
    trainer = Trainer(cfg)
    ds = SyntheticDataset(n=2, hw=(40, 50), num_classes=5)
    images = np.stack([ds[i][0] for i in range(2)])
    labels = np.stack([ds[i][1] for i in range(2)])
    (transfer,) = trainer._native_crops(images, labels, itertools.count(3))
    got = transfer.wait()
    draws = native.draw_augment_params(np.random.RandomState(9 + 3 * 1009), 2, (40, 50),
                                       (33, 33))
    want = native.augment_batch(images.astype(np.uint8), labels.astype(np.uint8),
                                np.arange(256, dtype=np.uint8), *draws, (33, 33), cfg.mean, 255)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


def test_cli_train_voc(small_depth, tmp_path):
    """``--dataset voc`` on a raw in-memory set of variable-size samples
    (the wiring the files take), then the exported ``.pth`` loads."""
    from ccnet_tpu_torch.utils import load_pth

    class Raw:
        sizes = [(60, 75), (90, 70), (81, 81)]

        def __len__(self):
            return len(self.sizes)

        def name(self, i):
            return f"voc_{i}"

        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            hw = self.sizes[i]
            return (rng.randint(0, 256, (*hw, 3)).astype(np.float32),
                    rng.randint(0, 5, hw).astype(np.int32), self.name(i))

    result = _train(tmp_path, "--dataset", "voc", "--num-steps", "2", "--save-pred-every", "2",
                    "--learning-rate", "5e-3", dataset=Raw())
    assert result["final_step"] == 2 and all(np.isfinite(result["losses"]))
    model = build_model("ccnet", num_classes=5, depth=50)
    load_pth(str(tmp_path / "snap" / "CS_scenes_2.pth"), model, strict=True)


def test_space_still_raises(monkeypatch):
    """A ``space`` that does not divide the ranks raises, as ``make_mesh``
    does (three ranks, as ``world()`` reports them)."""
    import ccnet_tpu_torch.parallel.mesh as mesh
    import ccnet_tpu_torch.train.trainer as trainer

    for module in (mesh, trainer):
        monkeypatch.setattr(module, "world", lambda: (0, 3))
    with pytest.raises(ValueError, match="space=2"):
        Trainer(TrainConfig(space=2, device="cpu", batch_size=3))


def test_space_in_one_process_takes_the_space_1_steps(small_depth, tmp_path):
    from ccnet_tpu_torch.data import DataLoader

    results = []
    for space in (1, 2):
        trainer = Trainer(TrainConfig(space=space, device="cpu", depth=50, num_classes=5,
                                      input_size=(33, 33), batch_size=2, num_steps=2,
                                      save_every=100, bf16=False, export_pth=False,
                                      snapshot_dir=str(tmp_path / f"snap{space}")))
        result = trainer.run(DataLoader(SyntheticDataset(n=4, hw=(40, 50), num_classes=5), 2,
                                        num_workers=1))
        results.append((result["losses"], trainer.state.model.state_dict()))
    assert results[0][0] == results[1][0]
    for key, value in results[0][1].items():
        assert torch.equal(value, results[1][1][key]), key
