"""Port's training path vs the JAX package's.

* five train steps of the tiny CCNet of ``tests/test_golden_dynamics.py``
  (7 classes, layers (1,1,1,1), 65², OHEM ``min_kept=500``, wd 5e-4, lr
  1e-2 over 50 steps, no dropout) in f32: the port starts from the JAX
  init through ``jax_variables_to_state_dict``, runs ``make_train_step``
  against JAX's, and the losses, BN running stats and parameters agree;
* ``augment_batch`` fed JAX's draws equals ``device_augment_batch``;
* the ``DataLoader`` order equals JAX's for a seed and epoch;
* ``load_pth(restore_last=False)`` / ``skip_mismatch`` and the full-state
  checkpoint round trip;
* a CLI smoke run on the CPU whose exported ``.pth`` loads into the JAX
  package with ``strict=True`` and gives the port's logits.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccnet_tpu.data.loader import DataLoader as JaxDataLoader
from ccnet_tpu.data.loader import SyntheticDataset as JaxSynthetic
from ccnet_tpu.data.preprocess import SCALE_STEP, device_augment_batch as jax_augment
from ccnet_tpu.losses import build_criterion as jax_criterion
from ccnet_tpu.models import CCNet as JaxCCNet
from ccnet_tpu.train import create_train_state as jax_state
from ccnet_tpu.train import make_optimizer as jax_optimizer
from ccnet_tpu.train import make_train_step as jax_step

from ccnet_tpu_torch.data import DataLoader, SyntheticDataset
from ccnet_tpu_torch.data.preprocess import augment_batch, device_augment_batch
from ccnet_tpu_torch.losses import build_criterion
from ccnet_tpu_torch.models import CCNet
from ccnet_tpu_torch.train import create_train_state, make_train_step
from ccnet_tpu_torch.utils import (
    jax_variables_to_state_dict,
    latest_checkpoint_step,
    load_pth,
    restore_checkpoint,
    save_checkpoint,
    save_pth,
)

from _torch_port import nchw, nhwc, to_numpy_tree

# the losses agree to this (f32, same init and data; the sums run in other orders)
LOSS_RTOL = 2e-4


@pytest.fixture(scope="module")
def golden_runs():
    """Five steps of the golden recipe in both packages, from one init."""
    jm = JaxCCNet(num_classes=7, layers=(1, 1, 1, 1), recurrence=2, impl="jnp", drop_rate=0.0)
    tx = jax_optimizer(base_lr=1e-2, max_steps=50, weight_decay=5e-4)
    state = jax_state(jm, tx, input_shape=(1, 65, 65, 3), rng=jax.random.PRNGKey(0))
    init = to_numpy_tree({"params": state.params, "batch_stats": state.batch_stats})
    rng = np.random.RandomState(1234)
    images = rng.randn(2, 65, 65, 3).astype(np.float32) * 30.0
    labels = rng.randint(0, 7, size=(2, 65, 65)).astype(np.int32)
    labels[rng.rand(2, 65, 65) < 0.1] = 255

    step = jax_step(jm, jax_criterion(ohem=True, min_kept=500), tx)
    jax_losses = []
    for _ in range(5):
        state, metrics = step(state, jnp.asarray(images), jnp.asarray(labels),
                              jax.random.PRNGKey(7))
        jax_losses.append(float(metrics["loss"]))
    final = to_numpy_tree({"params": state.params, "batch_stats": state.batch_stats})

    model = CCNet(num_classes=7, layers=(1, 1, 1, 1), recurrence=2, drop_rate=0.0)
    model.load_state_dict(jax_variables_to_state_dict(init), strict=True)
    tstate = create_train_state(model, base_lr=1e-2, max_steps=50, weight_decay=5e-4)
    tstep = make_train_step(build_criterion(ohem=True, min_kept=500))
    timages, tlabels = nchw(images), torch.from_numpy(labels)
    losses = [float(tstep(tstate, timages, tlabels)["loss"]) for _ in range(5)]
    return {"jax_losses": jax_losses, "losses": losses, "want": jax_variables_to_state_dict(final),
            "got": {k: v.detach() for k, v in model.state_dict().items()}, "state": tstate,
            "init": jax_variables_to_state_dict(init)}


def _off_by(runs, key) -> float:
    """max |port − JAX| after five steps, over the largest five-step change."""
    got, want, init = runs["got"][key], runs["want"][key], runs["init"][key]
    return float((got - want).abs().max() / (want - init).abs().max())


def test_five_train_steps_track_jax_losses(golden_runs):
    np.testing.assert_allclose(golden_runs["losses"], golden_runs["jax_losses"], rtol=LOSS_RTOL)
    assert golden_runs["losses"][-1] < golden_runs["losses"][0]
    assert golden_runs["state"].step == 5


# Tolerances are shares of what five steps changed. BN running stats and the
# heads' parameters agree to ~2e-3 of their change (held at 1e-2). The
# backbone's conv grads are ill-conditioned at this size (BN over 2 x 9 x 9
# samples at layer4): a float64 torch run puts BOTH packages' f32 grads of
# layer4.0.conv3 8-10 % away from it (a CPU check made when this test was
# written), so the backbone convs agree to that (held at 0.25).
@pytest.mark.parametrize("key", [
    "bn1.running_mean", "bn1.running_var", "layer3.0.bn2.running_var",
    "head.conva.1.running_mean", "head.bottleneck.1.running_var", "dsn.1.running_var"])
def test_bn_running_stats_match_jax_after_five_steps(golden_runs, key):
    assert _off_by(golden_runs, key) <= 1e-2


@pytest.mark.parametrize("key,share", [
    ("head.bottleneck.3.weight", 1e-2), ("head.bottleneck.1.weight", 1e-2),
    ("head.cca.query_conv.weight", 1e-2), ("dsn.3.weight", 1e-2), ("dsn.1.weight", 1e-2),
    ("conv1.weight", 0.25), ("layer4.0.conv2.weight", 0.25)])
def test_params_match_jax_after_five_steps(golden_runs, key, share):
    assert _off_by(golden_runs, key) <= share


def _jax_draws(key, B, hw, crop_hw, scale_min=0.7, scale_steps=15):
    """The (scale step, oy, ox, flip) draws device_augment_batch makes."""
    out = []
    for k in jax.random.split(key, B):
        k_scale, k_oy, k_ox, k_flip = jax.random.split(k, 4)
        s = jax.random.randint(k_scale, (), 0, scale_steps)
        f = scale_min + SCALE_STEP * s
        sh, sw = jnp.round(hw[0] * f).astype(jnp.int32), jnp.round(hw[1] * f).astype(jnp.int32)
        oy = jax.random.randint(k_oy, (), 0, jnp.maximum(sh, crop_hw[0]) - crop_hw[0] + 1)
        ox = jax.random.randint(k_ox, (), 0, jnp.maximum(sw, crop_hw[1]) - crop_hw[1] + 1)
        out.append((int(s), int(oy), int(ox), bool(jax.random.bernoulli(k_flip))))
    return [torch.tensor(c) for c in zip(*out)]


@pytest.mark.parametrize("crop", [(48, 48), (80, 112)])
def test_augment_batch_equals_jax_device_augment(crop):
    """Fed JAX's draws, the torch gather sampler gives JAX's crops: images
    to f32 rounding of the same lerps, labels exactly (crop (80, 112)
    exceeds the image at small scales, so the padding runs too)."""
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (4, 64, 96, 3)).astype(np.float32)
    labels = rng.randint(0, 19, (4, 64, 96)).astype(np.int32)
    key = jax.random.PRNGKey(11)
    want_i, want_l = jax_augment(jnp.asarray(images), jnp.asarray(labels), key, crop_hw=crop)
    draws = _jax_draws(key, 4, (64, 96), crop)
    got_i, got_l = augment_batch(torch.from_numpy(images), torch.from_numpy(labels), *draws,
                                 crop_hw=crop)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-3)
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(want_l))
    assert got_l.dtype == torch.int32


def test_device_augment_batch_is_seeded_by_seed_and_step():
    rng = np.random.RandomState(6)
    images = torch.from_numpy(rng.randint(0, 256, (2, 40, 56, 3)).astype(np.uint8))
    labels = torch.from_numpy(rng.randint(0, 19, (2, 40, 56)).astype(np.uint8))
    a = device_augment_batch(images, labels, seed=3, step=7, crop_hw=(33, 33))
    b = device_augment_batch(images, labels, seed=3, step=7, crop_hw=(33, 33))
    c = device_augment_batch(images, labels, seed=3, step=8, crop_hw=(33, 33))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert not torch.equal(a[0], c[0])
    assert a[0].shape == (2, 33, 33, 3) and a[1].dtype == torch.int32


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_dataloader_order_matches_jax(shuffle, drop_last):
    kw = dict(n=11, hw=(4, 6), num_classes=5)
    jl = JaxDataLoader(JaxSynthetic(**kw), 3, shuffle=shuffle, seed=9, num_workers=1,
                       drop_last=drop_last, process_index=0, process_count=1)
    tl = DataLoader(SyntheticDataset(**kw), 3, shuffle=shuffle, seed=9, drop_last=drop_last)
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        tl.set_epoch(epoch)
        want = [names for _, _, names in jl]
        got = [names for _, _, names in tl]
        assert got == want and len(tl) == len(jl)


def _tiny(num_classes, seed):
    torch.manual_seed(seed)
    return CCNet(num_classes=num_classes, layers=(1, 1, 1, 1), recurrence=2, drop_rate=0.0)


def test_load_pth_restore_last_and_skip_mismatch(tmp_path):
    path = str(tmp_path / "a.pth")
    src = _tiny(7, seed=1)
    save_pth(src, path)
    dst = _tiny(7, seed=2)
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    missing, unexpected = load_pth(path, dst, restore_last=False)
    assert not unexpected
    assert sorted(missing) == sorted(k for k in before if k.startswith(("head.bottleneck.3.",
                                                                          "dsn.3.")))
    for k, v in dst.state_dict().items():
        want = before[k] if k in missing else src.state_dict()[k]
        assert torch.equal(v, want), k
    # a classifier of another class count: refused unless skipped
    other = _tiny(5, seed=3)
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pth(path, other)
    cls = other.head.bottleneck[3].weight.clone()
    missing, _ = load_pth(path, other, skip_mismatch=True)
    assert "head.bottleneck.3.weight" in missing and torch.equal(other.head.bottleneck[3].weight,
                                                                  cls)
    assert torch.equal(other.conv1.weight, src.conv1.weight)


def test_full_state_checkpoint_round_trip(tmp_path):
    model = _tiny(5, seed=4)
    state = create_train_state(model, base_lr=1e-2, max_steps=10)
    step = make_train_step(build_criterion(), seed=1)
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 33, 33).astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 5, (2, 33, 33)).astype(np.int32))
    step(state, x, y)
    save_checkpoint(str(tmp_path), state, 1)
    assert latest_checkpoint_step(str(tmp_path)) == 1
    want = float(step(state, x, y)["loss"])
    fresh = create_train_state(_tiny(5, seed=9), base_lr=1e-2, max_steps=10)
    restore_checkpoint(str(tmp_path), fresh)
    assert fresh.step == 1
    assert float(step(fresh, x, y)["loss"]) == pytest.approx(want, rel=1e-6)


def test_cli_train_smoke_exports_a_pth_jax_loads(tmp_path):
    """``cli.train.main`` on the CPU at R50, 65² crops, 2 steps of OHEM: the
    exported CS_scenes_2.pth loads into the JAX package with strict=True
    and its logits equal the port's (f32, eval mode, atol 2e-4 x scale)."""
    from ccnet_tpu.utils import load_pth as jax_load_pth
    from ccnet_tpu_torch.cli.train import main
    from ccnet_tpu_torch.models import build_model

    snap = str(tmp_path / "snap")
    result = main(["--device", "cpu", "--synthetic", "--depth", "50", "--fp32", "1",
                   "--batch-size", "2", "--input-size", "65,65", "--synthetic-size", "96,128",
                   "--num-steps", "2", "--ohem", "1", "--ohem-keep", "500",
                   "--save-pred-every", "2", "--snapshot-dir", snap])
    assert result["final_step"] == 2 and np.isfinite(result["final_loss"])
    assert len(result["step_seconds"]) == 2
    pth = os.path.join(snap, "CS_scenes_2.pth")
    model = build_model("ccnet", depth=50)
    load_pth(pth, model, strict=True)

    jm = JaxCCNet(num_classes=19, layers=(3, 4, 6, 3), recurrence=2, impl="jnp")
    x = np.random.RandomState(0).randn(1, 65, 65, 3).astype(np.float32) * 50
    template = jax.jit(lambda a: jm.init(jax.random.PRNGKey(0), a))(jnp.asarray(x))
    variables, missing, unexpected = jax_load_pth(pth, template, strict=True)
    assert not missing and not unexpected
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a)["main"])(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(model(nchw(x))["main"])
    assert np.abs(got - want).max() <= 2e-4 * max(1.0, np.abs(want).max())
