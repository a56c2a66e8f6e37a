"""The port's native (C++/OpenMP) augmenter, ``ccnet_tpu_torch.native``.

Both packages build their library with g++ here. On the same draws the two
agree bit-exactly in f32 and uint8 (one source, the same flags); the port's
library matches the port's device sampler (labels equal, images within
1e-2, as ``tests/test_native_augment.py`` holds the JAX package's);
``U8CropDataset(engine="native")`` draws the geometry of ``engine="cv2"``
(labels equal, images within 2 of cv2's fixed-point uint8 rounding) and
equals the JAX package's dataset on both engines; ``draw_augment_params``
consumes the rng as the JAX package's does.
"""

import numpy as np
import pytest
import torch

from ccnet_tpu import native as jax_native
from ccnet_tpu.data import U8CropDataset as JaxU8CropDataset
from ccnet_tpu_torch import native
from ccnet_tpu_torch.data import U8CropDataset, trainid_lut
from ccnet_tpu_torch.data.loader import SyntheticDataset
from ccnet_tpu_torch.data.preprocess import CITYSCAPES_MEAN_BGR, augment_batch

IMAGE_TOL = 1e-2  # the native lerp against the torch sampler's, f32 on 0-255 pixels
CV2_U8_TOL = 2  # uint8 levels: the native float lerp against cv2's fixed point


@pytest.fixture(autouse=True)
def libraries():
    """Both libraries built (g++ at first use), else the test skips."""
    if not (native.available() and jax_native.available()):
        pytest.skip("no g++/OpenMP toolchain")


def _batch(seed, B=3, hw=(100, 120)):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, (B, *hw, 3)).astype(np.uint8)
    labels = rng.randint(0, 34, (B, *hw)).astype(np.uint8)
    return images, labels


@pytest.mark.parametrize("crop", [(96, 96), (160, 64)])
@pytest.mark.parametrize("seed", [0, 1])
def test_native_bit_equal_to_jax_library(crop, seed):
    images, labels = _batch(seed)
    draws = native.draw_augment_params(np.random.RandomState(seed), 3, (100, 120), crop)
    for lut in (np.arange(256, dtype=np.uint8), trainid_lut()):
        args = (images, labels, lut, *draws, crop, CITYSCAPES_MEAN_BGR, 255)
        for ours, theirs in ((native.augment_batch, jax_native.augment_batch),
                             (native.augment_batch_u8, jax_native.augment_batch_u8)):
            got, want = ours(*args), theirs(*args)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("f,flip", [(1.0, 0), (0.7, 1), (2.1, 0), (1.3, 1)])
def test_native_matches_device_sampler(f, flip):
    images, labels = _batch(2, B=1)
    H0, W0, crop = 100, 120, (96, 96)
    sH, sW = int(round(H0 * f)), int(round(W0 * f))
    oy, ox = min(3, max(sH, crop[0]) - crop[0]), min(5, max(sW, crop[1]) - crop[1])
    got_img, got_lbl = native.augment_batch(
        images, labels, np.arange(256, dtype=np.uint8), np.array([f], np.float32),
        np.array([[oy, ox]], np.int32), np.array([flip], np.uint8), crop, CITYSCAPES_MEAN_BGR)
    idx = torch.tensor([int(round((f - 0.7) / 0.1))])
    want_img, want_lbl = augment_batch(
        torch.from_numpy(images), torch.from_numpy(labels).long(), idx, torch.tensor([oy]),
        torch.tensor([ox]), torch.tensor([bool(flip)]), crop_hw=crop)
    np.testing.assert_array_equal(got_lbl, want_lbl.numpy())
    np.testing.assert_allclose(got_img, want_img.numpy(), atol=IMAGE_TOL, rtol=0)


def test_native_lut_and_padding():
    rng = np.random.RandomState(1)
    image = rng.randint(0, 256, (1, 40, 50, 3)).astype(np.uint8)
    label = np.full((1, 40, 50), 7, np.uint8)  # raw labelId 7 -> trainId 0
    img, lbl = native.augment_batch(image, label, trainid_lut(), np.array([1.0], np.float32),
                                    np.array([[0, 0]], np.int32), np.array([0], np.uint8),
                                    (64, 64), (0.0, 0.0, 0.0))
    assert (lbl[0, :40, :50] == 0).all() and (lbl[0, 40:] == 255).all()
    assert (img[0, 40:] == 0).all()
    img8, lbl8 = native.augment_batch_u8(image, label, trainid_lut(),
                                         np.array([1.0], np.float32), np.array([[0, 0]], np.int32),
                                         np.array([0], np.uint8), (64, 64), CITYSCAPES_MEAN_BGR)
    assert (img8[0, 40:] == np.round(CITYSCAPES_MEAN_BGR).astype(np.uint8)).all()
    assert (lbl8[0, :, 50:] == 255).all()


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("seed", [0, 7])
def test_draws_equal_jax(seed, mirror):
    kw = dict(scale_min=0.5, scale_steps=12, mirror=mirror)
    got = native.draw_augment_params(np.random.RandomState(seed), 64, (375, 500), (321, 321),
                                     **kw)
    want = jax_native.draw_augment_params(np.random.RandomState(seed), 64, (375, 500),
                                          (321, 321), **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    scales, offs, flips = got
    assert scales.min() >= 0.5 - 1e-6 and scales.max() <= 1.6 + 1e-6
    assert set(np.unique(flips)) <= ({0, 1} if mirror else {0})
    for s, (oy, ox) in zip(scales, offs):
        assert 0 <= oy <= max(int(round(375 * s)), 321) - 321
        assert 0 <= ox <= max(int(round(500 * s)), 321) - 321


class _RawU8(SyntheticDataset):
    def __getitem__(self, index):
        img, lbl, name = super().__getitem__(index)
        return img.astype(np.uint8), np.clip(lbl, 0, 19).astype(np.uint8), name


def test_u8_crop_dataset_native_engine_matches_cv2():
    pytest.importorskip("cv2")
    kw = dict(crop_hw=(64, 64), seed=11, scale_min=0.7, scale_steps=15)
    base = _RawU8(n=6, hw=(90, 130))
    sets = {(pkg, engine): cls(base, engine=engine, **kw)
            for pkg, cls in (("port", U8CropDataset), ("jax", JaxU8CropDataset))
            for engine in ("native", "cv2")}
    assert U8CropDataset(base, **kw).engine == "native"  # auto, with the library built
    for epoch in (0, 1):
        for ds in sets.values():
            ds.set_epoch(epoch)
        for i in range(len(base)):
            items = {k: ds[i] for k, ds in sets.items()}
            for engine in ("native", "cv2"):  # the port equals the JAX package
                for a, b in zip(items["port", engine][:2], items["jax", engine][:2]):
                    np.testing.assert_array_equal(a, b)
            img_n, lbl_n, _ = items["port", "native"]
            img_c, lbl_c, _ = items["port", "cv2"]
            assert img_n.dtype == lbl_n.dtype == np.uint8
            np.testing.assert_array_equal(lbl_n, lbl_c)
            diff = np.abs(img_n.astype(np.int32) - img_c.astype(np.int32))
            assert diff.max() <= CV2_U8_TOL, (i, epoch, diff.max())


def test_explicit_native_raises_when_the_library_does_not_build(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "g++: not found")
    assert not native.available()
    with pytest.raises(RuntimeError, match="g\\+\\+: not found"):
        U8CropDataset(_RawU8(n=1, hw=(40, 40)), crop_hw=(32, 32), engine="native")[0]
    assert U8CropDataset(_RawU8(n=1, hw=(40, 40)), crop_hw=(32, 32)).engine == "cv2"
    with pytest.raises(ValueError):
        U8CropDataset(_RawU8(n=1, hw=(40, 40)), engine="fast")
