"""The port's VOC path against the JAX package's, on the CPU.

* ``VOCDataset`` reads the same arrays (cv2 decodes the files in both);
* the port's numpy resizes against ``cv2.resize(fx=f, fy=f)`` at each of
  the 12 VOC scales over image sides 1–600 (every side where ``n·f`` lands
  on a half included): output shapes equal, nearest bit-exact, bilinear
  within 1e-3 on 0–255 images;
* ``host_augment`` (numpy resizes) against the JAX one (cv2): labels equal,
  images within 1e-3, over seeds, scales and sizes below and above the crop;
* ``AugmentingDataset`` items equal the JAX package's over two epochs;
* ``cli.evaluate --dataset voc`` of both packages on a 2-image tree with the
  same ``.pth``: equal confusion matrices and the same 21 class names.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from ccnet_tpu.data.loader import AugmentingDataset as JaxAugmentingDataset  # noqa: E402
from ccnet_tpu.data.preprocess import host_augment as jax_host_augment  # noqa: E402
from ccnet_tpu.data.voc import VOCDataset as JaxVOCDataset  # noqa: E402
from ccnet_tpu_torch.data import AugmentingDataset, VOCDataset, host_augment  # noqa: E402
from ccnet_tpu_torch.data.preprocess import resize_linear, resize_nearest  # noqa: E402
from _torch_port import torch_threads  # noqa: E402
from ccnet_tpu_torch.data.voc import (  # noqa: E402
    VOC_CLASS_NAMES,
    VOC_MEAN,
    VOC_SCALE_MIN,
    VOC_SCALE_STEPS,
)

VOC_SCALES = [VOC_SCALE_MIN + 0.1 * i for i in range(VOC_SCALE_STEPS)]
RESIZE_TOL = 1e-3  # bilinear, on 0-255 f32 images (the two sum in another order)
AUG_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with torch_threads(2):
        yield


def make_voc_tree(root, names_sizes, seed=0):
    (root / "JPEGImages").mkdir(parents=True)
    (root / "SegmentationClassAug").mkdir()
    rng = np.random.RandomState(seed)
    for name, (h, w) in names_sizes:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        assert cv2.imwrite(str(root / "JPEGImages" / f"{name}.jpg"), img)
        lab = rng.randint(0, 21, (h, w)).astype(np.uint8)
        lab[rng.rand(h, w) < 0.05] = 255
        assert cv2.imwrite(str(root / "SegmentationClassAug" / f"{name}.png"), lab)
    lst = root / "ids.txt"
    lst.write_text("\n".join(n for n, _ in names_sizes) + "\n")
    return str(root), str(lst)


NAMES_SIZES = [("2007_000001", (65, 81)), ("2007_000002", (73, 65))]


@pytest.mark.parametrize("raw_dtype", ["float32", "uint8"])
@pytest.mark.parametrize("with_labels", [True, False])
def test_voc_dataset_equals_jax(tmp_path, raw_dtype, with_labels):
    root, lst = make_voc_tree(tmp_path / "voc", NAMES_SIZES)
    kw = dict(with_labels=with_labels, raw_dtype=raw_dtype, max_iters=5)
    got, want = VOCDataset(root, lst, **kw), JaxVOCDataset(root, lst, **kw)
    assert len(got) == len(want) == 6
    for i in range(len(got)):
        for a, b in zip(got[i], want[i]):
            if isinstance(b, str):
                assert a == b == got.name(i)
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("f", VOC_SCALES, ids=[f"{f:.1f}" for f in VOC_SCALES])
def test_resize_matches_cv2(f):
    rng = np.random.RandomState(int(round(f * 10)))
    others = (1, 2, 3, 5, 9, 17)
    worst = 0.0
    for n in range(1, 601):
        m = others[n % len(others)]
        for hw in ((n, m), (m, n)):
            if round(hw[0] * f) < 1 or round(hw[1] * f) < 1:
                continue  # cv2 refuses an empty output
            img = (rng.rand(*hw, 3) * 255).astype(np.float32)
            lab = rng.randint(0, 256, hw).astype(np.uint8)
            want = cv2.resize(img, None, fx=f, fy=f, interpolation=cv2.INTER_LINEAR)
            got = resize_linear(img, f)
            assert got.shape == want.reshape(got.shape[:2] + (-1,)).shape == \
                (round(hw[0] * f), round(hw[1] * f), 3), (hw, f)
            worst = max(worst, float(np.abs(got - want.reshape(got.shape)).max()))
            want_lab = cv2.resize(lab, None, fx=f, fy=f, interpolation=cv2.INTER_NEAREST)
            np.testing.assert_array_equal(resize_nearest(lab, f), want_lab, err_msg=f"{hw} {f}")
    assert worst <= RESIZE_TOL, worst


def _raw(seed, hw):
    rng = np.random.RandomState(seed)
    image = rng.randint(0, 256, (*hw, 3)).astype(np.float32)
    label = rng.randint(0, 21, hw).astype(np.int32)
    label[rng.rand(*hw) < 0.05] = 255
    return image, label


def _check_augment(image, label, seed, crop, **kw):
    got = host_augment(image, label, np.random.RandomState(seed), crop_hw=crop, mean=VOC_MEAN,
                       **kw)
    want = jax_host_augment(image, label, np.random.RandomState(seed), crop_hw=crop,
                            mean=VOC_MEAN, **kw)
    assert got[0].shape == want[0].shape == (*crop, 3) and got[0].dtype == want[0].dtype
    assert got[1].dtype == want[1].dtype
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], atol=AUG_TOL, rtol=0)


@pytest.mark.parametrize("hw", [(40, 57), (97, 101), (333, 500)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_host_augment_equals_jax_random_draws(hw, seed):
    image, label = _raw(seed, hw)
    for k in range(4):  # four draws of the VOC recipe (scale, crop, mirror) per image
        _check_augment(image, label, seed * 10 + k, (101, 101), scale_min=VOC_SCALE_MIN,
                       scale_steps=VOC_SCALE_STEPS)


@pytest.mark.parametrize("f", VOC_SCALES, ids=[f"{f:.1f}" for f in VOC_SCALES])
def test_host_augment_equals_jax_each_scale(f):
    for i, hw in enumerate([(41, 63), (281, 283), (120, 90)]):
        image, label = _raw(i, hw)
        _check_augment(image, label, i, (97, 97), scale_min=f, scale_steps=1)


def test_host_augment_without_scale_or_mirror_equals_jax():
    image, label = _raw(5, (90, 130))
    _check_augment(image, label, 5, (101, 101), scale=False, mirror=False)


def test_host_augment_imports_no_cv2():
    import subprocess
    import sys

    code = ("import sys; sys.modules['cv2'] = None; import numpy as np; "
            "from ccnet_tpu_torch.data import AugmentingDataset; "
            "from ccnet_tpu_torch.data.preprocess import host_augment; "
            "x = host_augment(np.zeros((30, 40, 3), np.float32), np.zeros((30, 40), np.int32), "
            "np.random.RandomState(0), crop_hw=(33, 33)); print(x[0].shape)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and "(33, 33, 3)" in out.stdout, out.stderr


class _Raw:
    def __init__(self, sizes):
        self.items = [(*_raw(i, hw), f"voc_{i}") for i, hw in enumerate(sizes)]

    def __len__(self):
        return len(self.items)

    def name(self, i):
        return self.items[i][2]

    def __getitem__(self, i):
        return self.items[i]


def test_augmenting_dataset_equals_jax_over_epochs():
    raw = _Raw([(60, 75), (150, 110), (97, 97)])
    kw = dict(crop_hw=(81, 81), mean=VOC_MEAN, scale_min=VOC_SCALE_MIN,
              scale_steps=VOC_SCALE_STEPS, seed=304)
    got, want = AugmentingDataset(raw, **kw), JaxAugmentingDataset(raw, **kw)
    assert len(got) == len(want)
    seen = []
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        for i in range(len(raw)):
            g, w = got[i], want[i]
            assert g[2] == w[2] == raw.name(i)
            np.testing.assert_array_equal(g[1], w[1])
            np.testing.assert_allclose(g[0], w[0], atol=AUG_TOL, rtol=0)
            seen.append(g[1])
    assert any((a != b).any() for a, b in zip(seen[:3], seen[3:]))  # epochs re-draw


def test_evaluate_cli_voc_equals_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from ccnet_tpu.cli.evaluate import main as jax_main
    from ccnet_tpu.models import build_model as jax_build_model
    from ccnet_tpu.utils import save_pth
    from ccnet_tpu_torch.cli.evaluate import main

    root, lst = make_voc_tree(tmp_path / "voc", NAMES_SIZES, seed=3)
    model = jax_build_model("ccnet", num_classes=21, depth=50, dtype=jnp.float32)
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 65, 65, 3)),
                                           train=False))()
    pth = str(tmp_path / "voc.pth")
    save_pth(variables, pth)
    flags = ["--dataset", "voc", "--data-dir", root, "--data-list", lst, "--depth", "50",
             "--fp32", "1", "--bucket", "32", "--whole", "1", "--restore-from", pth,
             "--batch-size", "2"]
    want = jax_main(flags + ["--output-dir", str(tmp_path / "jax")])
    got = main(flags + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    assert np.asarray(got["confusion"]).shape == (21, 21)
    np.testing.assert_array_equal(np.asarray(got["confusion"]), np.asarray(want["confusion"]))
    assert list(got["per_class"]) == list(want["per_class"]) == list(VOC_CLASS_NAMES)
    for name, _ in NAMES_SIZES:  # VOC colormap PNGs, as the JAX CLI writes them
        from PIL import Image

        a, b = (Image.open(tmp_path / d / f"{name}.png") for d in ("port", "jax"))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert a.getpalette() == b.getpalette()
