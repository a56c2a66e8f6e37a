"""The port's test-set prediction CLI (``ccnet_tpu_torch.cli.predict``) and
visualization helpers against the JAX package's, on the CPU.

Both CLIs predict 2 fake Cityscapes test images with the same tiny ``.pth``
(layers (1, 1, 1, 1), f32): the labelId PNGs (the port writes greyscale
PNGs with zlib, the JAX package with PIL) and the palette PNGs of
``--labelid 0``, decoded with PIL, are equal; so are ``decode_labels``,
``decode_predictions`` and ``inv_preprocess``.
"""

import os

import numpy as np
import pytest
from PIL import Image

cv2 = pytest.importorskip("cv2")

import ccnet_tpu.models.registry as jax_registry  # noqa: E402
import ccnet_tpu_torch.models.registry as registry  # noqa: E402
from _torch_port import TINY_LAYERS, randomized_variables, torch_threads  # noqa: E402
from ccnet_tpu.cli.predict import main as jax_main  # noqa: E402
from ccnet_tpu.utils import visualization as jax_vis  # noqa: E402
from ccnet_tpu_torch.cli.predict import main  # noqa: E402
from ccnet_tpu_torch.utils import visualization as vis  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _threads():
    with torch_threads(2):
        yield


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """2 test images of the Cityscapes layout, and a tiny CCNet ``.pth``
    (randomised weights, CCA gamma 0.5) written by the JAX package."""
    import jax.numpy as jnp

    from ccnet_tpu.models import CCNet as JaxCCNet
    from ccnet_tpu.utils import save_pth

    root = tmp_path_factory.mktemp("predict")
    img_dir = root / "leftImg8bit" / "test" / "faketown"
    os.makedirs(img_dir)
    rng = np.random.RandomState(0)
    for i, hw in enumerate([(97, 129), (97, 129)]):  # one shape: one JAX compile
        assert cv2.imwrite(str(img_dir / f"faketown_{i:06d}_000019_leftImg8bit.png"),
                           rng.randint(0, 256, (*hw, 3)).astype(np.uint8))
    model = JaxCCNet(num_classes=19, layers=TINY_LAYERS, recurrence=2, drop_rate=0.0)
    variables = randomized_variables(model, jnp.zeros((1, 65, 65, 3), jnp.float32), seed=4)
    save_pth(variables, str(root / "tiny.pth"))
    return root


@pytest.fixture
def tiny_depth(monkeypatch):
    """``--depth 50`` builds the tiny layers in both packages."""
    monkeypatch.setitem(jax_registry._DEPTH_LAYERS, 50, TINY_LAYERS)
    monkeypatch.setitem(registry._DEPTH_LAYERS, 50, TINY_LAYERS)


MODES = {
    "sliding-labelid": [],
    "sliding-palette": ["--labelid", "0"],
    "whole-msflip-labelid": ["--whole", "1", "--scales", "0.75,1.0", "--flip", "1"],
}


@pytest.mark.parametrize("mode", list(MODES))
def test_predict_cli_equals_jax(tree, tiny_depth, tmp_path, mode):
    flags = ["--data-dir", str(tree), "--split", "test", "--depth", "50", "--fp32", "1",
             "--data-parallel", "0",
             "--input-size", "65,65", "--restore-from", str(tree / "tiny.pth")] + MODES[mode]
    jax_main(flags + ["--output-dir", str(tmp_path / "jax")])
    result = main(flags + ["--output-dir", str(tmp_path / "port"), "--device", "cpu"])
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names and len(names) == 2
    assert sorted(os.path.basename(p) for p in result["paths"]) == names
    assert len(result["seconds"]) == 2
    for name in names:
        got, want = (Image.open(tmp_path / d / name) for d in ("port", "jax"))
        assert got.mode == want.mode == ("P" if "palette" in mode else "L")
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        if got.mode == "P":
            assert got.getpalette() == want.getpalette()
    if "labelid" in mode:  # labelIds, not trainIds
        from ccnet_tpu_torch.data.cityscapes import CITYSCAPES_TRAINID_TO_ID

        values = set(np.unique(np.asarray(Image.open(tmp_path / "port" / names[0]))))
        assert values <= set(CITYSCAPES_TRAINID_TO_ID.values())


def test_predict_cli_unported_flags_raise(tree, tmp_path):
    """``--space 2`` exits in one process (it must divide the ranks) and
    without ``--whole``, as the JAX CLI does; over two ranks it splits
    each image's height (``tests/test_torch_space.py``)."""
    base = ["--restore-from", str(tree / "tiny.pth"), "--device", "cpu",
            "--output-dir", str(tmp_path)]
    with pytest.raises(SystemExit, match="must divide the 1 rank"):
        main(base + ["--whole", "1", "--space", "2"])
    with pytest.raises(SystemExit, match="--whole inference only"):
        main(base + ["--space", "2"])


def test_predict_cli_cuda_without_cuda_raises(tree, tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--restore-from", str(tree / "tiny.pth"), "--output-dir", str(tmp_path)])


def test_predict_cli_takes_a_dataset(tree, tiny_depth, tmp_path):
    from ccnet_tpu_torch.data import SyntheticDataset

    ds = SyntheticDataset(n=2, hw=(70, 90), num_classes=19)
    result = main(["--depth", "50", "--fp32", "1", "--input-size", "65,65", "--restore-from",
                   str(tree / "tiny.pth"), "--device", "cpu", "--output-dir",
                   str(tmp_path)], dataset=ds)
    assert [os.path.basename(p) for p in result["paths"]] == [f"{ds.name(i)}.png"
                                                              for i in range(2)]
    assert np.asarray(Image.open(result["paths"][0])).shape == (70, 90)


@pytest.mark.parametrize("ignore", [255, 0])
def test_decode_labels_equals_jax(ignore):
    labels = np.random.RandomState(1).randint(0, 256, (2, 9, 11))
    labels[0, 0, :4] = [-3, 300, 255, 20]
    np.testing.assert_array_equal(vis.decode_labels(labels, 19, ignore),
                                  jax_vis.decode_labels(labels, 19, ignore))


def test_decode_predictions_and_inv_preprocess_equal_jax():
    rng = np.random.RandomState(2)
    logits = rng.randn(2, 7, 8, 21).astype(np.float32)
    np.testing.assert_array_equal(vis.decode_predictions(logits, 21),
                                  jax_vis.decode_predictions(logits, 21))
    images = rng.randn(2, 7, 8, 3).astype(np.float32) * 120
    np.testing.assert_array_equal(vis.inv_preprocess(images), jax_vis.inv_preprocess(images))
    mean = (128.0, 128.0, 128.0)
    np.testing.assert_array_equal(vis.inv_preprocess(images, mean),
                                  jax_vis.inv_preprocess(images, mean))
