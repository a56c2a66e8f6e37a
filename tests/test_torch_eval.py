"""Port's evaluation slice vs the JAX package's, on the CPU.

Tiling arithmetic, sliding / whole / multi-scale+flip prediction with the
tiny CCNet (same randomised weights in both packages), the confusion matrix
and IoU, the Evaluator end to end, and a smoke of the evaluation CLI. Logit
tolerances are 2e-4 x scale (f32 networks whose convolutions sum in another
order).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccnet_tpu.data import DataLoader as JaxDataLoader
from ccnet_tpu.evaluation import Evaluator as JaxEvaluator
from ccnet_tpu.evaluation import (
    compute_tiles as jax_compute_tiles,
    confusion_matrix as jax_confusion_matrix,
    iou_from_confusion as jax_iou,
    predict_multiscale as jax_predict_multiscale,
    predict_sliding as jax_predict_sliding,
    predict_whole as jax_predict_whole,
)

from ccnet_tpu_torch.data import CITYSCAPES_MEAN_BGR, DataLoader, SyntheticDataset
from ccnet_tpu_torch.evaluation import (
    Evaluator,
    compute_tiles,
    confusion_matrix,
    iou_from_confusion,
    predict_multiscale,
    predict_sliding,
    predict_whole,
)

from _torch_port import TINY_CLASSES, nchw, nhwc, tiny_ccnet_pair

TILE = (65, 65)


@pytest.fixture(scope="module")
def tiny():
    jm, variables, tm = tiny_ccnet_pair(hw=TILE, seed=1)

    def jax_apply(x):
        return jm.apply(variables, x, train=False)["main"]

    def torch_apply(x):
        return tm(x)["main"]

    return jax_apply, torch_apply


def close(got, want, rel=2e-4):
    np.testing.assert_allclose(got, want, atol=rel * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("hw", [(1024, 2048), (769, 769), (1025, 2049), (800, 1200),
                                (81, 97), (40, 50)])
def test_tiles_match_jax(hw):
    assert compute_tiles(hw, (769, 769)) == jax_compute_tiles(hw, (769, 769))
    assert compute_tiles(hw, TILE) == jax_compute_tiles(hw, TILE)


def _image(seed, hw=(81, 97)):
    return np.random.RandomState(seed).randn(1, *hw, 3).astype(np.float32) * 50


def test_predict_sliding_matches_jax(tiny):
    jax_apply, torch_apply = tiny
    x = _image(0)
    want = jax.jit(lambda im: jax_predict_sliding(jax_apply, im, TILE, TINY_CLASSES))(x)
    with torch.inference_mode():
        got = predict_sliding(torch_apply, nchw(x), TILE, TINY_CLASSES)
    assert got.shape == (1, TINY_CLASSES, 81, 97)
    close(nhwc(got), np.asarray(want))


def test_predict_whole_matches_jax(tiny):
    jax_apply, torch_apply = tiny
    x = _image(1)
    want = jax.jit(lambda im: jax_predict_whole(jax_apply, im, TINY_CLASSES))(x)
    with torch.inference_mode():
        got = predict_whole(torch_apply, nchw(x), TINY_CLASSES)
    close(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("whole", [False, True])
def test_predict_multiscale_flip_matches_jax(tiny, whole):
    jax_apply, torch_apply = tiny
    x = _image(2)
    kw = dict(scales=(0.75, 1.0), flip=True, whole=whole)
    want = jax.jit(lambda im: jax_predict_multiscale(jax_apply, im, TILE, TINY_CLASSES, **kw))(x)
    with torch.inference_mode():
        got = predict_multiscale(torch_apply, nchw(x), TILE, TINY_CLASSES, **kw)
    close(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
def test_confusion_and_iou_match_jax(dtype):
    rng = np.random.RandomState(3)
    labels = rng.randint(0, 6, size=(2, 37, 41)).astype(dtype)
    labels[rng.rand(2, 37, 41) < 0.1] = 255
    labels[0, 0, :3] = 5  # a label past num_classes: dropped by both
    preds = rng.randint(0, 5, size=(2, 37, 41)).astype(np.uint8)
    want = np.asarray(jax_confusion_matrix(jnp.asarray(labels), jnp.asarray(preds), 5))
    got = confusion_matrix(torch.from_numpy(labels), torch.from_numpy(preds), 5)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    want_iu, want_miou = jax_iou(want)
    iu, miou = iou_from_confusion(got.numpy())
    np.testing.assert_allclose(iu, want_iu, atol=1e-12)
    assert abs(miou - want_miou) < 1e-12


def test_evaluator_matches_jax(tiny, tmp_path):
    jax_apply, torch_apply = tiny
    dataset = SyntheticDataset(n=2, hw=(81, 97), num_classes=TINY_CLASSES)
    common = dict(num_classes=TINY_CLASSES, tile_hw=TILE, mean=CITYSCAPES_MEAN_BGR)
    jev = JaxEvaluator(jax_apply, **common)
    tev = Evaluator(torch_apply, device="cpu", **common)

    want = jev.run(JaxDataLoader(dataset, 1, shuffle=False, num_workers=1, drop_last=False))
    got = tev.run(DataLoader(dataset, 1, shuffle=False, drop_last=False),
                  output_dir=str(tmp_path))
    assert abs(got["meanIU"] - want["meanIU"]) <= 1e-3
    assert len(got["batch_seconds"]) == 2
    assert json.load(open(tmp_path / "result.txt"))["meanIU"] == got["meanIU"]
    images = np.stack([dataset[i][0] for i in range(2)])
    agree = (tev.predict_batch(images) == jev.predict_batch(images)).mean()
    assert agree >= 0.999, agree


def test_evaluate_cli_smoke(tmp_path):
    from ccnet_tpu_torch.cli.evaluate import main

    out = str(tmp_path / "out")
    result = main([
        "--device", "cpu", "--synthetic", "--synthetic-size", "257,321",
        "--input-size", "257,257", "--model", "ccnet", "--depth", "50",
        "--output-dir", out, "--fp32", "1", "--batch-size", "1", "--save-preds", "0",
    ])
    assert 0 <= result["meanIU"] <= 1
    blob = json.load(open(os.path.join(out, "result.txt")))
    assert "meanIU" in blob and len(blob["IU_array"]) == 19
    ds = SyntheticDataset(n=2, hw=(257, 321), num_classes=19)
    assert np.asarray(result["confusion"]).sum() == sum((ds[i][1] != 255).sum() for i in range(2))


def test_evaluate_cli_cuda_without_cuda_raises(tmp_path, monkeypatch):
    from ccnet_tpu_torch.cli.evaluate import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--device", "cuda", "--synthetic", "--output-dir", str(tmp_path)])
