"""Port's PSPNet and DeepLabv3 (and what they need) vs the JAX package's, on the CPU.

* :func:`adaptive_avg_pool` vs JAX's bin-matrix pooling at 97 → 1, 2, 3, 6 and
  at a size smaller than its bins (5 → 6): 1e-5 x scale;
* the priors' align-corners upsample (matrix products) vs JAX's resize and
  vs ``F.interpolate`` forward and backward: 1e-5 x scale;
* the B = 1 train-mode ABN (DeepLabv3's image pool sees one value per
  channel) and B = 2, outputs and running stats vs JAX's ABN: 1e-5;
* PSPNet and DeepLabv3 at layers (1, 1, 1, 1), 5 classes, f32, weights
  carried by the JAX package's ``save_pth`` and loaded with ``strict=True``:
  the reference key set, eval logits at 2e-4 x scale (the summation order of
  the frameworks' CPU convolutions differs, as in ``test_torch_model.py``),
  and the running stats after one train-mode forward vs JAX's mutated
  ``batch_stats`` at 1e-4 (every BN precedes the heads' dropout, whose
  bits differ between the frameworks, so train-mode logits are not compared).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ccnet_tpu.models import DeepLabV3 as JaxDeepLabV3, PSPNet as JaxPSPNet
from ccnet_tpu.nn.layers import ABN as JaxABN
from ccnet_tpu.ops.pooling import adaptive_avg_pool as jax_adaptive_avg_pool
from ccnet_tpu.ops.resize import resize_bilinear_align_corners as jax_resize
from ccnet_tpu.utils.checkpoint import save_pth, variables_to_torch_state_dict

from ccnet_tpu_torch.models import DeepLabV3, PSPNet
from ccnet_tpu_torch.nn import ABN
from ccnet_tpu_torch.ops import adaptive_avg_pool
from ccnet_tpu_torch.ops.resize import align_corners_matrix, upsample_small_align_corners
from ccnet_tpu_torch.utils import load_pth

from _torch_port import TINY_CLASSES, TINY_LAYERS, nchw, nhwc, randomized_variables

MODELS = {"pspnet": (JaxPSPNet, PSPNet), "deeplabv3": (JaxDeepLabV3, DeepLabV3)}
HW = (65, 65)


def close(got, want, rel):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=rel * scale)


@pytest.mark.parametrize("src,out", [(97, 1), (97, 2), (97, 3), (97, 6), (5, 6), (9, 6)])
def test_adaptive_avg_pool_matches_jax(src, out):
    x = np.random.RandomState(0).randn(2, src, src + 2, 3).astype(np.float32)
    want = np.asarray(jax_adaptive_avg_pool(jnp.asarray(x), (out, out)))
    close(nhwc(adaptive_avg_pool(nchw(x), (out, out))), want, 1e-5)


@pytest.mark.parametrize("src,dst", [((1, 1), (97, 97)), ((2, 2), (97, 97)), ((3, 3), (9, 9)),
                                     ((6, 6), (97, 193)), ((5, 1), (9, 4))])
def test_upsample_small_matches_jax_and_interpolate(src, dst):
    """The priors' resize: equal to JAX's align-corners resize, and to
    F.interpolate forward and backward."""
    x = np.random.RandomState(7).randn(2, *src, 3).astype(np.float32)
    got = upsample_small_align_corners(nchw(x).requires_grad_(True), dst)
    close(nhwc(got), np.asarray(jax_resize(jnp.asarray(x), dst)), 1e-5)
    xt = nchw(x).requires_grad_(True)
    want = F.interpolate(xt, size=dst, mode="bilinear", align_corners=True)
    g = torch.from_numpy(np.random.RandomState(8).randn(*want.shape).astype(np.float32))
    (gx,) = torch.autograd.grad(upsample_small_align_corners(xt, dst), xt, g)
    (wx,) = torch.autograd.grad(want, xt, g)
    close(gx.numpy(), wx.numpy(), 1e-5)
    assert upsample_small_align_corners(nchw(x).bfloat16(), dst).dtype == torch.bfloat16


def test_upsample_small_weights_cached_across_inference_mode():
    """The weights are built once per (n_in, n_out, device); a matrix first
    built under inference mode (evaluation) still serves a later backward
    (training)."""
    align_corners_matrix.cache_clear()
    x = torch.from_numpy(np.random.RandomState(9).randn(1, 2, 3, 4).astype(np.float32))
    with torch.inference_mode():
        first = upsample_small_align_corners(x, (11, 13))
    xt = x.clone().requires_grad_(True)
    second = upsample_small_align_corners(xt, (11, 13))
    (gx,) = torch.autograd.grad(second.sum(), xt)
    assert torch.equal(first, second.detach())
    assert align_corners_matrix.cache_info().hits == 2  # the second call built nothing
    assert align_corners_matrix(3, 11) is align_corners_matrix(3, 11)
    # each input pixel's weights sum, over the outputs, to what its column and row take
    want = align_corners_matrix(3, 11).sum(0)[:, None] * align_corners_matrix(4, 13).sum(0)
    close(gx[0, 0].numpy(), want.numpy(), 1e-6)


@pytest.mark.parametrize("batch", [1, 2])
def test_abn_train_one_value_per_channel_matches_jax(batch):
    """(B, C, 1, 1) in train mode: at B = 1 F.batch_norm would raise; the
    JAX ABN gives beta and scales the running variance by 0.9."""
    rng = np.random.RandomState(batch)
    x = rng.randn(batch, 1, 1, 6).astype(np.float32) * 3
    variables = {
        "params": {"weight": rng.rand(6).astype(np.float32) + 0.5,
                   "bias": rng.randn(6).astype(np.float32)},
        "batch_stats": {"running_mean": rng.randn(6).astype(np.float32),
                        "running_var": rng.rand(6).astype(np.float32) + 0.5},
    }
    want, mutated = JaxABN(6).apply(variables, jnp.asarray(x), train=True,
                                    mutable=["batch_stats"])
    ta = ABN(6)
    ta.load_state_dict({k: torch.from_numpy(v) for d in variables.values()
                        for k, v in d.items()}, strict=True)
    got = ta.train()(nchw(x).requires_grad_(True))
    close(nhwc(got), np.asarray(want), 1e-5)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(mutated["batch_stats"][name]), atol=1e-5)
    got.sum().backward()  # differentiable, as the JAX formula is
    assert ta.weight.grad is not None and ta.bias.grad is not None


@pytest.fixture(scope="module", params=["pspnet", "deeplabv3"])
def pair(request, tmp_path_factory):
    """(name, JAX model, variables, port model loaded strictly from the
    JAX package's .pth export)."""
    name = request.param
    jax_cls, torch_cls = MODELS[name]
    jm = jax_cls(num_classes=TINY_CLASSES, layers=TINY_LAYERS)
    variables = randomized_variables(jm, jnp.zeros((1, *HW, 3), jnp.float32), seed=1)
    pth = str(tmp_path_factory.mktemp(name) / f"{name}.pth")
    save_pth(variables, pth)
    tm = torch_cls(num_classes=TINY_CLASSES, layers=TINY_LAYERS)
    assert load_pth(pth, tm, strict=True) == ([], [])
    return name, jm, variables, tm.eval()


def test_key_set_equals_jax_export(pair):
    _, _, variables, tm = pair
    want = variables_to_torch_state_dict(variables)
    assert sorted(tm.state_dict()) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(tm.state_dict()[key].numpy(), np.asarray(value),
                                      err_msg=key)


def test_eval_logits_match_jax(pair):
    _, jm, variables, tm = pair
    x = np.random.RandomState(5).randn(2, *HW, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(nchw(x))
    assert got["main"].dtype == torch.float32 and got["main"].shape == (2, TINY_CLASSES, 9, 9)
    close(nhwc(got["main"]), np.asarray(want["main"]), 2e-4)
    close(nhwc(got["aux"]), np.asarray(want["aux"]), 2e-4)


@pytest.mark.parametrize("batch", [1, 2])
def test_train_mode_running_stats_match_jax(pair, batch):
    _, jm, variables, tm = pair
    x = np.random.RandomState(6).randn(batch, *HW, 3).astype(np.float32)
    _, mutated = jm.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(0)})
    want = variables_to_torch_state_dict({"params": variables["params"],
                                          "batch_stats": mutated["batch_stats"]})
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    try:
        tm.train()
        with torch.no_grad():
            tm(nchw(x))
        stats = {k: v for k, v in tm.state_dict().items() if k.endswith(("_mean", "_var"))}
        assert len(stats) == sum(k.endswith(("_mean", "_var")) for k in want)
        for key, value in stats.items():
            np.testing.assert_allclose(value.numpy(), np.asarray(want[key]), atol=1e-4,
                                       rtol=1e-4, err_msg=key)
    finally:
        tm.load_state_dict(before)
        tm.eval()


@pytest.mark.parametrize("name", ["pspnet", "deeplabv3"])
def test_cli_train_then_evaluate(name, tmp_path):
    """``cli.train --model X`` on the CPU (R50, batch 1 of 65² crops: the
    image-pool ABN sees one value per channel) for 2 steps, then
    ``cli.evaluate --model X`` scores the exported ``.pth``."""
    import os

    from ccnet_tpu_torch.cli.evaluate import main as evaluate
    from ccnet_tpu_torch.cli.train import main as train
    from ccnet_tpu_torch.models import build_model

    snap = str(tmp_path / "snap")
    result = train(["--model", name, "--device", "cpu", "--synthetic", "--depth", "50",
                    "--fp32", "1", "--batch-size", "1", "--input-size", "65,65",
                    "--synthetic-size", "96,128", "--num-steps", "2", "--save-pred-every", "2",
                    "--snapshot-dir", snap])
    assert result["final_step"] == 2 and all(np.isfinite(result["losses"]))
    pth = os.path.join(snap, "CS_scenes_2.pth")
    assert load_pth(pth, build_model(name, depth=50), strict=True) == ([], [])
    out = evaluate(["--model", name, "--device", "cpu", "--synthetic", "--depth", "50",
                    "--fp32", "1", "--synthetic-size", "72,96", "--input-size", "65,65",
                    "--restore-from", pth, "--save-preds", "0", "--output-dir",
                    str(tmp_path / "out")])
    assert 0.0 <= out["meanIU"] <= 1.0
    assert int(np.asarray(out["confusion"]).sum()) > 0
