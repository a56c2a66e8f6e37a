"""Port's layers, backbone and CCNet vs the JAX package's, on the CPU.

Same numpy inputs and the same weights (carried over with
``jax_variables_to_state_dict``) through the flax module and its
``ccnet_tpu_torch`` counterpart, in f32. Tolerances: 1e-5 x scale for one
layer, 2e-4 x scale for whole networks (the summation order of convolutions
differs between the two frameworks' CPU kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccnet_tpu.models.backbone import DilatedResNet as JaxResNet
from ccnet_tpu.nn.layers import ABN as JaxABN, Conv as JaxConv
from ccnet_tpu.ops.pooling import max_pool_ceil as jax_max_pool_ceil
from ccnet_tpu.ops.resize import resize_bilinear_align_corners as jax_resize
from ccnet_tpu.utils.checkpoint import save_pth, variables_to_torch_state_dict

from ccnet_tpu_torch.models import CCNet, DilatedResNet, build_model
from ccnet_tpu_torch.nn import ABN, Conv
from ccnet_tpu_torch.ops import max_pool_ceil, resize_bilinear_align_corners
from ccnet_tpu_torch.utils.checkpoint import jax_variables_to_state_dict, load_pth

from _torch_port import TINY_CLASSES, TINY_LAYERS, nchw, nhwc, tiny_ccnet_pair, to_numpy_tree


def close(got, want, rel):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=rel * scale)


@pytest.fixture(scope="module")
def tiny():
    return tiny_ccnet_pair(hw=(65, 65), seed=0)


@pytest.mark.parametrize("kernel,stride,padding,dilation,bias", [
    (3, 1, 1, 1, False), (3, 2, 1, 1, True), (3, 1, 2, 2, False), (1, 2, 0, 1, True),
])
def test_conv_matches_jax(kernel, stride, padding, dilation, bias):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 11, 13, 6).astype(np.float32)
    jc = JaxConv(5, (kernel, kernel), strides=(stride, stride), padding=padding,
                 dilation=dilation, use_bias=bias)
    params = to_numpy_tree(jc.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"])
    want = np.asarray(jc.apply({"params": params}, jnp.asarray(x)))
    tc = Conv(6, 5, kernel, stride=stride, padding=padding, dilation=dilation, bias=bias)
    with torch.no_grad():
        tc.weight.copy_(torch.from_numpy(params["weight"].transpose(3, 2, 0, 1).copy()))
        if bias:
            tc.bias.copy_(torch.from_numpy(params["bias"]))
    close(nhwc(tc(nchw(x))), want, 1e-5)


@pytest.mark.parametrize("activation", ["leaky_relu", "identity"])
def test_abn_eval_and_train_match_jax(activation):
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 7, 8).astype(np.float32) * 2 + 0.5
    variables = {
        "params": {"weight": rng.rand(8).astype(np.float32) + 0.5,
                   "bias": rng.randn(8).astype(np.float32)},
        "batch_stats": {"running_mean": rng.randn(8).astype(np.float32),
                        "running_var": rng.rand(8).astype(np.float32) + 0.5},
    }
    ja = JaxABN(8, activation)
    ta = ABN(8, activation)
    ta.load_state_dict({k: torch.from_numpy(v) for d in variables.values()
                        for k, v in d.items()}, strict=True)
    assert sorted(ta.state_dict()) == ["bias", "running_mean", "running_var", "weight"]
    ta.eval()
    close(nhwc(ta(nchw(x))), np.asarray(ja.apply(variables, jnp.asarray(x))), 1e-5)

    want, mutated = ja.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    ta.train()
    close(nhwc(ta(nchw(x))), np.asarray(want), 1e-5)
    for name in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(ta, name).numpy(),
                                   np.asarray(mutated["batch_stats"][name]), atol=1e-5)


@pytest.mark.parametrize("hw", [(9, 9), (10, 7), (97, 193), (2, 3)])
def test_max_pool_ceil_matches_jax(hw):
    x = np.random.RandomState(2).randn(2, *hw, 4).astype(np.float32)
    got = nhwc(max_pool_ceil(nchw(x), 3, 2, 1))
    np.testing.assert_array_equal(got, np.asarray(jax_max_pool_ceil(jnp.asarray(x), 3, 2, 1)))


@pytest.mark.parametrize("src,dst", [((13, 17), (97, 129)), ((97, 97), (769, 769)),
                                     ((50, 70), (38, 52)), ((5, 1), (9, 4))])
def test_resize_align_corners_matches_jax(src, dst):
    x = np.random.RandomState(3).randn(2, *src, 3).astype(np.float32)
    got = nhwc(resize_bilinear_align_corners(nchw(x), dst))
    close(got, np.asarray(jax_resize(jnp.asarray(x), dst)), 1e-5)


def test_backbone_matches_jax():
    x = np.random.RandomState(4).randn(1, 33, 41, 3).astype(np.float32)
    jb = JaxResNet(TINY_LAYERS)
    variables = to_numpy_tree(jax.jit(lambda x: jb.init(jax.random.PRNGKey(0), x))(x))
    want3, want4 = jax.jit(jb.apply)(variables, jnp.asarray(x))
    tb = DilatedResNet(TINY_LAYERS).eval()
    tb.load_state_dict(jax_variables_to_state_dict(
        {"params": {"backbone": variables["params"]},
         "batch_stats": {"backbone": variables["batch_stats"]}}), strict=True)
    with torch.inference_mode():
        got3, got4 = tb(nchw(x))
    close(nhwc(got3), np.asarray(want3), 2e-4)
    close(nhwc(got4), np.asarray(want4), 2e-4)


def test_tiny_ccnet_logits_match_jax(tiny):
    jm, variables, tm = tiny
    x = np.random.RandomState(5).randn(2, 65, 65, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = tm(nchw(x))
    assert got["main"].dtype == torch.float32 and got["main"].shape == (2, TINY_CLASSES, 9, 9)
    close(nhwc(got["main"]), np.asarray(want["main"]), 2e-4)
    close(nhwc(got["aux"]), np.asarray(want["aux"]), 2e-4)
    # gamma = 0.5 makes the attention path move the logits: a broken CCA shows
    tm.head.cca.gamma.data.zero_()
    with torch.inference_mode():
        gated = tm(nchw(x))["main"]
    tm.head.cca.gamma.data.fill_(0.5)
    assert (gated - got["main"]).abs().max() > 1e-3


def test_state_dict_conversion_equals_jax_export(tiny):
    _, variables, tm = tiny
    ours = jax_variables_to_state_dict(variables)
    theirs = variables_to_torch_state_dict(variables)
    assert sorted(ours) == sorted(theirs) == sorted(tm.state_dict())
    for key, value in theirs.items():
        np.testing.assert_array_equal(ours[key].numpy(), np.asarray(value), err_msg=key)


def test_pth_export_loads_strict(tiny, tmp_path):
    _, variables, tm = tiny
    pth = str(tmp_path / "tiny.pth")
    save_pth(variables, pth)
    fresh = CCNet(num_classes=TINY_CLASSES, layers=TINY_LAYERS, recurrence=2, drop_rate=0.0)
    assert load_pth(pth, fresh, strict=True) == ([], [])
    for key, value in tm.state_dict().items():
        assert torch.equal(fresh.state_dict()[key], value), key
    # the reference's wrappers: {'model': ...} and 'module.' prefixes
    sd = {"model": {f"module.{k}": v for k, v in tm.state_dict().items()}}
    torch.save(sd, pth)
    assert load_pth(pth, fresh, strict=True) == ([], [])


def test_kernel_impl_on_cpu_raises(tiny):
    _, _, tm = tiny
    tm.set_cca_impl("kernel")
    try:
        with torch.inference_mode(), pytest.raises(ValueError, match="CUDA"):
            tm(torch.zeros(1, 3, 65, 65))
    finally:
        tm.set_cca_impl("auto")


def test_registry():
    # the heads without attention accept and ignore recurrence and impl
    for name, head in (("pspnet", "PSPModule"), ("deeplabv3", "ASPPModule")):
        m = build_model(name, num_classes=3, depth=50, recurrence=5, impl="kernel")
        assert type(m.head[0]).__name__ == head and m.head[1].out_channels == 3
        assert not any(".cca." in k for k in m.state_dict())
    m = build_model("danet", num_classes=3, depth=50, recurrence=5, impl="kernel")
    assert type(m.head).__name__ == "DANetHead" and m.head.conv8[1].out_channels == 3
    assert not any(".cca." in k for k in m.state_dict())
    with pytest.raises(ValueError, match="unknown model"):
        build_model("fcn")
    a = build_model("ccnet", num_classes=3, depth=50, seed=7)
    b = build_model("ccnet", num_classes=3, depth=50, seed=7)
    assert not a.training and len(a.layer3) == 6
    assert all(torch.equal(a.state_dict()[k], v) for k, v in b.state_dict().items())
