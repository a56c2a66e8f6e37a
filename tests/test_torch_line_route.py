"""The line route of criss-cross attention inside the model, on the CPU.

The slice's two entry points reach the line route (K7a/K7b) through
feature maps longer than ``LONG_LINE``: whole-image (multi-scale + flip)
evaluation and full-frame training. Here the tiny CCNet sees a narrow, long
input (65 × 1033: features 9 × 130 at scale 1.0, 11 × 162 at 1.25), and the
model's CCA is sent through ``criss_cross_attention_cuda`` on CPU tensors,
so the line route's glue and the plain versions of K7a/K7b run inside the
network (a substitution local to these tests; the package's CPU route is
the plain op).

* multi-scale + flip whole-image prediction, port vs JAX
  ``predict_multiscale(whole=True, flip=True)`` on the same weights: f32
  logits within 1e-4 × scale, argmax agreement 1.0;
* one OHEM+DSN train step (f32) from one state, line route vs the plain
  op: loss within 1e-5 relative, every CCA grad within 1e-4 × the largest
  CCA grad (the two differ by the order of f32 sums only).
"""

import jax
import numpy as np
import pytest
import torch

from ccnet_tpu.evaluation import predict_multiscale as jax_predict_multiscale

from ccnet_tpu_torch.evaluation import predict_multiscale
from ccnet_tpu_torch.losses import build_criterion
from ccnet_tpu_torch.models import CCNet
from ccnet_tpu_torch.models import ccnet as port_ccnet
from ccnet_tpu_torch.ops import cc_attention_cuda as K
from ccnet_tpu_torch.train import create_train_state, make_train_step

from _torch_port import TINY_CLASSES, nchw, nhwc, tiny_ccnet_pair

HW = (65, 1033)
TILE = (65, 65)


def through_line_route(monkeypatch) -> dict:
    """Send the model's CCA through ``criss_cross_attention_cuda`` and count
    the K7a/K7b wrapper calls."""
    calls = {"cca_line_fwd": 0, "cca_line_bwd": 0}
    for name in calls:
        def counted(*a, _fn=getattr(K, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, counted)
    monkeypatch.setattr(port_ccnet, "criss_cross_attention",
                        lambda q, k, v: K.criss_cross_attention_cuda(q, k, v)[0])
    return calls


def test_msflip_whole_image_line_route_matches_jax(monkeypatch):
    jm, variables, tm = tiny_ccnet_pair(hw=TILE, seed=2)
    x = np.random.RandomState(3).randn(1, *HW, 3).astype(np.float32) * 50
    kw = dict(scales=(1.0, 1.25), flip=True, whole=True)

    def jax_apply(a):
        return jm.apply(variables, a, train=False)["main"]

    want = np.asarray(jax.jit(
        lambda im: jax_predict_multiscale(jax_apply, im, TILE, TINY_CLASSES, **kw))(x))
    calls = through_line_route(monkeypatch)
    with torch.inference_mode():
        got = nhwc(predict_multiscale(lambda a: tm(a)["main"], nchw(x), TILE, TINY_CLASSES,
                                      **kw))
    # 2 scales x 2 flips x R=2 recurrences x 2 paths
    assert calls == {"cca_line_fwd": 16, "cca_line_bwd": 0}
    np.testing.assert_allclose(got, want, atol=1e-4 * max(1.0, np.abs(want).max()))
    assert (got.argmax(-1) == want.argmax(-1)).mean() == 1.0


def test_full_frame_shaped_train_step_line_route_matches_plain(monkeypatch):
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(2, 3, *HW).astype(np.float32) * 50)
    y = torch.from_numpy(rng.randint(0, TINY_CLASSES, (2, *HW)).astype(np.int32))
    y[torch.from_numpy(rng.rand(2, *HW) < 0.1)] = 255
    runs = {}
    for route in ("line", "plain"):
        with monkeypatch.context() as mp:
            calls = through_line_route(mp) if route == "line" else None
            torch.manual_seed(0)
            model = CCNet(num_classes=TINY_CLASSES, layers=(1, 1, 1, 1), recurrence=2,
                          drop_rate=0.0)
            model.head.cca.gamma.data.fill_(0.5)  # gamma = 0 would zero every CCA grad
            state = create_train_state(model, base_lr=1e-2, max_steps=10)
            loss = make_train_step(build_criterion(ohem=True, min_kept=20000))(state, x, y)
            runs[route] = (float(loss["loss"]),
                           {n: p.grad.clone() for n, p in model.named_parameters()
                            if n.startswith("head.cca.")})
            if calls is not None:  # R=2 recurrences x 2 paths, forward and backward
                assert calls == {"cca_line_fwd": 4, "cca_line_bwd": 4}
    (loss_l, grads_l), (loss_p, grads_p) = runs["line"], runs["plain"]
    assert loss_l == pytest.approx(loss_p, rel=1e-5)
    scale = max(float(g.abs().max()) for g in grads_p.values())
    for name, want in grads_p.items():
        # the key bias's grad is zero but for rounding: it shifts every logit
        # of a query by the same q.b, which the softmax ignores
        if name != "head.cca.key_conv.bias":
            assert want.abs().max() > 1e-2 * scale, name
        assert (grads_l[name] - want).abs().max() <= 1e-4 * scale, name


def test_cli_train_full_frame_recipe_pads_the_crops(tmp_path):
    """The full-frame recipe's shapes at a small size: ``cli.train`` with
    crops one pixel larger than the images in each axis (1025 × 2049 from
    1024 × 2048 on the card; 65 × 129 from 64 × 128 here), so the
    augmentation pads every crop, and integer upsample ratio 8 from the
    9 × 17 logits, so the loss takes the fused NLL's route."""
    from ccnet_tpu_torch.cli.train import main

    result = main(["--device", "cpu", "--synthetic", "--depth", "50", "--fp32", "1",
                   "--batch-size", "2", "--input-size", "65,129", "--synthetic-size", "64,128",
                   "--num-steps", "1", "--ohem", "1", "--ohem-keep", "500",
                   "--save-pred-every", "1", "--snapshot-dir", str(tmp_path / "snap")])
    assert result["final_step"] == 1 and np.isfinite(result["losses"]).all()
