"""Eval-mode ABN's kernel (``csrc/abn_eval.cu``) on the card.

Every test here needs a CUDA card of compute capability 9.0 and ``nvcc``,
and skips without one (here on the CPU they all skip). No JAX: on the card

    python -m pytest --noconftest tests/test_torch_abn_eval_gpu.py -q

Tolerances: the kernel against :func:`abn_eval_reference` (its formula in
f32, unrounded) within one bf16 rounding, 2^-8 of the reference's
magnitude, plus 2e-6 (16 f32 ulps) of the magnitudes of the terms |x·scale|,
|bias|, |mean·scale| and |r|, for the f32 operations taken in another order
(``rsqrtf`` to 2 ulps, fused multiply-adds, the shift's cancellation; f32
outputs: that alone); the R101 forward on the fused
path against the plain one at 5e-2 x scale with argmax agreement >= 99.5 %
(the model check of ``tests/test_torch_kernels_gpu.py``: bf16 layers after
every BN).
"""

from collections import Counter

import numpy as np
import pytest
import torch

from ccnet_tpu_torch.models import build_model, randomize_, registry
from ccnet_tpu_torch.nn import ABN
from ccnet_tpu_torch.ops import abn_eval
from ccnet_tpu_torch.utils import is_hopper, trace

from _abn_parent import abn_forward, parent_forwards

pytestmark = pytest.mark.gpu

# (B, C, H, W): the serving shapes' planes (97², 385²), the image pool's 1×1,
# PSP's 6×6 bin, and a ragged plane whose values end past the last vector
SHAPES = [(2, 1024, 97, 97), (2, 64, 385, 385), (8, 2048, 1, 1), (2, 512, 6, 6), (1, 3, 5, 7)]
CASES = [(shape, layout) for shape in SHAPES for layout in ("nchw", "channels_last")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    if not is_hopper():
        pytest.skip("the kernel is built for sm_90a (H100/H200)")
    return torch.device("cuda")


def _abn(C: int, activation: str, device, seed: int = 0) -> ABN:
    rng = np.random.RandomState(seed)
    m = ABN(C, activation)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5))
        m.bias.copy_(torch.from_numpy(rng.randn(C).astype(np.float32)))
        m.running_mean.copy_(torch.from_numpy(rng.randn(C).astype(np.float32)))
        m.running_var.copy_(torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5))
    return m.eval().to(device)


def _gained(before: dict) -> dict:
    now = trace.counts()
    return {k: now.get(k, 0) - before.get(k, 0) for k in ("abn.eval.fused", "abn.eval.plain")}


def _tensor(shape, dtype, layout, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    t = torch.randn(shape, generator=g, device=device).mul_(2).to(dtype)
    return t.contiguous(memory_format=torch.channels_last) if layout == "channels_last" else t


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", ["identity", "relu", "leaky_relu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,layout", CASES)
def test_kernel_within_one_rounding_of_f32(cuda, shape, layout, dtype, act, residual):
    x = _tensor(shape, dtype, layout, cuda, 1)
    r = _tensor(shape, dtype, layout, cuda, 2) if residual else None
    m = _abn(shape[1], "leaky_relu", cuda)
    params = (m.weight, m.bias, m.running_mean, m.running_var)
    before = dict(abn_eval.LAUNCHES)
    with torch.inference_mode():
        y = abn_eval.abn_eval(x, *params, m.eps, act, m.slope, r)
    torch.cuda.synchronize()
    assert abn_eval.LAUNCHES == {"abn_eval": before["abn_eval"] + 1,
                                 "abn_eval_residual": before["abn_eval_residual"] + residual}
    assert y.dtype == dtype and y.shape == x.shape and y.stride() == x.stride()
    ref = abn_eval.abn_eval_reference(x, *params, m.eps, act, m.slope, r)
    scale = m.weight * torch.rsqrt(m.running_var + m.eps)
    terms = (x.float() * scale[:, None, None]).abs() + (
        m.bias.abs() + (m.running_mean * scale).abs())[:, None, None]
    terms = terms + r.float().abs() if residual else terms
    tol = 2e-6 * terms + (2.0 ** -8 * ref.abs() if dtype == torch.bfloat16 else 0.0)
    err = (y.float() - ref).abs()
    assert bool((err <= tol).all()), f"max err {err.max().item():.3e}, worst excess " \
                                     f"{(err - tol).max().item():.3e}"


def test_abn_counts_fused_and_plain_calls(cuda):
    """Every eval call on the card takes the kernel and counts
    ``abn.eval.fused``, none ``abn.eval.plain``: a non-contiguous input, an
    input 2 bytes past a 16-byte boundary and a residual of other strides
    are copied dense first, and give the kernel's output on dense copies
    bit for bit."""
    m = _abn(64, "identity", cuda)
    x = _tensor((2, 64, 33, 41), torch.bfloat16, "nchw", cuda, 3)
    r = _tensor((2, 64, 33, 41), torch.bfloat16, "nchw", cuda, 4)
    skew = x.transpose(2, 3).contiguous().transpose(2, 3)  # (2, 64, 33, 41), W-major
    odd = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape).copy_(x)
    launches, before = abn_eval.LAUNCHES["abn_eval"], trace.counts()
    with torch.inference_mode():
        want = m(x, residual=r, relu=True)
        got = [m(skew, residual=r, relu=True), m(odd, residual=r, relu=True),
               m(x, residual=r.contiguous(memory_format=torch.channels_last), relu=True)]
    torch.cuda.synchronize()
    assert _gained(before) == {"abn.eval.fused": 4, "abn.eval.plain": 0}
    assert abn_eval.LAUNCHES["abn_eval"] == launches + 4
    assert odd.data_ptr() % 16 and not skew.is_contiguous()
    for g in got:
        assert torch.equal(g, want)
    assert got[0].stride() == x.stride()  # a copy in NCHW, and y in its layout


def test_abn_refuses_what_the_kernel_cannot_take(cuda):
    """On the card nothing gives way to the torch expression: a dtype the
    kernel has no build for, a residual of another dtype, and more channels
    than its table holds raise."""
    m = _abn(16, "identity", cuda)
    x = _tensor((2, 16, 5, 7), torch.bfloat16, "nchw", cuda, 5)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="bf16 or f32"):
            m(x.half())
        with pytest.raises(ValueError, match="residual"):
            m(x, residual=x.float())
        wide = _abn(6145, "identity", cuda)
        with pytest.raises(RuntimeError, match="channels"):
            wide(_tensor((1, 6145, 2, 2), torch.float32, "nchw", cuda, 6))


@pytest.mark.parametrize("layout", ["nchw", "channels_last"])
@pytest.mark.parametrize("act", ["relu", "leaky_relu"])
def test_eval_under_autograd_takes_the_kernel_and_its_backward(cuda, act, layout):
    """An eval-mode ABN run with autograd on the card: the kernel's forward,
    and gradients of x, the residual, the weight and the bias equal to those
    of the torch expression in f32."""
    m = _abn(64, "leaky_relu", cuda)
    x0 = _tensor((2, 64, 9, 11), torch.float32, layout, cuda, 7)
    r0 = _tensor((2, 64, 9, 11), torch.float32, layout, cuda, 8)
    grads = []
    for route in ("kernel", "plain"):
        x, r = x0.clone().requires_grad_(), r0.clone().requires_grad_()
        m.zero_grad()
        launches = abn_eval.LAUNCHES["abn_eval"]
        y = m(x, residual=r, relu=act == "relu") if route == "kernel" else \
            m._eval_plain(x, r, act)
        assert abn_eval.LAUNCHES["abn_eval"] == launches + (route == "kernel")
        y.backward(torch.cos(torch.arange(y.numel(), device=cuda, dtype=y.dtype)
                             .view(y.shape)))
        grads.append([x.grad, r.grad, m.weight.grad.clone(), m.bias.grad.clone()])
    for g, w in zip(*grads):
        assert torch.allclose(g, w, rtol=1e-5, atol=1e-4)


def test_r101_eval_forward_fused_against_plain(cuda, monkeypatch):
    """A CCNet-R101 eval forward of a (8, 3, 769, 769) bf16 batch: 110 fused
    launches (106 trunk BNs, 33 of them with a residual; 3 of the RCCA head,
    1 of the DSN) and the logits of the torch expression's forward."""
    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's default setting
    model = build_model("ccnet", num_classes=19, recurrence=2, depth=101,
                        dtype=torch.bfloat16, device=cuda)
    randomize_(model, seed=0)
    x = torch.from_numpy((np.random.RandomState(2).rand(8, 3, 769, 769) * 255.0 - 120.0)
                         .astype(np.float32)).to(cuda)
    with torch.inference_mode():
        launches, before = abn_eval.LAUNCHES["abn_eval"], trace.counts()
        residual = abn_eval.LAUNCHES["abn_eval_residual"]
        fused = model(x)["main"]
        torch.cuda.synchronize()
        assert abn_eval.LAUNCHES["abn_eval"] - launches == 110
        assert abn_eval.LAUNCHES["abn_eval_residual"] - residual == 33  # the bn3s
        assert _gained(before) == {"abn.eval.fused": 110, "abn.eval.plain": 0}
        monkeypatch.setattr(ABN, "_eval", ABN._eval_plain)
        plain = model(x)["main"]
    scale = max(1.0, plain.abs().max().item())
    assert torch.isfinite(fused).all()
    assert (fused - plain).abs().max().item() <= 5e-2 * scale
    assert (fused.argmax(1) == plain.argmax(1)).float().mean().item() >= 0.995


def _train_step_kernels(device) -> Counter:
    """The device operations of the second of two CCNet train steps (tiny
    trunk, bf16, OHEM, 65² crops), by name."""
    from torch.profiler import ProfilerActivity, profile

    from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(TrainConfig(depth=50, num_classes=5, input_size=(65, 65), batch_size=2,
                                  bf16=True, ohem=True, ohem_keep=500, export_pth=False,
                                  device="cuda"))
    rng = np.random.RandomState(0)
    images = torch.from_numpy(rng.randint(0, 256, (2, 80, 96, 3)).astype(np.uint8)).to(device)
    labels = torch.from_numpy(rng.randint(0, 5, (2, 80, 96)).astype(np.uint8)).to(device)

    def step(i):
        imgs, lbls = trainer._augment(images, labels, i)
        trainer.train_step(trainer.state, imgs, lbls)
        torch.cuda.synchronize()

    step(0)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(1)
    return Counter(e.name() for e in prof.profiler.kineto_results.events()
                   if str(e.device_type()).endswith("CUDA"))


def test_train_step_launches_the_parents_device_operations(cuda, monkeypatch):
    monkeypatch.setitem(registry._DEPTH_LAYERS, 50, (1, 1, 1, 1))
    before = trace.counts()
    got = _train_step_kernels(cuda)
    parent_forwards(monkeypatch)
    want = _train_step_kernels(cuda)
    assert got and got == want
    assert not any("abn" in name for name in got)
    assert _gained(before) == {"abn.eval.fused": 0, "abn.eval.plain": 0}
