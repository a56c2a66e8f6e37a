"""ABN with the residual and the ReLU in its own call, on the CPU.

``ABN(x, residual, relu=True)`` is ``relu(BN(x) + residual)``. Train mode
runs BN, the add and the ReLU as the separate torch ops they were, and the
CPU's eval mode the torch expression it had: both equal the forwards of
``tests/_abn_parent.py`` bit for bit, running statistics included. The
kernel (``ops/abn_eval.py``) runs only on the card; its tests are in
``tests/test_torch_abn_eval_gpu.py``. Here: its plain version, the
backward of its autograd Function, and which inputs the wrapper copies.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmark.trace import Stretch
from ccnet_tpu.utils.checkpoint import save_pth

from ccnet_tpu_torch.models import CCNet, build_model, randomize_
from ccnet_tpu_torch.nn import ABN
from ccnet_tpu_torch.ops import abn_eval
from ccnet_tpu_torch.utils import trace
from ccnet_tpu_torch.utils.checkpoint import load_pth

from _abn_parent import abn_forward, parent_forwards
from _torch_port import TINY_CLASSES, TINY_LAYERS, nchw, nhwc, tiny_ccnet_pair

C = 8


def _abn(activation: str, seed: int = 0) -> ABN:
    rng = np.random.RandomState(seed)
    m = ABN(C, activation)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5))
        m.bias.copy_(torch.from_numpy(rng.randn(C).astype(np.float32)))
        m.running_mean.copy_(torch.from_numpy(rng.randn(C).astype(np.float32)))
        m.running_var.copy_(torch.from_numpy(rng.rand(C).astype(np.float32) + 0.5))
    return m


def _inputs(dtype, seed: int = 1):
    rng = np.random.RandomState(seed)
    x, r = (torch.from_numpy(rng.randn(3, C, 5, 7).astype(np.float32) * 2).to(dtype)
            for _ in range(2))
    return x, r


def _want(old: ABN, x, r, relu: bool):
    """The parent's ops: BN and the ABN's own activation (none where
    ``relu`` replaces it), the residual add, ReLU."""
    if relu:
        old.activation = "identity"
    want = abn_forward(old, x)
    want = want + r if r is not None else want
    return F.relu(want) if relu else want


def _gained(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in trace.counts().items()
            if k.startswith("abn.eval.") and v != before.get(k, 0)}


CALLS = [("identity", True, True), ("identity", True, False), ("identity", False, True),
         ("identity", False, False), ("leaky_relu", False, False),
         ("leaky_relu", False, True), ("leaky_relu", True, True)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation,residual,relu", CALLS)
def test_train_mode_runs_the_separate_ops(activation, residual, relu, dtype):
    x, r = _inputs(dtype)
    new, old = _abn(activation), _abn(activation)
    before = trace.counts()
    r = r if residual else None
    got = new(x, residual=r, relu=relu)
    want = _want(old, x, r, relu)
    assert got.dtype == dtype and torch.equal(got, want)
    for name in ("running_mean", "running_var"):
        assert torch.equal(getattr(new, name), getattr(old, name)), name
    assert _gained(before) == {}  # train mode counts no eval call


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation,residual,relu", CALLS)
def test_cpu_eval_is_the_torch_expression_and_counts_plain(activation, residual, relu, dtype):
    x, r = _inputs(dtype)
    m = _abn(activation).eval()
    r = r if residual else None
    before, launches = trace.counts(), dict(abn_eval.LAUNCHES)
    with torch.inference_mode():
        got = m(x, residual=r, relu=relu)
        want = _want(m, x, r, relu)
    assert got.dtype == dtype and torch.equal(got, want)
    assert _gained(before) == {"abn.eval.plain": 1}
    assert abn_eval.LAUNCHES == launches


@pytest.mark.parametrize("act", sorted(abn_eval.ACTIVATIONS))
def test_kernel_wrapper_on_the_cpu_is_the_reference_rounded(act):
    """The wrapper has no CPU route: a CPU tensor raises, as does an unknown
    activation. Its plain version, the kernel's arithmetic in f32, rounded
    once to bf16, is the f64 formula rounded once to bf16 but for ties."""
    x, r = _inputs(torch.bfloat16)
    m = _abn("identity")
    params = (m.weight, m.bias, m.running_mean, m.running_var)
    with pytest.raises(ValueError, match="CUDA"):
        abn_eval.abn_eval(x, *params, m.eps, act, 0.01, r)
    with pytest.raises(ValueError, match="activation"):
        abn_eval.abn_eval(x, *params, m.eps, "gelu")
    got = abn_eval.abn_eval_reference(x, *params, m.eps, act, 0.01, r)
    d = [t.double() for t in params]
    scale = d[0] / torch.sqrt(d[3] + m.eps)
    y = x.double() * scale[:, None, None] + (d[1] - d[2] * scale)[:, None, None] + r.double()
    y = {"identity": y, "relu": y.clamp(min=0), "leaky_relu": torch.where(y >= 0, y, y * 0.01)}[act]
    assert got.dtype == torch.float32
    assert torch.allclose(got.double(), y, rtol=1e-6, atol=1e-6)
    assert (got.to(torch.bfloat16) != y.to(torch.bfloat16)).float().mean().item() <= 0.01


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("act", sorted(abn_eval.ACTIVATIONS))
def test_backward_is_the_reference_gradient(act, residual):
    """``abn_eval_backward``, the backward of the kernel's autograd Function
    (eval mode under autograd on the card), against autograd through
    ``abn_eval_reference``, in f32."""
    x, r = (t.requires_grad_() for t in _inputs(torch.float32))
    x.data[0, 0, 0, :3] = torch.tensor([0.0, -1e-3, 1e-3])  # around the kink
    r = r if residual else None
    m = _abn("identity")
    params = (m.weight, m.bias, m.running_mean, m.running_var)
    y = abn_eval.abn_eval_reference(x, *params, m.eps, act, 0.01, r)
    dy = torch.from_numpy(np.random.RandomState(9).randn(*y.shape).astype(np.float32))
    want = torch.autograd.grad(y, [x] + ([r] if residual else []) + [m.weight, m.bias], dy)
    dx, dres, dw, db = abn_eval.abn_eval_backward(dy, x.detach(), None if r is None
                                                  else r.detach(), *params, m.eps, act, 0.01)
    got = [dx] + ([dres] if residual else [None]) + [dw, db]
    assert (dres is None) == (not residual)
    for g, w in zip([t for t in got if t is not None], want):
        assert g.dtype == w.dtype and torch.allclose(g, w, rtol=1e-5, atol=1e-5)


def _misaligned(shape):
    """A contiguous view 2 bytes past a 16-byte boundary."""
    return torch.zeros(int(np.prod(shape)) + 1, dtype=torch.bfloat16)[1:].view(shape)


@pytest.mark.parametrize("case", ["nchw", "channels_last", "strided", "misaligned"])
def test_dense_copies_only_what_the_kernel_cannot_read(case):
    """The wrapper hands the kernel x itself where it is contiguous NCHW or
    channels_last and 16-byte aligned, else a dense copy of it."""
    x = torch.randn(2, 8, 5, 7).to(torch.bfloat16)
    fmt = torch.contiguous_format
    if case == "channels_last":
        fmt = torch.channels_last
        x = x.contiguous(memory_format=fmt)
    elif case == "strided":
        x = x.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "misaligned":
        x = _misaligned((2, 8, 5, 7))
    got = abn_eval._dense(x, fmt)
    assert (got is x) == (case in ("nchw", "channels_last"))
    assert torch.equal(got, x) and got.is_contiguous(memory_format=fmt)
    assert got.data_ptr() % 16 == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("name", ["ccnet", "deeplabv3"])
def test_model_equals_the_parent_forward(monkeypatch, name, train, dtype):
    """A tiny model's logits (and, in train mode, its BN statistics) with the
    new call sites equal the parent forwards' bit for bit on the CPU."""
    def run():
        model = build_model(name, num_classes=TINY_CLASSES, depth=50, dtype=dtype, seed=3,
                            drop_rate=0.0)
        randomize_(model, seed=3)
        model.train(train)
        x = torch.from_numpy(np.random.RandomState(2).randn(2, 3, 41, 41)
                             .astype(np.float32) * 50)
        with torch.no_grad():
            out = model(x)
        return out, model.state_dict()

    from ccnet_tpu_torch.models import registry

    monkeypatch.setitem(registry._DEPTH_LAYERS, 50, TINY_LAYERS)
    got, got_state = run()
    parent_forwards(monkeypatch)
    want, want_state = run()
    for head in ("main", "aux"):
        assert torch.equal(got[head], want[head]), head
    for name, t in want_state.items():
        assert torch.equal(got_state[name], t), name


@pytest.fixture(scope="module")
def tiny():
    return tiny_ccnet_pair(hw=(65, 65), seed=0)


def test_jax_pth_export_loads_strict_into_the_new_call_sites(tiny, tmp_path):
    jm, variables, _ = tiny
    pth = str(tmp_path / "tiny.pth")
    save_pth(variables, pth)
    model = CCNet(num_classes=TINY_CLASSES, layers=TINY_LAYERS, recurrence=2, drop_rate=0.0)
    assert load_pth(pth, model, strict=True) == ([], [])
    x = np.random.RandomState(5).randn(2, 65, 65, 3).astype(np.float32)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, jnp.asarray(x))
    with torch.inference_mode():
        got = model.eval()(nchw(x))
    for head in ("main", "aux"):
        scale = max(1.0, float(np.abs(np.asarray(want[head])).max()))
        np.testing.assert_allclose(nhwc(got[head]), np.asarray(want[head]), atol=2e-4 * scale)


def test_benchmark_reads_the_fused_share(monkeypatch):
    """``abn_fused_share.serve``: 100·fused / (fused + plain) of the
    program's counters in a serving run on a card; None elsewhere."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "benchmark", "metrics", "abn_fused_share.serve.py")
    spec = importlib.util.spec_from_file_location("abn_fused_share_serve", path)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)

    def stretch(kind="serve", ops=(("k", 0, 10, None),)):
        return Stretch(steps=1, window_s=1e-8, busy_s=1e-8, ops=list(ops),
                       ranges=[("ProfilerStep#1", 0, 10, 1)], gaps=[], info={"kind": kind})

    monkeypatch.setattr(trace, "COUNTS", {"abn.eval.fused": 330, "abn.eval.plain": 110})
    assert reader.read(stretch()) == pytest.approx(75.0)
    assert reader.read(stretch(kind="train")) is None
    assert reader.read(stretch(ops=())) is None  # no card
    monkeypatch.setattr(trace, "COUNTS", {"serve.requests": 3})
    assert reader.read(stretch()) is None  # a program that counts neither
