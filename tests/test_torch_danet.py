"""DANet on the port (``models/danet.py``, ``ops/dual_attention.py``), on the CPU.

* the network against the benchmark's plain reference head
  (``benchmark/reference/heads/danet.py``) on one seeded state dict
  (``gamma`` 0.5), a one-block-a-layer trunk and a 65² input, in f32: main
  and auxiliary logits, then the gradients of one OHEM + DSN loss, leaf by
  leaf;
* :class:`PositionAttentionFn` on its CPU route (f32) and on the card's
  fused route (in fp16, which CPU flash attention takes) against an f64
  plain version at an uneven N: scale 1 (the same attention at 1/√Cq lies
  outside the tolerance);
* :class:`ChannelAttentionFn` on bf16 inputs at N = 4096 and 512 channels,
  energies in the thousands, against f64; the same computation with E
  rounded to bf16 lies far outside the tolerance, which is the precision
  fault the op's f32 energies guard against;
* the registry and the three CLIs take ``danet``; ``--space 2`` raises, and
  so does a DANet forward under a height-sharding plan (the model is not
  ``height_shardable``; every other model is);
* the spans ``ccnet.danet.pam`` / ``.cam`` and the counters under a profiler.

No JAX: the reference is plain torch.
"""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import inputs
from benchmark.reference import models as R
from benchmark.reference import train as RT
from ccnet_tpu_torch.cli import evaluate, predict
from ccnet_tpu_torch.cli import train as train_cli
from ccnet_tpu_torch.losses import criterion_ohem_dsn
from ccnet_tpu_torch.models import MODELS, DANet, build_model, registry
from ccnet_tpu_torch.ops.dual_attention import ChannelAttentionFn, PositionAttentionFn
from ccnet_tpu_torch.parallel import spatial
from ccnet_tpu_torch.utils import trace

LAYERS = (1, 1, 1, 1)
SEED = 3


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setitem(registry._DEPTH_LAYERS, 101, LAYERS)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _pair():
    port = build_model("danet", depth=101, dtype=torch.float32)
    shapes = [(n, tuple(t.shape)) for n, t in port.state_dict().items()]
    weights = inputs.weights(shapes, SEED, "cpu")
    for name, t in weights.items():
        if name.endswith("gamma"):
            t.fill_(0.5)
    port.load_state_dict(weights)
    ref = R.build({"model": "danet", "num_classes": 19, "layers": list(LAYERS),
                   "dropout": 0.1})
    R.load(ref, weights)
    assert [n for n, _ in R.state_names(ref)] == list(port.state_dict())
    return port, ref


def _image():
    return torch.randn(2, 3, 65, 65, generator=torch.Generator().manual_seed(1)) * 40


def test_network_logits_match_reference(tiny):
    port, ref = _pair()
    x = _image()
    out = port(x)
    main, aux = ref(x)
    # f32 both sides, the same operations in another order
    assert (out["main"] - main).abs().max() <= 1e-5 * main.abs().max()
    assert (out["aux"] - aux).abs().max() <= 1e-5 * aux.abs().max()


def test_network_loss_gradients_match_reference(tiny):
    """Train mode (batch statistics, dropout by the train step's rule), one
    OHEM + DSN loss, every leaf's gradient."""
    port, ref = _pair()
    port.train()
    ref.train()
    x = _image()
    labels = torch.randint(0, 19, (2, 65, 65), generator=torch.Generator().manual_seed(2))
    labels[:, :4] = 255
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed((SEED + 2) * 1000003)  # the train step's rule, step 0
        out = port(x)
    masks = RT.dropout_masks(SEED, 0, [(2, 512, 9, 9)] * 2, torch.float32, 0.1, "cpu")
    for mod, m in zip(ref.dropouts(), masks):
        mod.mask = m
    main, aux = ref(x)
    loss_p = criterion_ohem_dsn(out, labels, thresh=0.7, min_kept=1000, impl="torch")
    loss_r = RT.criterion(main, aux, labels, 255, 0.7, 1000)
    assert abs(loss_p.item() - loss_r.item()) <= 1e-5 * abs(loss_r.item())
    names = [n for n, _ in port.named_parameters()]
    gp = torch.autograd.grad(loss_p, [p for _, p in port.named_parameters()])
    gr = dict(zip([n for n, _ in ref.named_parameters()],
                  torch.autograd.grad(loss_r, list(ref.parameters()))))
    med = sorted(float(g.norm()) for g in gr.values())[len(gr) // 2]
    for name, g in zip(names, gp):
        # f32 sums in another order through a softmax over every position:
        # 1e-4 of the leaf's norm, or of the median leaf's where it is tiny
        assert (g - gr[name]).norm() <= 1e-4 * max(float(gr[name].norm()), med), name
    assert float(gr["head.sa.gamma"].abs()) > 0 and float(gr["head.sc.gamma"].abs()) > 0


def _pam_ref(q, k, v, scale=1.0):
    a = torch.softmax(scale * q @ k.transpose(1, 2), dim=-1)
    return a @ v


# the plain route in f32; the card's fused route runs on the CPU too in fp16
# (torch's CPU flash attention), which shows its heads-of-v split and the
# sum of dq, dk over the heads. Tolerances: f32 sums, 1e-5 of each
# tensor's magnitude; fp16 inputs and outputs (2^-11) and p rounded to fp16
# before p·v, 2^-9
@pytest.mark.parametrize("route,dtype,tol", [("plain", torch.float32, 1e-5),
                                             ("sdpa", torch.float16, 2 ** -9)])
def test_position_attention_against_f64(route, dtype, tol):
    g = torch.Generator().manual_seed(4)
    B, N, Cq, Cv = 2, 101, 8, 24  # N odd, Cv three heads of Cq
    q, k, v = (torch.randn(B, N, c, generator=g).to(dtype).requires_grad_()
               for c in (Cq, Cq, Cv))
    gout = torch.randn(B, N, Cv, generator=g).to(dtype)
    out = PositionAttentionFn.apply(q, k, v, route)
    grads = torch.autograd.grad(out, (q, k, v), gout)
    q64, k64, v64 = (t.detach().double().requires_grad_() for t in (q, k, v))
    ref = _pam_ref(q64, k64, v64)
    ref_grads = torch.autograd.grad(ref, (q64, k64, v64), gout.double())
    assert float((out.double() - ref).abs().max()) <= tol * float(ref.abs().max())
    for a, b in zip(grads, ref_grads):
        assert float((a.double() - b).abs().max()) <= tol * float(b.abs().max())
    # the published scale is 1: the same op at 1/√Cq lies far outside
    mutant = _pam_ref(q64, k64, v64, 1.0 / math.sqrt(Cq))
    assert float((mutant - ref).abs().max()) > 10 * tol * float(ref.abs().max())


def test_position_attention_route_checked():
    q = torch.zeros(1, 4, 2)
    with pytest.raises(ValueError, match="unknown"):
        PositionAttentionFn.apply(q, q, q, "flash")


def _cam_f64(x64, round_e=False):
    e = x64 @ x64.transpose(1, 2)
    if round_e:
        e = e.to(torch.bfloat16).double()
    a = torch.softmax(e.amax(dim=-1, keepdim=True) - e, dim=-1)
    return a @ x64


def test_channel_attention_bf16_energies_in_thousands():
    g = torch.Generator().manual_seed(0)
    x = (torch.relu(torch.randn(1, 512, 4096, generator=g)) * 1.5).bfloat16()
    gout = torch.randn(1, 512, 4096, generator=g).bfloat16()
    x64 = x.double().requires_grad_()
    e = x64.detach() @ x64.detach().transpose(1, 2)
    assert float(e.mean()) > 1000 and float(e.max()) > 4000
    ref = _cam_f64(x64)
    ref_grad = torch.autograd.grad(ref, x64, gout.double())[0]
    xx = x.clone().requires_grad_()
    out = ChannelAttentionFn.apply(xx)
    grad = torch.autograd.grad(out, xx, gout)[0]
    assert out.dtype == torch.bfloat16
    # two bf16 roundings (A before A·x, and the result): 2^-7 of the magnitude
    tol = 2 ** -7 * float(ref.abs().max())
    assert float((out.double() - ref).abs().max()) <= tol
    assert float((grad.double() - ref_grad).abs().max()) <= 2 ** -7 * float(
        ref_grad.abs().max())
    # E rounded to bf16 (spacing 4 to 32 here) moves the softmax by e^16
    faulty = _cam_f64(x64.detach(), round_e=True)
    assert float((faulty - ref).abs().max()) > 10 * tol


def test_registry_and_clis_take_danet(tiny):
    m = build_model("danet", num_classes=3, depth=101, recurrence=5, impl="kernel")
    assert isinstance(m, DANet) and m.head.conv8[1].out_channels == 3
    assert not m.training and float(m.head.sa.gamma) == 0 and float(m.head.sc.gamma) == 0
    assert m.head.conv5a[1].slope == 0.0 and m.dsn[1].slope == 0.01
    for cli in (train_cli, evaluate, predict):
        args = ["--model", "danet"] + (["--restore-from", "x.pth"] if cli is predict else [])
        assert cli.get_parser().parse_args(args).model == "danet"
    with pytest.raises(ValueError, match="unknown model.*danet"):
        build_model("fcn")


@pytest.mark.parametrize("cli", [evaluate, predict])
def test_space_raises_for_danet(cli):
    argv = ["--model", "danet", "--whole", "1", "--space", "2", "--device", "cpu",
            "--restore-from", "none.pth"]
    with pytest.raises(ValueError, match="not height-sharded"):
        cli.main(argv)


@pytest.mark.parametrize("name", list(MODELS))
def test_only_danet_is_not_height_shardable(name, tiny, monkeypatch):
    assert MODELS[name].height_shardable == (name != "danet")
    if name != "danet":
        MODELS[name].check_shardable()
        return
    model = build_model(name, num_classes=3, depth=101)
    monkeypatch.setattr(spatial._STATE, "plan", object(), raising=False)
    with pytest.raises(ValueError, match="DANet's head .* not height-sharded"):
        model(_image())


def test_spans_and_counters_under_profiler(tiny):
    port, _ = _pair()
    port.train()
    before = trace.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = port(_image()[:, :, :33, :33])
        (out["main"].sum() + out["aux"].sum()).backward()
    names = {e.name for e in prof.events()}
    for name in ("ccnet.danet.pam", "ccnet.danet.cam", "PositionAttentionFn",
                 "ChannelAttentionFn"):
        assert name in names, name
    assert any("PositionAttentionFnBackward" in n for n in names)
    after = trace.counts()
    assert after.get("danet.pam.plain", 0) - before.get("danet.pam.plain", 0) == 1
    assert after.get("danet.cam.calls", 0) - before.get("danet.cam.calls", 0) == 1
    assert after.get("danet.pam.sdpa", 0) == before.get("danet.pam.sdpa", 0)
