"""The port's CUDA kernels on the card, vs their plain-torch versions.

Every test here needs a CUDA card of compute capability 9.0 and ``nvcc``,
and skips without one (here on the CPU they all skip). The file imports
no JAX, so on the card it runs without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Tolerances: f32 (TF32 off) at 1e-4 x scale, where only the summation order
differs; bf16 against the plain version computed in f32 from the same bf16
inputs at 2e-2 x scale (the kernels round their output to bf16; 3e-2 for
the backward, whose final grads are rounded too, and for the line route
K7a/K7b); the model at 5e-2 x scale with argmax agreement >= 99.5 % (bf16
layers after CCA). The loss kernels: K5 at 1e-5 abs, K6 at 1e-4 x
max|plain grad|.
"""

import numpy as np
import pytest
import torch

from ccnet_tpu_torch.ops import cc_attention as plain
from ccnet_tpu_torch.ops import cc_attention_cuda as K
from ccnet_tpu_torch.ops import upsampled_ce as U
from ccnet_tpu_torch.utils import is_hopper

SHAPES = [
    (1, 5, 6, 4, 8),
    (2, 9, 8, 8, 16),
    (1, 1, 7, 4, 8),      # H=1: column path fully masked
    (1, 7, 1, 4, 8),      # W=1
    (8, 97, 97, 64, 512),  # the sliding-window tile batch
    (1, 129, 257, 64, 512),  # the whole 1024x2048 image
]

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    if not is_hopper():
        pytest.skip("the kernels are built for sm_90a (H100/H200)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def case(seed, B, H, W, Cq, Cv):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, Cq).astype(np.float32),
            rng.randn(B, H, W, Cq).astype(np.float32),
            rng.randn(B, H, W, Cv).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernels_match_plain(cuda, shape, dtype):
    tol = {"float32": 1e-4, "bfloat16": 2e-2}[dtype]
    q, k, v = (torch.from_numpy(a).to(cuda, getattr(torch, dtype)) for a in case(4, *shape))
    q32, k32, v32 = q.float(), k.float(), v.float()
    before = dict(K.LAUNCHES)
    with torch.inference_mode():
        col = K.cca_fwd_col(q, k, v)
        pairs = list(zip(col, K.cca_fwd_col_plain(q32, k32, v32)))
        pairs += zip(K.cca_fwd_row(q, k, v, *col), K.cca_fwd_row_plain(q32, k32, v32, *col))
        pairs += zip(K.criss_cross_attention_cuda(q, k, v),
                     plain.criss_cross_attention_stats(q32, k32, v32))
    line = K.uses_line_route(shape[1], shape[2])  # the op takes K7a there, not K1/K2
    assert K.LAUNCHES == {n: c + {"cca_fwd_col": 2 - line, "cca_fwd_row": 2 - line,
                                  "cca_line_fwd": 2 * line}.get(n, 0)
                          for n, c in before.items()}
    for got, want in pairs:
        scale = max(1.0, want.abs().max().item())
        assert (got.float() - want).abs().max().item() <= tol * scale


def test_tiny_model_kernel_route_matches_plain(cuda):
    from ccnet_tpu_torch.models import CCNet

    torch.manual_seed(0)
    model = CCNet(num_classes=5, layers=(1, 1, 1, 1), recurrence=2, drop_rate=0.0,
                  dtype=torch.bfloat16).eval().to(cuda)
    model.head.cca.gamma.data.fill_(0.5)  # gamma = 0 would hide the attention path
    x = torch.from_numpy(np.random.RandomState(1).randn(2, 3, 129, 129)
                         .astype(np.float32) * 50).to(cuda)
    with torch.inference_mode():
        model.set_cca_impl("kernel")
        got = model(x)["main"]
        model.set_cca_impl("torch")
        want = model(x)["main"]
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 5e-2 * scale
    assert (got.argmax(1) == want.argmax(1)).float().mean().item() >= 0.995


def _plain_grads(q, k, v, g):
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    return torch.autograd.grad(plain.criss_cross_attention(*leaves), leaves, g)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bwd_kernels_match_plain(cuda, shape, dtype):
    """K3/K4 vs their plain versions, and the Function's grads vs
    torch.autograd of the plain op in f32 on the same inputs."""
    tol = {"float32": 1e-4, "bfloat16": 3e-2}[dtype]
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in case(5, *shape))
    g = torch.from_numpy(case(6, *shape)[2]).to(cuda, dt)
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    with torch.no_grad():
        out, m, L = K.criss_cross_attention_cuda(q, k, v)
        delta = (g32 * out.float()).sum(dim=-1)
        before = dict(K.LAUNCHES)
        col = K.cca_bwd_col(q, k, v, g, m, L, delta)
        row = K.cca_bwd_row(q, k, v, g, m, L, delta, *col)
        assert K.LAUNCHES["cca_bwd_col"] == before["cca_bwd_col"] + 1
        assert K.LAUNCHES["cca_bwd_row"] == before["cca_bwd_row"] + 1
        pairs = list(zip(col, K.cca_bwd_col_plain(q32, k32, v32, g32, m, L, delta)))
        pairs += zip(row, K.cca_bwd_row_plain(q32, k32, v32, g32, m, L, delta, *col))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    pairs += zip(torch.autograd.grad(K.criss_cross_attention_cuda(*leaves)[0], leaves, g),
                 _plain_grads(q32, k32, v32, g32))
    for got, want in pairs:
        scale = max(1.0, want.abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


# the line route's shapes (B, H, W, Cq, Cv): the whole image at scales 1.0
# and 1.75, and edge shapes with N = 1 on either path
LINE_SHAPES = [(1, 129, 257, 64, 512), (1, 225, 449, 64, 512), (2, 9, 441, 8, 16),
               (1, 1, 300, 4, 8), (1, 300, 1, 4, 8)]
# the two views the line route hands K7a/K7b: (masked, view of NHWC)
LINE_PATHS = ((True, K._to_col), (False, lambda t: t))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LINE_SHAPES)
def test_line_kernels_match_plain(cuda, shape, dtype):
    """K7a and K7b on both paths vs their plain versions, from the joint
    stats of the route's own combine, and the routed Function's output and
    grads vs torch.autograd of the plain op in f32."""
    tol = {"float32": 1e-4, "bfloat16": 3e-2}[dtype]
    dt = getattr(torch, dtype)
    assert K.uses_line_route(shape[1], shape[2])
    q, k, v = (torch.from_numpy(a).to(cuda, dt) for a in case(9, *shape))
    g = torch.from_numpy(case(10, *shape)[2]).to(cuda, dt)
    f32 = [t.float() for t in (q, k, v, g)]
    pairs = []
    with torch.no_grad():
        before = dict(K.LAUNCHES)
        out, m, L = K.cca_line_route_fwd(q, k, v)
        delta = (f32[3] * out).sum(dim=-1)
        for masked, view in LINE_PATHS:
            pairs += zip(K.cca_line_fwd(view(q), view(k), view(v), masked),
                         K.cca_line_fwd_plain(*(view(t) for t in f32[:3]), masked))
            pairs += zip(K.cca_line_bwd(*(view(t) for t in (q, k, v, g, m, L, delta)), masked),
                         K.cca_line_bwd_plain(*(view(t) for t in (*f32, m, L, delta)), masked))
        assert K.LAUNCHES == {n: c + {"cca_line_fwd": 4, "cca_line_bwd": 2}.get(n, 0)
                              for n, c in before.items()}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = K.criss_cross_attention_cuda(*leaves)[0]
    pairs.append((out, plain.criss_cross_attention(*f32[:3])))
    pairs += zip(torch.autograd.grad(out, leaves, g), _plain_grads(*f32))
    for got, want in pairs:
        scale = max(1.0, want.abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


LOSS_SHAPES = [(8, 97, 97, 19, 8), (2, 5, 7, 4, 3), (1, 9, 9, 6, 4)]  # B, h, w, C, r


@pytest.mark.parametrize("label_dtype", ["int32", "uint8"])
@pytest.mark.parametrize("shape", LOSS_SHAPES)
def test_loss_kernels_match_plain(cuda, shape, label_dtype):
    B, h, w, C, r = shape
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    rng = np.random.RandomState(7)
    logits = torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32)).to(cuda)
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.15] = 255
    labels = torch.from_numpy(labels.astype(label_dtype)).to(cuda)
    g = torch.from_numpy(rng.rand(B, H, W).astype(np.float32)).to(cuda)
    before = dict(U.LAUNCHES)
    nll = U.upsampled_nll_fwd(logits, labels)
    dl = U.upsampled_nll_bwd(logits, labels, g)
    assert U.LAUNCHES == {n: c + 1 for n, c in before.items()}
    want_nll = U.upsampled_nll_reference(logits, labels)
    want_dl = U.upsampled_nll_bwd_plain(logits, labels, g)
    assert (nll - want_nll).abs().max().item() <= 1e-5
    assert (dl - want_dl).abs().max().item() <= 1e-4 * want_dl.abs().max().item()


def test_tiny_train_step_kernel_route_matches_plain(cuda):
    """One f32 train step of a tiny CCNet with gamma = 0.5, kernels (CCA and
    NLL) vs plain, from the same state: loss and CCA grads agree."""
    from ccnet_tpu_torch.losses import build_criterion
    from ccnet_tpu_torch.models import CCNet
    from ccnet_tpu_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(8)
    x = torch.from_numpy(rng.randn(2, 3, 129, 129).astype(np.float32) * 50).to(cuda)
    y = torch.from_numpy(rng.randint(0, 5, (2, 129, 129)).astype(np.int32)).to(cuda)
    results = []
    for impl in ("kernel", "torch"):
        torch.manual_seed(0)
        model = CCNet(num_classes=5, layers=(1, 1, 1, 1), recurrence=2, drop_rate=0.0,
                      impl=impl).to(cuda)
        model.head.cca.gamma.data.fill_(0.5)  # gamma = 0 would zero every CCA grad
        state = create_train_state(model, base_lr=1e-2, max_steps=10)
        loss = make_train_step(build_criterion(ohem=True, min_kept=2000, impl=impl))(
            state, x, y)["loss"]
        results.append((loss.item(), {n: p.grad.clone() for n, p in model.named_parameters()
                                      if n.startswith("head.cca.")}))
    (lk, gk), (lt, gt) = results
    assert abs(lk - lt) <= 1e-4 * abs(lt)
    for name, want in gt.items():
        assert (gk[name] - want).abs().max().item() <= 1e-3 * max(want.abs().max().item(), 1e-6)


# the probes P1–P5 (ccnet_tpu_torch/csrc/probes.cu): the script's shapes,
# ragged edges, and the model's (K1's column logits, the column-major copy of v)
PROBE_DOT_SHAPES = [(96, 16, 64), (7, 3, 70)]                      # (H, T, C)
PROBE_DOT4_SHAPES = [(2, 96, 33, 64), (8, 97, 97, 64), (1, 33, 5, 8)]  # (B, H, W, C)
PROBE_SWAP_SHAPES = [(96, 16, 128), (9, 13, 8)]                    # (A, B, C)
PROBE_STORE_SHAPES = [(2, 96, 33, 512), (8, 97, 97, 512), (1, 9, 17, 8)]
PROBE_SCALE_SHAPES = [(97, 256), (1, 1), (3, 1000)]


def _probe_in(seed, shape, cuda, dtype=torch.bfloat16):
    return torch.from_numpy(np.random.RandomState(seed).randn(*shape).astype(np.float32)).to(
        cuda, dtype)


def _dot_close(got, want):  # same bf16 products, f32 sums in another order
    assert tuple(got.shape) == tuple(want.shape) and got.dtype == torch.float32
    scale = max(1.0, want.abs().max().item())
    assert (got - want).abs().max().item() <= 1e-4 * scale


@pytest.mark.parametrize("shape", PROBE_DOT_SHAPES)
def test_probe_mid_batch_dot_matches_plain(cuda, shape):
    from ccnet_tpu_torch.ops import probes as P

    q, k = _probe_in(11, shape, cuda), _probe_in(12, shape, cuda)
    before = P.LAUNCHES["mid_batch_dot"]
    got = P.mid_batch_dot(q, k)
    assert P.LAUNCHES["mid_batch_dot"] == before + 1
    _dot_close(got, P.mid_batch_dot_plain(q, k))


@pytest.mark.parametrize("shape", PROBE_DOT4_SHAPES)
def test_probe_mid_batch_dot_4d_matches_plain(cuda, shape):
    from ccnet_tpu_torch.ops import probes as P

    q, k = _probe_in(13, shape, cuda), _probe_in(14, shape, cuda)
    before = P.LAUNCHES["mid_batch_dot_4d"]
    got = P.mid_batch_dot_4d(q, k)
    assert P.LAUNCHES["mid_batch_dot_4d"] == before + 1
    _dot_close(got, P.mid_batch_dot_4d_plain(q, k))


@pytest.mark.parametrize("kind,shape", [("swap_leading", s) for s in PROBE_SWAP_SHAPES]
                         + [("store_transposed", s) for s in PROBE_STORE_SHAPES]
                         + [("scale_ragged", s) for s in PROBE_SCALE_SHAPES])
def test_probe_copies_are_bit_exact(cuda, kind, shape):
    from ccnet_tpu_torch.ops import probes as P

    x = _probe_in(15, shape, cuda, torch.float32 if kind == "scale_ragged" else torch.bfloat16)
    before = P.LAUNCHES[kind]
    got = getattr(P, kind)(x)
    assert P.LAUNCHES[kind] == before + 1
    want = getattr(P, f"{kind}_plain")(x)
    assert got.shape == want.shape and torch.equal(got, want)
