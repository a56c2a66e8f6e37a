"""The port's CUDA kernels on the card, vs their plain-torch versions.

Every test here needs a CUDA card of compute capability 9.0 and ``nvcc``,
and skips without one (here on the CPU they all skip). The file imports
no JAX, so on the card it runs without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_kernels_gpu.py -q

Tolerances: f32 (TF32 off) at 1e-4 x scale, where only the summation order
differs; bf16 against the plain version computed in f32 from the same bf16
inputs at 2e-2 x scale (the kernels round their output to bf16; 3e-2 for
the backward, whose final grads are rounded too, and for the line route
K7a/K7b); the tensor-core K1/K2 and K3/K4 against the plain versions fed
the same bf16 tensors, which round p (and de), o_col, the output and the
grads where the kernels do, at 1e-2 x scale (f32 sums in another order flip
a rounding here and there; K1/K2's bf16 outputs also bit-equal but for at
most 1 % of their elements); the tensor-core K7a/K7b likewise, at 2^-8 x
scale (K7a's o bit-equal but for 0.1 %) at the small line shapes, and
K1–K4 on bf16 lines past 128 (which run on K7a's/K7b's kernels) at 1e-2
x scale, K1's o_col and K2's out bit-equal but for 1 %;
the model at 5e-2 x scale with argmax agreement >= 99.5 % (bf16
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


def _want_natural(designs: dict, d: str, n: int) -> dict:
    """The launch counts of ``n`` calls of each of K1 and K2 (``d`` =
    ``"fwd"``) or K3 and K4 (``"bwd"``) in the designs ``{path: design}``:
    each under its own name and its design's tensor-core count."""
    want = {}
    for path, design in designs.items():
        for name in (f"cca_{d}_{path}", {"tensor_core": f"cca_{d}_{path}_tc",
                                         "tensor_core_lines": f"cca_line_{d}_tc"}.get(design)):
            if name:
                want[name] = want.get(name, 0) + n
    return want


def _expected_designs(shape, dtype) -> dict:
    if dtype == "float32":
        return {"col": "cuda_core", "row": "cuda_core"}
    return {p: "tensor_core" if n <= K.LONG_LINE else "tensor_core_lines"
            for p, n in zip(K.PATHS, shape[1:3])}


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
    line = K.uses_line_route("fwd", *shape[1:], dtype=q.dtype)  # the op takes K7a, not K1/K2
    designs = {p: K.kernel_design(q, p) for p in K.PATHS}  # f32: CUDA cores
    assert designs == _expected_designs(shape, dtype)
    want = _want_natural(designs, "fwd", 2 - line)  # the wrappers' and the op's, or theirs alone
    want["cca_line_fwd"] = 2 * line
    want["cca_line_fwd_tc"] = want.get("cca_line_fwd_tc", 0) + 2 * line * (dtype == "bfloat16")
    assert K.LAUNCHES == {n: c + want.get(n, 0) for n, c in before.items()}
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
        designs = {p: K.kernel_design(q, p) for p in K.PATHS}  # f32: CUDA cores
        assert designs == _expected_designs(shape, dtype)
        want = _want_natural(designs, "bwd", 1)
        assert K.LAUNCHES == {n: c + want.get(n, 0) for n, c in before.items()}
        pairs = list(zip(col, K.cca_bwd_col_plain(q32, k32, v32, g32, m, L, delta)))
        pairs += zip(row, K.cca_bwd_row_plain(q32, k32, v32, g32, m, L, delta, *col))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    pairs += zip(torch.autograd.grad(K.criss_cross_attention_cuda(*leaves)[0], leaves, g),
                 _plain_grads(q32, k32, v32, g32))
    for got, want in pairs:
        scale = max(1.0, want.abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


def _flipped(got, want) -> float:
    """The share of the elements of ``got`` not bit-equal to ``want``."""
    return (got != want).float().mean().item()


# the tensor-core K1–K4 (B, H, W, Cq, Cv): the sliding tile batch, the
# longest line (128) on both paths, and edge lines N in {1, 7, 16, 17} with
# Cq in {4, 8, 12, 64} and Cv in {8, 16, 21, 512} (Cq 4 and 12, Cv 21: rows
# that take element copies, not 16-byte ones; Cv 21: odd, stored singly)
TC_SHAPES = [(8, 97, 97, 64, 512), (1, 128, 128, 64, 512), (2, 1, 7, 4, 8), (2, 7, 1, 8, 16),
             (2, 16, 17, 8, 16), (1, 17, 16, 4, 512), (2, 128, 7, 8, 8), (1, 9, 128, 64, 16),
             (1, 5, 6, 12, 21)]


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_fwd_matches_rounding_plain(cuda, shape):
    """The tensor-core K1/K2 vs their plain versions on the same bf16
    tensors (p rounded to bf16 before p·v, o_col in bf16, as the kernels and
    the TPU kernels at the default precision round them): within 1e-2 x
    scale, and o_col and out bit-equal but for at most 1 % of flipped
    roundings, which the plain versions that keep p in f32 exceed. Each
    launch counts as the tensor-core design and allocates its three outputs
    and nothing else; K2 is fed K1's own outputs."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in case(13, *shape))
    assert all(K.kernel_design(q, p) == "tensor_core" for p in K.PATHS)
    with torch.no_grad():
        before = dict(K.LAUNCHES)
        outs = []
        for fn in (K.cca_fwd_col, K.cca_fwd_row):
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
            outs.append(fn(q, k, v, *(outs[0] if outs else ())))
            assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 3
        col, row = outs
        assert K.LAUNCHES == {n: c + (n.startswith(("cca_fwd_col", "cca_fwd_row")))
                              for n, c in before.items()}
        want_col = K.cca_fwd_col_plain(q, k, v)
        want_row = K.cca_fwd_row_plain(q, k, v, *col)
        t32 = [t.float() for t in (q, k, v)]
        unrounded = K.cca_fwd_row_plain(*t32, *K.cca_fwd_col_plain(*t32))[0].to(torch.bfloat16)
    assert max(_flipped(col[0], want_col[0]), _flipped(row[0], want_row[0])) <= 1e-2
    assert _flipped(unrounded, want_row[0]) > 1e-2
    if shape[1] == 1:  # the column path is all self slot: o_col = v, l_col = 1
        assert torch.equal(col[0], v) and torch.all(col[1] == plain.NEG_INF)
        assert torch.all(col[2] == 1.0)
    for got, want in (*zip(col, want_col), *zip(row, want_row)):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale
    assert col[0].dtype == row[0].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", TC_SHAPES)
def test_tensor_core_bwd_matches_rounding_plain(cuda, shape):
    """The tensor-core K3/K4 vs their plain versions on the same bf16
    tensors (p and de rounded to bf16, as the kernels and the TPU kernels
    at the default precision round them); each launch counts as the
    tensor-core design and allocates its three outputs and nothing else."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in case(11, *shape))
    g = torch.from_numpy(case(12, *shape)[2]).to(cuda, torch.bfloat16)
    assert all(K.kernel_design(q, p) == "tensor_core" for p in K.PATHS)
    with torch.no_grad():
        out, m, L = K.criss_cross_attention_cuda(q, k, v)
        delta = (g.float() * out.float()).sum(dim=-1)
        before = dict(K.LAUNCHES)
        grads = []
        for fn, extra in ((K.cca_bwd_col, ()), (K.cca_bwd_row, None)):
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
            grads.append(fn(q, k, v, g, m, L, delta, *(grads[0] if extra is None else extra)))
            # three outputs and no scratch (the CUDA-core pair adds P and DE)
            assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 3
        col, row = grads
        assert K.LAUNCHES == {n: c + (n.startswith(("cca_bwd_col", "cca_bwd_row")))
                              for n, c in before.items()}
        want_col = K.cca_bwd_col_plain(q, k, v, g, m, L, delta)
        want_row = K.cca_bwd_row_plain(q, k, v, g, m, L, delta, *col)
    if shape[1] == 1:  # the column path is all self slot
        assert all(float(c.float().abs().max()) == 0.0 for c in col)
    for got, want in (*zip(col, want_col), *zip(row, want_row)):
        assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale


# bf16 natural-route calls with lines past 128 (B, H, W, Cq, Cv): the forward
# at H = 129 and the model's widths (K1's columns long, K2's rows not; the
# backward takes the line route), narrow widths with lines of 129 to 400
# (natural both ways at 300 x 200 and 300 x 129, the forward alone at 140 x 400)
LONG_NATURAL_SHAPES = [(1, 129, 120, 64, 512), (2, 300, 200, 8, 16), (1, 300, 129, 8, 16),
                       (1, 140, 400, 8, 16)]


@pytest.mark.parametrize("shape", LONG_NATURAL_SHAPES)
def test_long_bf16_natural_lines_run_tensor_core_line_kernels(cuda, shape):
    """K1–K4 on bf16 lines longer than 128 launch K7a's/K7b's tensor-core
    kernels (the CUDA-core K1–K4 only take f32): K1/K2's bf16 outputs
    bit-equal to the rounding plain versions' but for at most 1 % of
    flipped roundings, which the plain version that keeps p in f32 exceeds,
    within 1e-2 x scale, and so are K3/K4's grads where the backward stays
    natural; the routed Function launches the same kernels."""
    q, k, v = (torch.from_numpy(a).to(cuda, torch.bfloat16) for a in case(19, *shape))
    g = torch.from_numpy(case(20, *shape)[2]).to(cuda, torch.bfloat16)
    designs = {p: K.kernel_design(q, p) for p in K.PATHS}
    assert designs == _expected_designs(shape, "bfloat16")
    assert "tensor_core_lines" in designs.values()
    natural = {d: not K.uses_line_route(d, *shape[1:]) for d in K.DIRECTIONS}
    assert natural["fwd"]
    pairs = []
    with torch.no_grad():
        before = dict(K.LAUNCHES)
        col = K.cca_fwd_col(q, k, v)
        row = K.cca_fwd_row(q, k, v, *col)
        assert K.LAUNCHES == {n: c + _want_natural(designs, "fwd", 1).get(n, 0)
                              for n, c in before.items()}
        want_col, want_row = K.cca_fwd_col_plain(q, k, v), K.cca_fwd_row_plain(q, k, v, *col)
        t32 = [t.float() for t in (q, k, v)]
        unrounded = K.cca_fwd_row_plain(*t32, *K.cca_fwd_col_plain(*t32))[0].to(torch.bfloat16)
        assert col[0].dtype == row[0].dtype == torch.bfloat16
        assert max(_flipped(col[0], want_col[0]), _flipped(row[0], want_row[0])) <= 1e-2
        assert _flipped(unrounded, want_row[0]) > 1e-2
        pairs += [*zip(col, want_col), *zip(row, want_row)]
        out, m, L = row
        delta = (g.float() * out.float()).sum(dim=-1)
        if natural["bwd"]:
            before = dict(K.LAUNCHES)
            dcol = K.cca_bwd_col(q, k, v, g, m, L, delta)
            drow = K.cca_bwd_row(q, k, v, g, m, L, delta, *dcol)
            assert K.LAUNCHES == {n: c + _want_natural(designs, "bwd", 1).get(n, 0)
                                  for n, c in before.items()}
            pairs += [*zip(dcol, K.cca_bwd_col_plain(q, k, v, g, m, L, delta)),
                      *zip(drow, K.cca_bwd_row_plain(q, k, v, g, m, L, delta, *dcol))]
    for got, want in pairs:
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.isfinite(got.float()).all()
        scale = max(1.0, want.float().abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= 1e-2 * scale
    before = dict(K.LAUNCHES)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    torch.autograd.grad(K.criss_cross_attention_cuda(*leaves)[0], leaves, g)
    want = _want_natural(designs, "fwd", 1)
    if natural["bwd"]:
        for n, c in _want_natural(designs, "bwd", 1).items():
            want[n] = want.get(n, 0) + c
    else:
        want.update(cca_line_bwd=2, cca_line_bwd_tc=2)
    # every K1–K4 launch counted under a tensor-core design: none on the CUDA cores
    assert K.LAUNCHES == {n: c + want.get(n, 0) for n, c in before.items()}


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
        tc = dtype == "bfloat16"  # every bf16 launch takes the tensor cores
        assert K.LAUNCHES == {n: c + {"cca_line_fwd": 4, "cca_line_bwd": 2, "cca_line_fwd_tc": 4 * tc,
                                      "cca_line_bwd_tc": 2 * tc}.get(n, 0)
                              for n, c in before.items()}
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = K.criss_cross_attention_cuda(*leaves)[0]
    pairs.append((out, plain.criss_cross_attention(*f32[:3])))
    pairs += zip(torch.autograd.grad(out, leaves, g), _plain_grads(*f32))
    for got, want in pairs:
        scale = max(1.0, want.abs().max().item())
        assert (got.float() - want.float()).abs().max().item() <= tol * scale


# the tensor-core K7a/K7b beyond LINE_SHAPES: lines of N = 16, 17, 65, 128
# and 463-465 on either path, Cq 128 (dk's wide register tile), odd widths
TC_LINE_SHAPES = LINE_SHAPES + [(2, 16, 17, 8, 16), (1, 65, 128, 64, 512), (1, 463, 5, 64, 512),
                                (1, 3, 464, 16, 32), (2, 465, 3, 12, 21), (1, 33, 97, 128, 64)]
# shapes small enough that the rounding plain versions and the kernels
# should agree but for a handful of flipped roundings
TC_LINE_SMALL = {(2, 9, 441, 8, 16), (1, 1, 300, 4, 8), (1, 300, 1, 4, 8), (2, 16, 17, 8, 16)}


def _line_views(shape, cuda, seed):
    q, k, v, g = (torch.from_numpy(a).to(cuda, torch.bfloat16)
                  for a in (*case(seed, *shape), case(seed + 1, *shape)[2]))
    return q, k, v, g


@pytest.mark.parametrize("shape", TC_LINE_SHAPES)
def test_tensor_core_line_fwd_matches_rounding_plain(cuda, shape):
    """The tensor-core K7a on both paths vs its plain version on the same
    bf16 tensors, rounding p before p·v and o to bf16 as the kernel and the
    TPU kernel at the default precision do: within 1e-2 x scale, o bit-equal
    but for at most 1 % of flipped roundings (0.1 % at the small shapes),
    which the plain version that keeps p in f32 exceeds."""
    q, k, v, _ = _line_views(shape, cuda, 15)
    assert K.line_design(q) == "tensor_core"
    small = shape in TC_LINE_SMALL
    with torch.no_grad():
        for masked, view in LINE_PATHS:
            before = dict(K.LAUNCHES)
            got = K.cca_line_fwd(view(q), view(k), view(v), masked)
            assert K.LAUNCHES == {n: c + (n in ("cca_line_fwd", "cca_line_fwd_tc"))
                                  for n, c in before.items()}
            o, m, l = K.cca_line_fwd_plain(view(q), view(k), view(v), masked,
                                           round_to=torch.bfloat16)
            unrounded = K.cca_line_fwd_plain(*(view(t).float() for t in (q, k, v)), masked)[0]
            assert got[0].dtype == torch.bfloat16 and got[0].shape == o.shape
            assert _flipped(got[0], o.to(torch.bfloat16)) <= (1e-3 if small else 1e-2)
            if view(q).shape[2] >= 64:  # lines long enough that p's rounding shows in o
                assert _flipped(unrounded.to(torch.bfloat16), o.to(torch.bfloat16)) > 1e-2
            for a, b in zip(got, (o, m, l)):
                scale = max(1.0, b.abs().max().item())
                assert (a.float() - b).abs().max().item() <= (2.0 ** -8 if small else 1e-2) * scale
            if masked and shape[1] == 1:  # all self slot: o = v, m = -1e9, l = 1
                assert torch.equal(got[0], view(v)) and torch.all(got[1] == plain.NEG_INF)
                assert torch.all(got[2] == 1.0)


@pytest.mark.parametrize("shape", TC_LINE_SHAPES)
def test_tensor_core_line_bwd_matches_rounding_plain(cuda, shape):
    """The tensor-core K7b on both paths vs its plain version on the same
    bf16 tensors and joint stats, rounding p and de to bf16 and the grads to
    bf16 as the kernel does: within 1e-2 x scale (2^-8 at the small
    shapes), each launch allocating its three outputs and one f32 scratch
    of dq's parts."""
    q, k, v, g = _line_views(shape, cuda, 17)
    with torch.no_grad():
        out, m, L = K.cca_line_route_fwd(q, k, v)
        delta = (g.float() * out).sum(dim=-1)
        for masked, view in LINE_PATHS:
            args = [view(t) for t in (q, k, v, g, m, L, delta)]
            allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
            got = K.cca_line_bwd(*args, masked)
            assert torch.cuda.memory_stats()["allocation.all.allocated"] - allocs == 4
            want = K.cca_line_bwd_plain(*args, masked, round_to=torch.bfloat16)
            for a, b in zip(got, want):
                assert a.dtype == torch.bfloat16 and a.shape == b.shape
                assert torch.isfinite(a.float()).all()
                scale = max(1.0, b.abs().max().item())
                tol = 2.0 ** -8 if shape in TC_LINE_SMALL else 1e-2
                assert (a.float() - b.to(torch.bfloat16).float()).abs().max().item() <= tol * scale


# B, h, w, C, r: the 769² crops, small shapes, full frame (129 x 257 -> 1025 x
# 2049), ragged column tiles (band_tile: 94 -> 24, 24, 24, 22; 85 -> 43, 42
# at r = 4), and r = 256, whose tile's fine columns outnumber a block's
# threads (ratios of 2^n, where F.interpolate's source index is exact: at r
# = 3 and W = 253 the plain version's (w-1)/(W-1) is not, by 1e-5 in nll)
LOSS_SHAPES = [(8, 97, 97, 19, 8), (2, 5, 7, 4, 3), (1, 9, 9, 6, 4), (2, 129, 257, 19, 8),
               (1, 5, 94, 19, 8), (2, 3, 85, 7, 4), (1, 2, 3, 3, 256)]


def _loss_case(shape, label_dtype, cuda, seed=7, live=1.0):
    """logits, labels (15 % ignore) and g, nonzero on a share ``live`` of the
    pixels as OHEM's g once the model is trained."""
    B, h, w, C, r = shape
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32)).to(cuda)
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.15] = 255
    labels = torch.from_numpy(labels.astype(label_dtype)).to(cuda)
    g = rng.rand(B, H, W).astype(np.float32)
    g[rng.rand(B, H, W) >= live] = 0.0
    return logits, labels, torch.from_numpy(g).to(cuda)


@pytest.mark.parametrize("label_dtype", ["int32", "uint8"])
@pytest.mark.parametrize("shape", LOSS_SHAPES)
def test_loss_kernels_match_plain(cuda, shape, label_dtype):
    logits, labels, g = _loss_case(shape, label_dtype, cuda)
    before = dict(U.LAUNCHES)
    nll = U.upsampled_nll_fwd(logits, labels)
    dl = U.upsampled_nll_bwd(logits, labels, g)
    assert U.LAUNCHES == {n: c + 1 for n, c in before.items()}
    want_nll = U.upsampled_nll_reference(logits, labels)
    want_dl = U.upsampled_nll_bwd_plain(logits, labels, g)
    assert (nll - want_nll).abs().max().item() <= 1e-5
    assert (dl - want_dl).abs().max().item() <= 1e-4 * want_dl.abs().max().item()


@pytest.mark.parametrize("live", [0.02, 0.0])
def test_loss_bwd_kernel_on_sparse_g(cuda, live):
    """K6 skips the pixels with g == 0: g nonzero on 2 % of the pixels gives
    the plain version's gradient, and a g that is zero everywhere a
    gradient of exact zeros."""
    logits, labels, g = _loss_case(LOSS_SHAPES[0], "int32", cuda, seed=9, live=live)
    dl = U.upsampled_nll_bwd(logits, labels, g)
    if live == 0.0:
        assert float(dl.abs().max()) == 0.0
        return
    want = U.upsampled_nll_bwd_plain(logits, labels, g)
    assert (dl - want).abs().max().item() <= 1e-4 * want.abs().max().item()


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
# ragged edges, and the model's (K1's column logits, the column-major copy of v).
# The dot's paths: one line of one pixel, the scalar staging (C % 8 != 0),
# bands of 16-row tiles, several bands per line past 64 tiles (H = 231),
# three channel chunks (64, 64, 8), two passes of keys (H = 600), whole lines
# with several items per block (P4 at the model's shape; with two channel
# chunks, staged by cp.async and by scalars)
PROBE_DOT_SHAPES = [(96, 16, 64), (7, 3, 70), (1, 1, 8), (231, 2, 64), (97, 97, 136),
                    (97, 97, 64), (600, 1, 64)]                    # (H, T, C)
PROBE_DOT4_SHAPES = [(2, 96, 33, 64), (8, 97, 97, 64), (1, 33, 5, 8), (4, 97, 97, 72),
                     (3, 97, 97, 70)]                              # (B, H, W, C)
# rows of one 16-byte chunk (C = 8) over a large A x B
PROBE_SWAP_SHAPES = [(96, 16, 128), (9, 13, 8), (1031, 517, 8)]     # (A, B, C)
# B = 8 with a ragged W, as in the model's batch
PROBE_STORE_SHAPES = [(2, 96, 33, 512), (8, 97, 97, 512), (1, 9, 17, 8), (8, 97, 33, 512)]
# n = 1, 3, 5 (no float4 body) and 4k + 3 (a tail of 3)
PROBE_SCALE_SHAPES = [(97, 256), (1, 1), (3, 1000), (1, 3), (5, 1), (7, 573)]


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


@pytest.mark.parametrize("shape", [(97, 97, 64), (9, 4, 16)])
def test_probe_mid_batch_dot_at_unaligned_base(cuda, shape):
    """q and k starting 2 bytes past a 16-byte boundary: the scalar staging."""
    from ccnet_tpu_torch.ops import probes as P

    n = shape[0] * shape[1] * shape[2]
    q, k = (_probe_in(seed, (n + 8,), cuda)[1:n + 1].view(shape) for seed in (17, 18))
    assert q.is_contiguous() and q.data_ptr() % 16 == 2
    assert P.dot_plan(1, shape[1], shape[0], shape[2], (0, shape[1] * shape[2], shape[2]),
                      aligned=False).vec == 0
    before = P.LAUNCHES["mid_batch_dot"]
    got = P.mid_batch_dot(q, k)
    assert P.LAUNCHES["mid_batch_dot"] == before + 1
    _dot_close(got, P.mid_batch_dot_plain(q, k))


def test_device_prefetch_pinned_copies_equal_plain_copies(cuda):
    """Six batches of changing content through ``device_prefetch`` with
    pinned buffers on a side stream (three in rotation per shape): each
    placed batch equals its plain ``.to("cuda")`` copy, also after the
    consumer's stream has worked on it and later copies reused the buffers."""
    from ccnet_tpu_torch.data.loader import HostToDevice, device_prefetch

    rng = np.random.RandomState(21)
    batches = [(rng.randint(0, 256, (2, 257, 385, 3)).astype(np.uint8),
                rng.randn(2, 257, 385).astype(np.float32), [f"batch_{i}"]) for i in range(6)]
    copier = HostToDevice(cuda, depth=2)
    got = []
    for transfer, names in device_prefetch(iter(batches), lambda a, b: (copier(a, b),), depth=2):
        images, labels = transfer.wait()
        got.append((names, images, labels, images.float().sum(), (labels * 2).sum()))
    torch.cuda.synchronize()
    assert [g[0] for g in got] == [b[2] for b in batches]
    for (_, images, labels, isum, lsum), (wi, wl, _) in zip(got, batches):
        want_i, want_l = torch.from_numpy(wi).to("cuda"), torch.from_numpy(wl).to("cuda")
        assert images.device.type == "cuda" and torch.equal(images, want_i)
        assert torch.equal(labels, want_l)
        assert isum.item() == want_i.float().sum().item()
        assert lsum.item() == (want_l * 2).sum().item()


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


@pytest.mark.parametrize("offset", [1, 2, 3])
@pytest.mark.parametrize("shape", [(97, 256), (1, 7), (3, 5)])
def test_probe_scale_at_unaligned_offset(cuda, offset, shape):
    """A contiguous slice starting 4, 8 or 12 bytes past a 16-byte boundary:
    the scalar head runs up to the boundary, and the output is split alike."""
    from ccnet_tpu_torch.ops import probes as P

    n = shape[0] * shape[1]
    x = _probe_in(16, (n + 4,), cuda, torch.float32)[offset:offset + n].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4 * offset
    before = P.LAUNCHES["scale_ragged"]
    got = P.scale_ragged(x)
    assert P.LAUNCHES["scale_ragged"] == before + 1
    assert got.shape == x.shape and torch.equal(got, P.scale_ragged_plain(x))


# the VOC recipe's loss: 21 classes at 41x41 -> 321x321 (r = 8), the first
# class count past 20 (the kernels' class bound 32), and C = 32 itself
VOC_LOSS_SHAPES = [(8, 41, 41, 21, 8), (2, 5, 7, 21, 3), (1, 9, 9, 32, 4)]


@pytest.mark.parametrize("label_dtype", ["int32", "uint8"])
@pytest.mark.parametrize("shape", VOC_LOSS_SHAPES)
def test_voc_loss_kernels_match_plain(cuda, shape, label_dtype):
    logits, labels, g = _loss_case(shape, label_dtype, cuda, seed=21)
    before = dict(U.LAUNCHES)
    nll = U.upsampled_nll_fwd(logits, labels)
    dl = U.upsampled_nll_bwd(logits, labels, g)
    assert U.LAUNCHES == {n: c + 1 for n, c in before.items()}
    want_nll = U.upsampled_nll_reference(logits, labels)
    want_dl = U.upsampled_nll_bwd_plain(logits, labels, g)
    assert (nll - want_nll).abs().max().item() <= 1e-5
    assert (dl - want_dl).abs().max().item() <= 1e-4 * want_dl.abs().max().item()


def test_grey_png_round_trip_of_card_predictions(cuda, tmp_path):
    """labelIds of an argmax computed on the card, written as a greyscale
    PNG, read back equal."""
    from ccnet_tpu_torch.data import trainid_to_labelid
    from ccnet_tpu_torch.data.palette import read_png, save_grey_png

    torch.manual_seed(0)
    logits = torch.randn(1, 19, 97, 129, device=cuda)
    pred = logits.argmax(1)[0].to(torch.uint8).cpu().numpy()
    path = str(tmp_path / "pred.png")
    save_grey_png(path, trainid_to_labelid(pred))
    np.testing.assert_array_equal(read_png(path, 0)[0], trainid_to_labelid(pred))
