"""Port's criss-cross attention vs the JAX package's.

* the plain-torch op vs ``ccnet_tpu.ops.cc_attention.criss_cross_attention``;
* the kernel wrappers' CPU route (the plain versions of K1/K2) vs the TPU
  kernels run in interpret mode (``_fwd_impl_natural``, the bare
  single-device path; ``partitioned`` stays off as in
  ``tests/test_pallas_cca.py``), out and the joint (m, L) residuals, at the
  'highest' precision and, in bf16, at the default one (p rounded to bf16
  before p·v and o_col written in bf16, as the TPU kernels do; without
  those roundings the bf16 out misses the bound);
* the backward: the plain versions of K3/K4 chained vs ``_bwd_natural`` in
  interpret mode on the same (q, k, v, g, m, L, delta), in f32 at the
  'highest' precision and in bf16 at the default one (p and de rounded to
  bf16 as the TPU kernels' MXU operands), and the grads of
  ``CrissCrossAttentionFn`` (CPU route) vs ``jax.grad`` of the Pallas op;
* the CUDA kernels themselves are held against the plain versions on the
  card by ``tests/test_torch_kernels_gpu.py``.

Shapes are those of ``tests/test_pallas_cca.py``, including H=1 (column path
fully masked) and W=1.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccnet_tpu.ops.cc_attention import criss_cross_attention as cca_jax
from ccnet_tpu.ops.cc_attention_pallas import (
    _bwd_natural,
    _fwd_impl_natural,
    criss_cross_attention_pallas,
)

from ccnet_tpu_torch.ops import cc_attention as port
from ccnet_tpu_torch.ops import cc_attention_cuda as K
from ccnet_tpu_torch.ops.cc_attention import NEG_INF

SHAPES = [
    (1, 5, 6, 4, 8),     # tiny, W not divisible by tile
    (2, 9, 8, 8, 16),    # H != W
    (1, 97, 97, 16, 32), # real aspect (small channels for CPU speed)
    (1, 1, 7, 4, 8),     # H=1: column path fully masked
    (1, 7, 1, 4, 8),     # W=1
]
ATOL = {"float32": 2e-5, "bfloat16": 0.05}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def case(seed, B, H, W, Cq, Cv):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, Cq).astype(np.float32),
            rng.randn(B, H, W, Cq).astype(np.float32),
            rng.randn(B, H, W, Cv).astype(np.float32))


def both(arrays, dtype):
    """The same arrays as jax and torch inputs of ``dtype``."""
    jx = [jnp.asarray(a).astype(dtype) for a in arrays]
    tt = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    return jx, tt


def f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_plain_cca_matches_jax(shape, dtype):
    (jq, jk, jv), (tq, tk, tv) = both(case(0, *shape), dtype)
    want = f32(cca_jax(jq, jk, jv))
    got = f32(port.criss_cross_attention(tq, tk, tv))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_kernel_cpu_route_matches_pallas_interpret(shape, dtype):
    """(out, m, L) of the wrapper's CPU route vs the TPU kernels K1+K2 in
    interpret mode at 'highest' precision. m and L are f32 sums of the same
    f32 logits in both: held at 2e-5 relative."""
    (jq, jk, jv), (tq, tk, tv) = both(case(1, *shape), dtype)
    want_out, want_m, want_L = _fwd_impl_natural(jq, jk, jv, True, "highest")
    before = dict(K.LAUNCHES)
    out, m, L = K.criss_cross_attention_cuda(tq, tk, tv)
    assert K.LAUNCHES == before  # the CPU route launches nothing
    assert out.dtype == tv.dtype
    np.testing.assert_allclose(f32(out), f32(want_out), atol=ATOL[dtype])
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(L.numpy(), np.asarray(want_L), rtol=2e-5, atol=2e-5)


def _matches_tpu_default(shape, out, want) -> bool:
    """Whether a bf16 ``out`` is what the TPU kernels compute at the default
    precision (``want``): bit-equal at the four small SHAPES; at 97 x 97, at
    most 0.1 % of the elements apart (an f32 sum taken in another order flips
    a rounding) and by at most 2^-9 x scale. Measured with ``case(1, ...)``:
    rounding p and o_col where the TPU kernels do, 0 flips at the small
    shapes and 6.0e-5 of the elements, 1.9e-3 x scale at 97 x 97; keeping p
    in f32, 27-36 % of the elements and 1.3e-3-3.9e-3 x scale."""
    a, b = f32(out), f32(want)
    err = np.abs(a - b).max() / max(1.0, np.abs(b).max())
    if shape != (1, 97, 97, 16, 32):
        return bool(err <= 1e-6)
    return bool(np.mean(a != b) <= 1e-3 and err <= 2.0 ** -9)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_kernel_cpu_route_matches_pallas_default_precision(shape):
    """The wrappers' bf16 CPU route K1 then K2 (their plain versions, p
    rounded to bf16 before each p·v, o_col in bf16) vs the TPU kernels K1+K2
    in interpret mode at the default precision, on the same bf16 inputs:
    both round p, o_col and out at the same places and sum in f32, so out
    agrees as :func:`_matches_tpu_default` says; m and L are f32 reductions
    of the same f32 logits: 2e-5 relative."""
    (jq, jk, jv), (tq, tk, tv) = both(case(1, *shape), "bfloat16")
    want_out, want_m, want_L = _fwd_impl_natural(jq, jk, jv, True, "default")
    before = dict(K.LAUNCHES)
    col = K.cca_fwd_col(tq, tk, tv)
    out, m, L = K.cca_fwd_row(tq, tk, tv, *col)
    assert K.LAUNCHES == before  # the CPU route launches nothing
    assert col[0].dtype == torch.bfloat16 and col[0].shape == tv.shape  # as _fwd_col_kernel
    assert col[1].dtype == col[2].dtype == torch.float32
    assert out.dtype == torch.bfloat16 and want_out.dtype == jnp.bfloat16
    assert _matches_tpu_default(shape, out, want_out)
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(L.numpy(), np.asarray(want_L), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_unrounded_fwd_misses_pallas_default_precision(shape):
    """The plain versions fed f32 copies of the same bf16 inputs keep p and
    o_col in f32: their out, rounded to bf16, is not what the TPU kernels
    compute at the default precision, so the bound of the test above tells
    the two apart."""
    (jq, jk, jv), (tq, tk, tv) = both(case(1, *shape), "bfloat16")
    want_out = _fwd_impl_natural(jq, jk, jv, True, "default")[0]
    t32 = [t.float() for t in (tq, tk, tv)]
    out = K.cca_fwd_row_plain(*t32, *K.cca_fwd_col_plain(*t32))[0].to(torch.bfloat16)
    assert not _matches_tpu_default(shape, out, want_out)


def test_bf16_column_path_at_h1_is_the_self_slot():
    """H = 1: the column path is all self slot, so K1's CPU route gives
    m_col = −1e9, l_col = 1 and o_col = v (p = 1 exactly), and K2's combine
    weighs it by exp(−1e9 − m) = 0: out is finite, the row path alone."""
    _, (tq, tk, tv) = both(case(9, 2, 1, 7, 4, 8), "bfloat16")
    o_col, m_col, l_col = K.cca_fwd_col(tq, tk, tv)
    assert torch.all(m_col == NEG_INF) and torch.all(l_col == 1.0)
    assert torch.equal(o_col, tv)
    out, m, L = K.cca_fwd_row(tq, tk, tv, o_col, m_col, l_col)
    assert torch.isfinite(out.float()).all() and torch.isfinite(m).all()
    row = K.cca_line_fwd_plain(tq, tk, tv, masked=False, round_to=torch.bfloat16)
    np.testing.assert_allclose(f32(out), f32((row[0] / row[2][..., None]).to(torch.bfloat16)))
    np.testing.assert_array_equal(m.numpy(), row[1].numpy())


def test_kernel_design_routes_by_dtype_and_line_length():
    """Each of K1–K4 picks its design from its own line (H for K1/K3, W for
    K2/K4): bf16 lines of at most LONG_LINE the one-block-per-line tensor
    cores, longer bf16 lines the tensor-core line kernels (the same
    rounding function), f32 the CUDA-core kernels; a forced K1/K2 design is
    checked on every route, and each design's o_col is in v's dtype."""
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt)  # noqa: E731
    for path in K.PATHS:
        assert K.kernel_design(z(8, 97, 97, 64), path) == "tensor_core"
        assert K.kernel_design(z(1, 128, 128, 4), path) == "tensor_core"
        assert K.kernel_design(z(8, 97, 97, 64, dt=torch.float32), path) == "cuda_core"
        assert K.kernel_design(z(1, 129, 257, 64), path) == "tensor_core_lines"
        assert K.kernel_design(z(1, 400, 400, 4, dt=torch.float32), path) == "cuda_core"
    # the forward at H = 129 and the model's widths: K1's columns are long, K2's rows are not
    assert K.kernel_design(z(1, 129, 120, 64), "col") == "tensor_core_lines"
    assert K.kernel_design(z(1, 129, 120, 64), "row") == "tensor_core"
    assert K.kernel_design(z(1, 7, 129, 64), "col") == "tensor_core"
    assert K.kernel_design(z(1, 7, 129, 64), "row") == "tensor_core_lines"
    with pytest.raises(ValueError):
        K.kernel_design(z(1, 7, 129, 64), "both")
    t32 = [z(1, 5, 6, 4, dt=torch.float32), z(1, 5, 6, 4, dt=torch.float32),
           z(1, 5, 6, 8, dt=torch.float32)]
    col = K.cca_fwd_col(*t32, design="cuda_core")
    assert col[0].dtype == torch.float32
    assert K.cca_fwd_row(*t32, *col, design="cuda_core")[0].dtype == torch.float32
    with pytest.raises(ValueError):  # f32 has no tensor-core design
        K.cca_fwd_col(*t32, design="tensor_core")
    with pytest.raises(ValueError):
        K.cca_fwd_row(*t32, *col, design="tensor_core")
    with pytest.raises(ValueError):
        K.cca_fwd_col(*t32, design="wgmma")
    t16 = [t.to(torch.bfloat16) for t in t32]
    col = K.cca_fwd_col(*t16, design="tensor_core")
    assert col[0].dtype == torch.bfloat16
    with pytest.raises(ValueError):  # K2 takes o_col in v's dtype, not f32
        K.cca_fwd_row(*t16, col[0].float(), *col[1:])
    with pytest.raises(ValueError):  # a bf16 line past LONG_LINE has no one-block design
        K.cca_fwd_col(*(z(1, 129, 2, c) for c in (4, 4, 8)), design="tensor_core")
    with pytest.raises(ValueError):  # ... and a short one no line-kernel design
        K.cca_fwd_row(*t16, *col, design="tensor_core_lines")
    t_long = [z(1, 129, 2, c) for c in (4, 4, 8)]  # the CPU route of the line design
    col = K.cca_fwd_col(*t_long, design="tensor_core_lines")
    assert col[0].dtype == torch.bfloat16
    assert K.cca_fwd_row(*t_long, *col)[0].dtype == torch.bfloat16


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_kernel_versions_match_joint_stats(shape):
    """K1's and K2's plain versions chained == the one-softmax oracle."""
    tq, tk, tv = (torch.from_numpy(a) for a in case(2, *shape))
    out, m, L = K.cca_fwd_row_plain(tq, tk, tv, *K.cca_fwd_col_plain(tq, tk, tv))
    want_out, want_m, want_L = port.criss_cross_attention_stats(tq, tk, tv)
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=2e-5)
    np.testing.assert_allclose(m.numpy(), want_m.numpy(), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(L.numpy(), want_L.numpy(), rtol=2e-5, atol=2e-5)
    assert np.isfinite(out.numpy()).all()


def test_wrapper_refuses_grad_and_bad_inputs():
    """Grad now flows (K3/K4 exist); bad dtypes and shapes still raise,
    in the forward and in the backward wrappers."""
    tq, tk, tv = (torch.from_numpy(a) for a in case(3, 1, 5, 6, 4, 8))
    out = K.criss_cross_attention_cuda(tq.requires_grad_(True), tk, tv)[0]
    assert out.grad_fn is not None
    (dq,) = torch.autograd.grad(out.sum(), tq)
    assert dq.shape == tq.shape and torch.isfinite(dq).all()
    with pytest.raises(TypeError):
        K.criss_cross_attention_cuda(tq.detach().half(), tk.half(), tv.half())
    with pytest.raises(ValueError):
        K.criss_cross_attention_cuda(tq.detach(), tk[:, :4], tv)
    stats = torch.zeros(1, 5, 6)
    with pytest.raises(ValueError):  # g must have v's shape and dtype
        K.cca_bwd_col(tq.detach(), tk, tv, tv[..., :4], stats, stats + 1, stats)
    with pytest.raises(ValueError):
        K.cca_bwd_col(tq.detach(), tk, tv, tv.double(), stats, stats + 1, stats)
    with pytest.raises(ValueError):  # K4's column grads are in the input dtype
        K.cca_bwd_row(tq.detach(), tk, tv, tv, stats, stats + 1, stats,
                      tq.detach().double(), tk, tv)


def _bwd_case(shape, seed):
    q, k, v = case(seed, *shape)
    g = np.random.RandomState(seed + 100).randn(*v.shape).astype(np.float32)
    return q, k, v, g


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_backward_matches_pallas_bwd_natural(shape):
    """The wrappers' CPU route of K3 then K4 (their plain versions) vs the
    TPU kernels K3+K4 in interpret mode at 'highest' precision, on the same
    f32 (q, k, v, g) and the same joint stats and delta: atol 3e-5, plus
    rtol 2e-5 for the grads of magnitude ~10 at 97 x 97, whose 97-term f32
    sums are taken in another order."""
    q, k, v, g = _bwd_case(shape, 5)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, m, L = _fwd_impl_natural(jq, jk, jv, True, "highest")
    delta = jnp.sum(jg * out.astype(jnp.float32), axis=-1)
    want = _bwd_natural(jq, jk, jv, jg, m, L, delta, True, "highest")
    t = [torch.from_numpy(np.array(a)) for a in (q, k, v, g, m, L, delta)]
    before = dict(K.LAUNCHES)
    col = K.cca_bwd_col(*t)
    got = K.cca_bwd_row(*t, *col)
    assert K.LAUNCHES == before  # the CPU route launches nothing
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=3e-5, rtol=2e-5,
                                   err_msg=name)
    if shape[1] == 1:  # H=1: the column path is all self slot, every column grad is 0
        assert all(float(c.abs().max()) == 0.0 for c in col)


def _bf16_bwd_inputs(shape, seed):
    """bf16 (q, k, v, g) as jax and torch arrays, with the joint stats of
    the TPU forward under the default precision and ``delta = Σ out·g``."""
    jq, jk, jv, jg = (jnp.asarray(a).astype(jnp.bfloat16) for a in _bwd_case(shape, seed))
    out, m, L = _fwd_impl_natural(jq, jk, jv, True, "default")
    delta = jnp.sum(jg.astype(jnp.float32) * out.astype(jnp.float32), axis=-1)
    jx = (jq, jk, jv, jg, m, L, delta)
    tt = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(torch.bfloat16)
          for a in jx[:4]] + [torch.from_numpy(np.array(a)) for a in jx[4:]]
    return jx, tt


@pytest.mark.parametrize("shape", SHAPES)
def test_bf16_plain_backward_matches_pallas_default_precision(shape):
    """The wrappers' bf16 CPU route of K3 then K4 (their plain versions,
    rounding p and de to bf16 before the products that consume them) vs
    the TPU kernels K3+K4 in interpret mode at the default precision, on
    the same bf16 (q, k, v, g) and stats. Both round p, de, the column
    grads and the final grads at the same places and sum in f32, so they
    agree to one bf16 step (2^-8) of the grads' scale: a 97-term f32 sum
    taken in another order can flip one rounding (measured: 7.2e-4 x
    scale at most). The f32 arithmetic without those roundings misses this
    bound at two of the shapes (4.6e-3 x scale)."""
    jx, t = _bf16_bwd_inputs(shape, 7)
    want = _bwd_natural(*jx, True, "default")
    before = dict(K.LAUNCHES)
    col = K.cca_bwd_col(*t)
    got = K.cca_bwd_row(*t, *col)
    assert K.LAUNCHES == before  # the CPU route launches nothing
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        a, b = f32(a), f32(b)
        assert np.abs(a - b).max() <= 2.0 ** -8 * max(1.0, np.abs(b).max()), name
    assert all(c.dtype == torch.bfloat16 for c in col)  # as _bwd_natural writes them


def test_bf16_column_grads_vanish_at_h1():
    """H = 1: the column path is all self slot, so p = 0 and every bf16
    column grad of K3's CPU route is exactly 0, as in the TPU kernel."""
    _, t = _bf16_bwd_inputs((1, 1, 7, 4, 8), 8)
    col = K.cca_bwd_col(*t)
    assert all(c.dtype == torch.bfloat16 and float(c.float().abs().max()) == 0.0 for c in col)
    assert all(float(r.float().abs().max()) > 0.0 for r in K.cca_bwd_row(*t, *col))


def test_bwd_design_routes_by_dtype_and_line_length():
    """K3/K4 take their design by the same rule as K1/K2, each from its own
    line: the one-block tensor-core design for bf16 lines of at most
    LONG_LINE, the tensor-core line kernels for longer bf16 lines, the
    CUDA-core pair for f32; a forced design is checked on every route."""
    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, dtype=dt)  # noqa: E731
    t16 = [z(1, 5, 6, 4), z(1, 5, 6, 4), z(1, 5, 6, 8), z(1, 5, 6, 8), z(1, 5, 6, dt=torch.float32),
           z(1, 5, 6, dt=torch.float32) + 1, z(1, 5, 6, dt=torch.float32)]
    assert K.kernel_design(t16[0], "col") == "tensor_core"
    assert all(c.dtype == torch.bfloat16 for c in K.cca_bwd_col(*t16, design="tensor_core"))
    assert K.kernel_design(z(1, 128, 128, 4), "row") == "tensor_core"
    assert K.kernel_design(z(1, 129, 1, 4), "col") == "tensor_core_lines"
    assert K.kernel_design(z(1, 129, 1, 4), "row") == "tensor_core"
    with pytest.raises(ValueError):  # lines of 5 and 6 take the one-block design
        K.cca_bwd_col(*t16, design="tensor_core_lines")
    t = [z(1, 5, 6, 4, dt=torch.float32), z(1, 5, 6, 4, dt=torch.float32),
         z(1, 5, 6, 8, dt=torch.float32), z(1, 5, 6, 8, dt=torch.float32),
         z(1, 5, 6, dt=torch.float32), z(1, 5, 6, dt=torch.float32) + 1,
         z(1, 5, 6, dt=torch.float32)]
    assert all(c.dtype == torch.float32 for c in K.cca_bwd_col(*t, design="cuda_core"))
    with pytest.raises(ValueError):  # f32 has no tensor-core design
        K.cca_bwd_col(*t, design="tensor_core")
    with pytest.raises(ValueError):
        K.cca_bwd_row(*t, *t[:3], design="wgmma")


BF16_GRAD_SHAPES = [(1, 5, 6, 4, 8), (2, 9, 8, 8, 16), (1, 1, 7, 4, 8), (1, 7, 1, 4, 8)]


@pytest.mark.parametrize("dtype,shape", [("float32", s) for s in SHAPES]
                         + [("bfloat16", s) for s in BF16_GRAD_SHAPES])
def test_function_grads_match_pallas_vjp(shape, dtype):
    """Grads of CrissCrossAttentionFn (CPU route: the four plain versions)
    vs jax.grad of the Pallas op (interpret, 'highest', partitioned=False).
    f32 at atol 3e-5; bf16 inputs at 0.05 x max|grad| (both round the
    output and the grads to bf16; the port's delta uses the bf16 output,
    the JAX op's the f32 one)."""
    q, k, v, g = _bwd_case(shape, 6)
    jx = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    jg = jnp.asarray(g)

    def f(q_, k_, v_):
        out = criss_cross_attention_pallas(q_, k_, v_, interpret=True, precision="highest",
                                           partitioned=False)
        return jnp.vdot(out.astype(jnp.float32), jg)

    want = jax.grad(f, argnums=(0, 1, 2))(*jx)
    leaves = [torch.from_numpy(a).to(getattr(torch, dtype)).requires_grad_(True)
              for a in (q, k, v)]
    out = K.criss_cross_attention_cuda(*leaves)[0]
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(out.dtype))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == leaves[0].dtype
        a, b = f32(a), f32(b)
        if dtype == "float32":
            np.testing.assert_allclose(a, b, atol=3e-5, err_msg=name)
        else:
            assert np.abs(a - b).max() <= 0.05 * max(1.0, np.abs(b).max()), name


def test_cuda_module_imports_without_nvcc():
    """Importing the kernel module builds nothing and needs no nvcc."""
    code = ("import ccnet_tpu_torch.ops.cc_attention_cuda as K, ccnet_tpu_torch.ops._build as b;"
            "import ccnet_tpu_torch.ops.upsampled_ce as U, ccnet_tpu_torch.train.trainer;"
            "assert b._LIBS == {} and set(K.LAUNCHES) == {'cca_fwd_col', 'cca_fwd_row', "
            "'cca_fwd_col_tc', 'cca_fwd_row_tc', "
            "'cca_bwd_col', 'cca_bwd_row', 'cca_bwd_col_tc', 'cca_bwd_row_tc', "
            "'cca_line_fwd', 'cca_line_bwd', 'cca_line_fwd_tc', 'cca_line_bwd_tc'} "
            "and not any(K.LAUNCHES.values());"
            "assert U.LAUNCHES == {'upsampled_nll_fwd': 0, 'upsampled_nll_bwd': 0}")
    env = {k: v for k, v in os.environ.items() if k not in ("CUDA_HOME", "CUDA_PATH")}
    env["PATH"] = os.path.dirname(sys.executable)  # no nvcc on it
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


def test_port_never_imports_jax():
    code = ("import importlib, pkgutil, sys, ccnet_tpu_torch\n"
            "for m in pkgutil.walk_packages(ccnet_tpu_torch.__path__, 'ccnet_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ccnet_tpu.')))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)


# the drivers that run the port on the card, and the reference replica they read
# its checkpoints with: no import statement names jax or ccnet_tpu, and loading
# the file as ``python FILE`` would pulls in neither
DRIVERS = ("scripts/e2e_synthetic_torch.py", "scripts/remat_scale_torch.py",
           "scripts/probe_whole_batch_torch.py", "scripts/make_lists_torch.py",
           "tests/_torch_reference_replica.py")


@pytest.mark.parametrize("path", DRIVERS)
def test_port_drivers_never_import_jax(path):
    names = []
    for node in ast.walk(ast.parse(open(os.path.join(REPO, path)).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    bad = [n for n in names if n.split(".")[0] in ("jax", "ccnet_tpu")]
    assert not bad, bad
    code = ("import importlib.util, sys\n"
            f"spec = importlib.util.spec_from_file_location('driver', {path!r})\n"
            "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'ccnet_tpu'))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
