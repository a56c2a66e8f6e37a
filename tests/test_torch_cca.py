"""Port's criss-cross attention vs the JAX package's.

* the plain-torch op vs ``ccnet_tpu.ops.cc_attention.criss_cross_attention``;
* the kernel wrappers' CPU route (the plain versions of K1/K2) vs the TPU
  kernels run in interpret mode (``_fwd_impl_natural``, the bare
  single-device path; ``partitioned`` stays off as in
  ``tests/test_pallas_cca.py``), out and the joint (m, L) residuals;
* the backward: the plain versions of K3/K4 chained vs ``_bwd_natural`` in
  interpret mode on the same (q, k, v, g, m, L, delta), and the grads of
  ``CrissCrossAttentionFn`` (CPU route) vs ``jax.grad`` of the Pallas op;
* the CUDA kernels themselves are held against the plain versions on the
  card by ``tests/test_torch_kernels_gpu.py``.

Shapes are those of ``tests/test_pallas_cca.py``, including H=1 (column path
fully masked) and W=1.
"""

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
    with pytest.raises(ValueError):  # K4's column grads are f32
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
            "'cca_bwd_col', 'cca_bwd_row'} and not any(K.LAUNCHES.values());"
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
