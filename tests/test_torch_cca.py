"""Port's criss-cross attention vs the JAX package's.

* the plain-torch op vs ``ccnet_tpu.ops.cc_attention.criss_cross_attention``;
* the kernel wrappers' CPU route (the plain versions of K1/K2) vs the TPU
  kernels run in interpret mode (``_fwd_impl_natural``, the bare
  single-device path; ``partitioned`` stays off as in
  ``tests/test_pallas_cca.py``), out and the joint (m, L) residuals;
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

import jax.numpy as jnp

from ccnet_tpu.ops.cc_attention import criss_cross_attention as cca_jax
from ccnet_tpu.ops.cc_attention_pallas import _fwd_impl_natural

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
    tq, tk, tv = (torch.from_numpy(a) for a in case(3, 1, 5, 6, 4, 8))
    with pytest.raises(NotImplementedError, match="K3"):
        K.criss_cross_attention_cuda(tq.requires_grad_(True), tk, tv)
    with torch.no_grad():  # forward-only is fine without grad
        K.criss_cross_attention_cuda(tq, tk, tv)
    with pytest.raises(TypeError):
        K.criss_cross_attention_cuda(tq.detach().half(), tk.half(), tv.half())
    with pytest.raises(ValueError):
        K.criss_cross_attention_cuda(tq.detach(), tk[:, :4], tv)


def test_cuda_module_imports_without_nvcc():
    """Importing the kernel module builds nothing and needs no nvcc."""
    code = ("import ccnet_tpu_torch.ops.cc_attention_cuda as K, ccnet_tpu_torch.ops._build as b;"
            "assert b._LIBS == {} and K.LAUNCHES == {'cca_fwd_col': 0, 'cca_fwd_row': 0}")
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
