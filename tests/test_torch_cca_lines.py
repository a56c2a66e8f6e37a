"""The port's line route of criss-cross attention (K7a/K7b) vs the JAX
package's legacy route, on the CPU.

* the plain versions of K7a/K7b (``cca_line_fwd_plain`` /
  ``cca_line_bwd_plain``, which the wrappers take on CPU tensors) vs the TPU
  kernels ``_legacy_run_path_fwd`` / ``_legacy_run_path_bwd`` run in
  interpret mode with f32 MXU operands, masked and unmasked, including the
  T < 8 ``stats4`` branch (N = 441), M not a multiple of the tile (M = 5)
  and N = 1 masked (m = −1e9 and l = 1 exactly);
* the line-route glue (``cca_line_route_fwd`` / ``_bwd``) vs
  ``_legacy_fwd_impl`` / ``_legacy_bwd_both_paths`` (interpret, 'highest');
* the routed op ``criss_cross_attention_cuda`` on CPU tensors vs the Pallas
  op (interpret, 'highest', ``partitioned=False``: the partitioned
  wrapper's interpret body is the jnp oracle), forward and ``jax.grad``, at
  a shape both packages send down the line route;
* ``uses_line_route`` at the model's feature shapes (the bf16 rounding of
  the route and the predicate against the JAX package's own decision are
  in ``tests/test_torch_line_rounding.py``).

Tolerances (f32): atol 2e-5 forward and 5e-5 grads, each with rtol 2e-5
for the sums over up to 441 terms (``l``, ``L`` and the aggregates reach
~10²), which the two packages take in other orders. The CUDA kernels are
held against the plain versions on the card by
``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccnet_tpu.ops.cc_attention_pallas import (
    _legacy_bwd_both_paths,
    _legacy_fwd_impl,
    _legacy_run_path_bwd,
    _legacy_run_path_fwd,
    criss_cross_attention_pallas,
)

from ccnet_tpu_torch.ops import cc_attention_cuda as K

FWD_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=5e-5, rtol=2e-5)

# (B, M, N, Cq, Cv): lines of one path
LINE_SHAPES = [
    (1, 3, 441, 4, 8),   # _legacy_pick_tile gives T = 4 < 8: the stats4 branch
    (2, 5, 37, 8, 16),   # T = 16 > M = 5: the padded (ragged) grid
    (1, 4, 1, 4, 8),     # N = 1
]
# (B, H, W, Cq, Cv): NHWC features through both paths
ROUTE_SHAPES = [(1, 3, 441, 4, 8), (2, 5, 37, 8, 16), (1, 1, 300, 4, 8), (1, 300, 1, 4, 8)]


def arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


def torch_of(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def check(got, want, tol, what):
    for name, a, b in zip(("0", "1", "2"), got, want):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=f"{what} {name}", **tol)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", LINE_SHAPES)
def test_line_fwd_plain_matches_legacy_run_path_fwd(shape, masked):
    B, M, N, Cq, Cv = shape
    q, k, v = arrays(sum(shape), (B, M, N, Cq), (B, M, N, Cq), (B, M, N, Cv))
    want = _legacy_run_path_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), masked, True,
                                jnp.float32)
    before = dict(K.LAUNCHES)
    got = K.cca_line_fwd(*torch_of(q, k, v), masked=masked)
    assert K.LAUNCHES == before  # the CPU route launches nothing
    check(got, want, FWD_TOL, "o, m, l")
    if N == 1 and masked:  # all self slot: the stats are exact
        assert (got[1] == -1e9).all() and (got[2] == 1.0).all()


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("shape", LINE_SHAPES)
def test_line_bwd_plain_matches_legacy_run_path_bwd(shape, masked):
    """From stats shaped like the joint ones: this path's m raised by a
    random margin (the other path's share) and L above this path's l."""
    B, M, N, Cq, Cv = shape
    q, k, v, g = arrays(sum(shape) + 1, (B, M, N, Cq), (B, M, N, Cq), (B, M, N, Cv),
                        (B, M, N, Cv))
    _, m, l = _legacy_run_path_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), masked, True,
                                   jnp.float32)
    rng = np.random.RandomState(sum(shape) + 2)
    m = np.asarray(m) + rng.rand(B, M, N).astype(np.float32)
    L = np.asarray(l) + rng.rand(B, M, N).astype(np.float32) + 0.5
    delta = rng.randn(B, M, N).astype(np.float32)
    want = _legacy_run_path_bwd(*(jnp.asarray(a) for a in (q, k, v, g, m, L, delta)), masked,
                                True, jnp.float32)
    got = K.cca_line_bwd(*torch_of(q, k, v, g, m, L, delta), masked=masked)
    check(got, want, GRAD_TOL, "dq, dk, dv")


@pytest.mark.parametrize("shape", ROUTE_SHAPES)
def test_line_route_glue_matches_legacy_impl(shape):
    """Both paths and the combine, forward; both backward paths and their
    sum, from the forward's joint stats and delta = Σ out·g."""
    B, H, W, Cq, Cv = shape
    q, k, v, g = arrays(sum(shape) + 3, (B, H, W, Cq), (B, H, W, Cq), (B, H, W, Cv),
                        (B, H, W, Cv))
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    want_out, want_m, want_L = _legacy_fwd_impl(jq, jk, jv, True, "highest")
    tq, tk, tv, tg = torch_of(q, k, v, g)
    out, m, L = K.cca_line_route_fwd(tq, tk, tv)
    check((out, m, L), (want_out, want_m, want_L), FWD_TOL, "out, m, L")

    delta = jnp.sum(jg * want_out, axis=-1)
    want = _legacy_bwd_both_paths(jq, jk, jv, jg, want_m, want_L, delta, True, "highest")
    got = K.cca_line_route_bwd(tq, tk, tv, tg, *torch_of(want_m, want_L, delta))
    check(got, want, GRAD_TOL, "dq, dk, dv")


def test_routed_op_takes_the_line_route_and_matches_pallas(monkeypatch):
    """(1, 9, 441): the JAX package's ``_fwd_impl`` goes legacy here (see
    tests/test_pallas_cca.py), and so does the port (W = 441 > LONG_LINE)."""
    B, H, W, Cq, Cv = 1, 9, 441, 4, 8
    q, k, v, g = arrays(7, (B, H, W, Cq), (B, H, W, Cq), (B, H, W, Cv), (B, H, W, Cv))
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("cca_line_fwd", "fwd"), ("cca_line_bwd", "bwd")):
        def counted(*a, _fn=getattr(K, name), _key=key, **kw):
            calls[_key] += 1
            return _fn(*a, **kw)
        monkeypatch.setattr(K, name, counted)

    jx = [jnp.asarray(a) for a in (q, k, v)]

    def pallas(q_, k_, v_):
        return criss_cross_attention_pallas(q_, k_, v_, interpret=True, precision="highest",
                                            partitioned=False)

    want_out = pallas(*jx)
    want = jax.grad(lambda *a: jnp.vdot(pallas(*a), jnp.asarray(g)), argnums=(0, 1, 2))(*jx)
    leaves = [t.requires_grad_(True) for t in torch_of(q, k, v)]
    out = K.criss_cross_attention_cuda(*leaves)[0]
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), **FWD_TOL)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    check(grads, want, GRAD_TOL, "dq, dk, dv")
    assert calls == {"fwd": 2, "bwd": 2}  # each path once, forward and backward


@pytest.mark.parametrize("hw,line", [((97, 97), False), ((128, 128), True), ((97, 193), True),
                                     ((129, 257), True), ((225, 449), True), ((129, 97), True)])
def test_uses_line_route(hw, line):
    """At the model's widths (Cq 64, Cv 512, bf16): ``line`` is the
    backward's route, and the forward's but at (129, 97), where the column
    kernel K1 still holds H = 129 (the forward leaves K1/K2 past H = 130 or
    W = 122, the backward K3/K4 past H = 99 or W = 106)."""
    assert K.uses_line_route("bwd", *hw) is line
    assert K.uses_line_route("fwd", *hw) is (line and hw != (129, 97))


def test_line_wrappers_refuse_bad_layouts():
    """A CUDA-only check, exercised through its helper: the line kernels read
    contiguous lines or the transposed view of a contiguous tensor, nothing
    else."""
    x = torch.zeros(2, 5, 7, 4)
    K._check_lines("x", x, col=False)
    K._check_lines("x", K._to_col(x), col=True)
    with pytest.raises(ValueError):
        K._check_lines("x", K._to_col(x), col=False)
    with pytest.raises(ValueError):
        K._check_lines("x", x[:, :, ::2], col=False)
