"""The port's line route of criss-cross attention at bf16, and its route
choice, vs the JAX package on the CPU.

* the line route's forward and backward (``cca_line_route_fwd`` /
  ``cca_line_route_bwd``, the plain versions of K7a/K7b behind them) on bf16
  inputs vs ``_legacy_fwd_impl`` / ``_legacy_bwd_both_paths`` in interpret
  mode at the default precision: both round p (and de) to bf16 before the
  products that consume them, write each path's ``o`` and grads in bf16,
  combine in f32 and sum the paths' grads in bf16;
* the same arithmetic without those roundings misses the bound;
* the routed op (``criss_cross_attention_cuda``, forward and grads) vs the
  Pallas op at the default precision, where both take the line route, and
  at (1, 4, 124, 64, 512), where JAX's own budget sends both directions
  down the line route and the port follows it, no longer computing the
  natural route's function;
* ``uses_line_route`` vs the JAX package's decision from ``_pick_tile``
  over a grid of line lengths, widths and dtypes, both directions.

Bounds, from the readings (seed ``sum(shape)``): a bf16 output agrees when
at most ``FLIPS`` of its elements (``GRAD_FLIPS`` for grads) differ from
JAX's, by at most 2^-8 x scale (one bf16 step; an f32 sum taken in another
order flips a rounding of p or de). Where the rounding route read 0
differing elements it is held bit-equal. Readings: the rounding route
differs in 0 elements of out at three of the four route shapes and in
4.8e-5 at (1, 5, 131, 64, 128), in 0-0.82 % of the grads' elements; the
unrounded arithmetic in 29-41 % of out's and 34-51 % of the grads'. The
routed op at (1, 9, 441, 4, 8): 0.03 % of out, 0.05-0.21 % of the grads;
at (1, 4, 124, 64, 512): 0.006 % of out, up to 2.4 % of dq, while JAX's
natural route differs from the op in 24 % of out and 7-71 % of the grads.
m and L are f32 reductions of the same f32 logits: 1e-5 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ccnet_tpu.ops.cc_attention_pallas import (
    _bwd_natural,
    _fwd_impl_natural,
    _legacy_bwd_both_paths,
    _legacy_fwd_impl,
    _pick_tile,
    criss_cross_attention_pallas,
)

from ccnet_tpu_torch.ops import cc_attention_cuda as K

FLIPS, GRAD_FLIPS, STEP = 1e-2, 5e-2, 2.0 ** -8

# (B, H, W, Cq, Cv), whether out and the grads read 0 differing elements
ROUTE_SHAPES = [((1, 9, 33, 16, 32), True, True), ((1, 12, 140, 16, 32), True, False),
                ((1, 5, 131, 64, 128), False, False),
                ((1, 1, 37, 4, 8), True, True)]  # H = 1: column lines of N = 1


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


def _agrees(got, want, exact: bool, flips: float) -> bool:
    a, b = _f32(got), _f32(want)
    share = float(np.mean(a != b))
    if exact:
        return share == 0.0
    return share <= flips and np.abs(a - b).max() <= STEP * max(1.0, np.abs(b).max())


@functools.lru_cache(maxsize=None)
def _case(shape):
    """bf16 (q, k, v, g) as torch tensors, and JAX's legacy route on them at
    the default precision: (out f32, m, L, delta) and the grads."""
    B, H, W, Cq, Cv = shape
    rng = np.random.RandomState(sum(shape))
    xs = [rng.randn(B, H, W, c).astype(np.float32) for c in (Cq, Cq, Cv, Cv)]
    jq, jk, jv, jg = (jnp.asarray(x).astype(jnp.bfloat16) for x in xs)
    out, m, L = _legacy_fwd_impl(jq, jk, jv, True, "default")
    delta = jnp.sum(jg.astype(jnp.float32) * out, axis=-1)
    grads = _legacy_bwd_both_paths(jq, jk, jv, jg, m, L, delta, True, "default")
    tt = [torch.from_numpy(x).to(torch.bfloat16) for x in xs]
    stats = [torch.from_numpy(np.array(a)) for a in (m, L, delta)]
    return tt, (out, m, L), stats, grads


def _unrounded(tq, tk, tv, tg, m, L, delta):
    """The line route's arithmetic on f32 copies of the bf16 inputs: p and de
    kept in f32, each path's o and grads too."""
    t32 = [t.float() for t in (tq, tk, tv, tg)]
    col = map(K._to_col, K.cca_line_fwd_plain(*map(K._to_col, t32[:3]), masked=True))
    out = K._combine(*col, *K.cca_line_fwd_plain(*t32[:3], masked=False))[0]
    col = K.cca_line_bwd_plain(*map(K._to_col, (*t32, m, L, delta)), masked=True)
    row = K.cca_line_bwd_plain(*t32, m, L, delta, masked=False)
    return out.to(torch.bfloat16), [(K._to_col(c) + r).to(torch.bfloat16)
                                    for c, r in zip(col, row)]


@pytest.mark.parametrize("shape,exact,_", ROUTE_SHAPES)
def test_bf16_line_route_fwd_matches_legacy_default_precision(shape, exact, _):
    (tq, tk, tv, _g), (want_out, want_m, want_L), _s, _d = _case(shape)
    before = dict(K.LAUNCHES)
    o_col = K.cca_line_fwd(*map(K._to_col, (tq, tk, tv)), masked=True)[0]
    out, m, L = K.cca_line_route_fwd(tq, tk, tv)
    assert K.LAUNCHES == before  # the CPU route launches nothing
    assert o_col.dtype == torch.bfloat16  # each path's o in v's dtype, as _legacy_fwd_kernel
    assert out.dtype == torch.float32  # the combine's residual, as _legacy_fwd_impl's
    assert _agrees(out.to(torch.bfloat16), want_out.astype(jnp.bfloat16), exact, FLIPS)
    assert np.abs(_f32(out) - _f32(want_out)).max() <= STEP * max(1.0, np.abs(want_out).max())
    np.testing.assert_allclose(m.numpy(), np.asarray(want_m), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(L.numpy(), np.asarray(want_L), rtol=1e-5, atol=1e-5)
    if shape[1] == 1:  # all self slot: m_col = -1e9, l_col = 1, o_col = v exactly
        col = K.cca_line_fwd(*map(K._to_col, (tq, tk, tv)), masked=True)
        assert torch.all(col[1] == K.NEG_INF) and torch.all(col[2] == 1.0)
        assert torch.equal(col[0], K._to_col(tv))


@pytest.mark.parametrize("shape,_,exact", ROUTE_SHAPES)
def test_bf16_line_route_bwd_matches_legacy_default_precision(shape, _, exact):
    (tq, tk, tv, tg), _f, stats, want = _case(shape)
    col = K.cca_line_bwd(*map(K._to_col, (tq, tk, tv, tg, *stats)), masked=True)
    got = K.cca_line_route_bwd(tq, tk, tv, tg, *stats)
    assert all(c.dtype == torch.bfloat16 for c in col)  # per path, as _legacy_bwd_kernel
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.bfloat16
        assert _agrees(a, b, exact, GRAD_FLIPS), name


@pytest.mark.parametrize("shape,exact_fwd,exact_bwd", ROUTE_SHAPES)
def test_bf16_unrounded_line_route_misses_legacy_default_precision(shape, exact_fwd, exact_bwd):
    """Without the roundings the same inputs give another function: out and
    every grad miss the bounds the rounding route meets."""
    (tq, tk, tv, tg), (want_out, _m, _L), stats, want = _case(shape)
    out, grads = _unrounded(tq, tk, tv, tg, *stats)
    assert not _agrees(out, want_out.astype(jnp.bfloat16), exact_fwd, FLIPS)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert not _agrees(a, b, exact_bwd, GRAD_FLIPS), name


def _op_vs_pallas(shape):
    """The routed op's bf16 out and grads, JAX's op's (interpret, default
    precision, unpartitioned), and JAX's natural route's on the same inputs."""
    B, H, W, Cq, Cv = shape
    rng = np.random.RandomState(sum(shape))
    q, k, v, g = (rng.randn(B, H, W, c).astype(np.float32) for c in (Cq, Cq, Cv, Cv))
    jx = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)]
    jg = jnp.asarray(g)

    def op(*a):
        return criss_cross_attention_pallas(*a, interpret=True, precision="default",
                                            partitioned=False)

    want_out = op(*jx)
    want = jax.grad(lambda *a: jnp.vdot(op(*a).astype(jnp.float32), jg), argnums=(0, 1, 2))(*jx)
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in (q, k, v)]
    out = K.criss_cross_attention_cuda(*leaves)[0]
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(g).to(torch.bfloat16))
    return out.detach(), grads, want_out, want, (jx, jg.astype(jnp.bfloat16))


def test_bf16_routed_op_matches_pallas_default_precision():
    """(1, 9, 441): both packages take the line route both ways."""
    out, grads, want_out, want, _ = _op_vs_pallas((1, 9, 441, 4, 8))
    assert out.dtype == torch.bfloat16
    assert _agrees(out, want_out, False, FLIPS)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert _agrees(a, b, False, GRAD_FLIPS), name


def test_routed_op_follows_jax_routes_at_w124():
    """(1, 4, 124, 64, 512) bf16: W = 124 is past what JAX's natural
    kernels hold at these widths (122 forward, 106 backward), so JAX's op
    takes the line route both ways, and so does the port (it took K1–K4
    while max(H, W) <= 128): it matches JAX's op and not JAX's natural
    route, which rounds elsewhere (o_row kept in f32, the column grads
    added in f32)."""
    shape = (1, 4, 124, 64, 512)
    assert K.uses_line_route("fwd", *shape[1:3]) and K.uses_line_route("bwd", *shape[1:3])
    out, grads, want_out, want, (jx, jg) = _op_vs_pallas(shape)
    assert _agrees(out, want_out, False, FLIPS)
    for name, a, b in zip(("dq", "dk", "dv"), grads, want):
        assert _agrees(a, b, False, GRAD_FLIPS), name
    nat_out, m, L = _fwd_impl_natural(*jx, True, "default")
    delta = jnp.sum(jg.astype(jnp.float32) * nat_out.astype(jnp.float32), axis=-1)
    nat = _bwd_natural(*jx, jg, m, L, delta, True, "default")
    assert not _agrees(out, nat_out, False, FLIPS)
    for name, a, b in zip(("dq", "dk"), grads, nat):
        assert not _agrees(a, b, False, GRAD_FLIPS), name


LINE_LENGTHS = (1, 97, 99, 100, 106, 107, 122, 123, 128, 130, 131, 257, 449)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cq,cv", [(64, 512), (4, 8), (16, 32)])
def test_route_predicate_matches_pick_tile(cq, cv, dtype):
    """``uses_line_route`` equals the JAX package's choice in ``_fwd_impl``
    / ``_bwd_both_paths`` (natural iff ``_pick_tile`` >= 8 on both paths),
    bf16 at the default precision (outputs in bf16), f32 at "highest"."""
    isz = osz = 2 if dtype == torch.bfloat16 else 4
    highp = dtype == torch.float32
    for H in LINE_LENGTHS:
        for W in LINE_LENGTHS:
            for d in K.DIRECTIONS:
                natural = (_pick_tile(H, cq, cv, isz, osz, f"{d}_col", highp) >= 8
                           and _pick_tile(W, cq, cv, isz, osz, f"{d}_row", highp) >= 8)
                assert K.uses_line_route(d, H, W, cq, cv, dtype) is (not natural), (d, H, W)
