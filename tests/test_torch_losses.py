"""Port's training losses vs the JAX package's.

* ``integer_upsample_ratio`` and ``interp_matrix`` equal to the JAX ones;
* the plain ``upsampled_nll_reference`` (the CPU route of K5) and the
  ``UpsampledNLLFn`` grad (the CPU route of K6) vs JAX ``upsampled_nll``
  run as the bare interpret-mode Pallas kernel (``interpret=True,
  partitioned=False``), at ``tests/test_upsampled_ce.py``'s shapes:
  < 1e-5 forward, < 1e-4 x max|grad| backward;
* ``ohem_keep_mask`` EQUAL to JAX's on the same probabilities, in the
  ``p_k > thresh``, ``c_t >= k`` and ``num_valid <= min_kept`` cases, and
  the ported count bisection (``kth_smallest_bisect``, ``ohem_threshold``)
  equal to JAX's on seeded maps: ``thresh <= 0`` (all 25 passes), the k-th
  statistic above ``thresh``, ``c_t >= k``, ``num_valid <= min_kept`` and
  ties at the k-th value;
* ``criterion_dsn`` / ``criterion_ohem_dsn`` values and grads vs JAX.

Logits are NHWC on the JAX side and NCHW on the port's; the CUDA kernels
are held against the plain versions on the card by
``tests/test_torch_kernels_gpu.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccnet_tpu.losses import criterion as jcrit
from ccnet_tpu.losses.cross_entropy import softmax_cross_entropy_ignore as jax_ce
from ccnet_tpu.losses.ohem import ohem_cross_entropy as jax_ohem_ce
from ccnet_tpu.losses.ohem import kth_smallest_bisect as jax_kth
from ccnet_tpu.losses.ohem import ohem_keep_mask as jax_keep_mask
from ccnet_tpu.losses.ohem import ohem_threshold as jax_threshold
from ccnet_tpu.ops import upsampled_ce as jup

from ccnet_tpu_torch.losses import (
    criterion_dsn,
    criterion_ohem_dsn,
    ohem_cross_entropy,
    ohem_keep_mask,
    softmax_cross_entropy_ignore,
)
from ccnet_tpu_torch.losses.ohem import kth_smallest_bisect, ohem_threshold
from ccnet_tpu_torch.ops import upsampled_ce as U

SHAPES = [  # B, h, w, C, r (tests/test_upsampled_ce.py)
    (2, 5, 7, 4, 3),
    (1, 9, 9, 6, 4),
    (1, 7, 5, 19, 8),
]


def _case(B, h, w, C, r, seed):
    rng = np.random.RandomState(seed)
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    logits = rng.randn(B, h, w, C).astype(np.float32)
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.15] = 255  # ignore pixels
    return logits, labels


def nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("in_out", [(97, 769), (65, 513), (97, 770), (1, 9), (5, 13), (9, 9)])
def test_integer_upsample_ratio_matches_jax(in_out):
    assert U.integer_upsample_ratio(*in_out) == jup.integer_upsample_ratio(*in_out)


@pytest.mark.parametrize("w,r", [(97, 8), (7, 3), (9, 4), (2, 5)])
def test_interp_matrix_equals_jax(w, r):
    W = (w - 1) * r + 1
    np.testing.assert_array_equal(U.interp_matrix(w, W, r), jup._interp_matrix(w, W, r))


@pytest.mark.parametrize("shape", SHAPES)
def test_upsampled_nll_forward_matches_jax(shape):
    logits, labels = _case(*shape, seed=0)
    want = np.asarray(jup.upsampled_nll(jnp.asarray(logits), jnp.asarray(labels), True, False))
    before = dict(U.LAUNCHES)
    for lab in (torch.from_numpy(labels), torch.from_numpy(labels).long()):
        got = U.upsampled_nll_fwd(nchw(logits), lab)  # CPU route: the reference
        assert got.dtype == torch.float32 and tuple(got.shape) == labels.shape
        assert np.abs(got.numpy() - want).max() < 1e-5
    assert U.LAUNCHES == before
    assert (got.numpy()[labels == 255] == 0).all()


@pytest.mark.parametrize("shape", SHAPES)
def test_upsampled_nll_grad_matches_jax(shape):
    logits, labels = _case(*shape, seed=1)
    mask = (labels != 255).astype(np.float32)
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)

    def loss(L):
        return jnp.sum(jup.upsampled_nll(L, jlab, True, False) * mask) / max(mask.sum(), 1.0)

    want = np.asarray(jax.grad(loss)(jl)).transpose(0, 3, 1, 2)
    x = nchw(logits).requires_grad_(True)
    nll = U.UpsampledNLLFn.apply(x, torch.from_numpy(labels))
    (got,) = torch.autograd.grad((nll * torch.from_numpy(mask)).sum() / max(mask.sum(), 1.0), x)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < 1e-4
    # the plain backward with an explicit g is the same gradient
    g = torch.from_numpy(mask / max(mask.sum(), 1.0))
    direct = U.upsampled_nll_bwd(nchw(logits), torch.from_numpy(labels), g)
    np.testing.assert_allclose(direct.numpy(), got.numpy(), atol=1e-7)


def test_upsampled_nll_refuses_bad_geometry():
    logits = torch.zeros(1, 3, 5, 5)
    with pytest.raises(ValueError):
        U.upsampled_nll_fwd(logits, torch.zeros(1, 14, 13, dtype=torch.int32))
    with pytest.raises(ValueError):
        U.upsampled_nll_bwd(logits, torch.zeros(1, 13, 13, dtype=torch.int32),
                            torch.zeros(1, 12, 13))


def _probs(case: str):
    """(p, valid, min_kept) of one selection regime."""
    rng = np.random.RandomState({"kth": 0, "thresh": 1, "few_valid": 2}[case])
    shape = (2, 33, 41)
    valid = rng.rand(*shape) > 0.1
    if case == "kth":  # p_k > thresh: the k-th statistic decides
        p = 0.7 + 0.3 * rng.rand(*shape)
        return p.astype(np.float32), valid, 500
    p = rng.rand(*shape).astype(np.float32)
    if case == "thresh":  # c_t >= k: many pixels below thresh, the threshold is thresh
        return p, valid, 100
    return p, valid, int(valid.sum()) + 10  # num_valid <= min_kept: keep all valid


@pytest.mark.parametrize("case", ["kth", "thresh", "few_valid"])
def test_ohem_keep_mask_equals_jax(case):
    p, valid, min_kept = _probs(case)
    want = np.asarray(jax_keep_mask(jnp.asarray(p), jnp.asarray(valid), 0.7, min_kept))
    got = ohem_keep_mask(torch.from_numpy(p), torch.from_numpy(valid), 0.7, min_kept).numpy()
    np.testing.assert_array_equal(got, want)
    if case == "few_valid":
        np.testing.assert_array_equal(got, valid)
    elif case == "kth":
        assert min_kept <= got.sum() < valid.sum()


def _flat_map(case: str):
    """(flat map with +inf at invalid pixels, k, thresh, num_valid,
    min_kept) of one threshold regime."""
    rng = np.random.RandomState(["full", "kth", "thresh", "few_valid", "ties",
                                 "ties_full"].index(case) + 10)
    n = 2 * 33 * 41
    valid = rng.rand(n) > 0.1
    p = rng.rand(n).astype(np.float32)
    thresh, min_kept = 0.7, 500
    if case == "full":  # thresh <= 0: the bisection runs all 25 passes over [0, 1]
        thresh, min_kept = 0.0, 700
    elif case == "kth":  # p_k > thresh
        p = (0.7 + 0.3 * p).astype(np.float32)
    elif case == "thresh":  # c_t >= k
        min_kept = 100
    elif case == "few_valid":  # num_valid <= min_kept: keep everything
        min_kept = int(valid.sum()) + 10
    else:  # eight distinct values: the k-th sits inside a run of ties
        p = (np.floor(p * 8) / 8 + 0.05).astype(np.float32)
        thresh, min_kept = (0.3 if case == "ties" else 0.0), 1234
    flat = np.where(valid, p, np.inf).astype(np.float32)
    return flat, min(min_kept, n), thresh, int(valid.sum()), min_kept


@pytest.mark.parametrize("case", ["full", "kth", "thresh", "few_valid", "ties", "ties_full"])
def test_ohem_threshold_equals_jax(case):
    """The ported threshold, and with it the keep set, is JAX's to the bit."""
    flat, k, thresh, num_valid, min_kept = _flat_map(case)
    want = float(jax_threshold(jnp.asarray(flat), k, thresh, jnp.asarray(num_valid),
                               min_kept))
    got = float(ohem_threshold(torch.from_numpy(flat), k, thresh, torch.tensor(num_valid),
                               min_kept))
    assert got == want
    if case == "few_valid":
        assert got == 1.0
    elif case in ("kth", "ties"):  # the k-th statistic decides, and keeps >= k pixels
        assert got > thresh and (flat <= got).sum() >= k


@pytest.mark.parametrize("case", ["full", "ties_full"])
@pytest.mark.parametrize("iters", [25, 13, 3])
def test_kth_smallest_bisect_equals_jax(case, iters):
    flat, k, *_ = _flat_map(case)
    want = float(jax_kth(jnp.asarray(flat), k, iters=iters))
    got = float(kth_smallest_bisect(torch.from_numpy(flat), k, iters=iters))
    assert got == want
    if iters == 25:  # converged: the k-th smallest value itself, to f32 resolution
        np.testing.assert_allclose(got, np.sort(flat)[k - 1], rtol=1e-6)


def _outputs(seed, B=2, h=7, w=7, C=6, r=4):
    rng = np.random.RandomState(seed)
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    main, aux = (rng.randn(B, h, w, C).astype(np.float32) for _ in range(2))
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.1] = 255
    return main, aux, labels


@pytest.mark.parametrize("ohem", [False, True])
def test_criteria_and_grads_match_jax(ohem):
    """criterion_dsn / criterion_ohem_dsn (min_kept below num_valid, so the
    k-th statistic runs) and their grads in both heads' logits."""
    main, aux, labels = _outputs(2)
    if ohem:
        jfn = lambda o: jcrit.criterion_ohem_dsn(o, jnp.asarray(labels), min_kept=17)  # noqa: E731
        tfn = lambda o: criterion_ohem_dsn(o, torch.from_numpy(labels), min_kept=17)  # noqa: E731
    else:
        jfn = lambda o: jcrit.criterion_dsn(o, jnp.asarray(labels))  # noqa: E731
        tfn = lambda o: criterion_dsn(o, torch.from_numpy(labels))  # noqa: E731
    jout = {"main": jnp.asarray(main), "aux": jnp.asarray(aux)}
    want_loss, want_g = jax.value_and_grad(jfn)(jout)
    tout = {"main": nchw(main).requires_grad_(True), "aux": nchw(aux).requires_grad_(True)}
    loss = tfn(tout)
    got_g = torch.autograd.grad(loss, [tout["main"], tout["aux"]])
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    for got, key in zip(got_g, ("main", "aux")):
        want = np.asarray(want_g[key]).transpose(0, 3, 1, 2)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * np.abs(want).max(), key


def test_pixel_losses_match_jax():
    """softmax_cross_entropy_ignore and ohem_cross_entropy on full-resolution
    logits (NHWC in JAX, NCHW here)."""
    rng = np.random.RandomState(3)
    logits = rng.randn(2, 17, 19, 5).astype(np.float32)
    labels = rng.randint(0, 5, (2, 17, 19)).astype(np.int32)
    labels[rng.rand(2, 17, 19) < 0.1] = 255
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    tl, tlab = nchw(logits), torch.from_numpy(labels)
    np.testing.assert_allclose(float(softmax_cross_entropy_ignore(tl, tlab)),
                               float(jax_ce(jl, jlab)), rtol=1e-6)
    np.testing.assert_allclose(float(ohem_cross_entropy(tl, tlab, min_kept=50)),
                               float(jax_ohem_ce(jl, jlab, min_kept=50)), rtol=1e-6)
