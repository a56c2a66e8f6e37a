"""K5/K6's band algorithm in plain torch vs the JAX package's upsampled NLL.

``upsampled_nll_band_fwd`` / ``upsampled_nll_band_bwd``
(``ccnet_tpu_torch/ops/upsampled_ce.py``) mirror the CUDA kernels of
``csrc/upsampled_ce.cu`` tile by tile: bands of r fine rows (K5), coarse
rows gathered from both neighbouring segments over the tile's fine columns
plus the halo (K6), skipped pixels (g == 0, labels off [0, C)) and the
fixed-order width reduction. They are held against JAX ``upsampled_nll``
run as the bare interpret-mode Pallas kernel (``interpret=True,
partitioned=False``) and its VJP, on the same numpy inputs, at
``tests/test_torch_losses.py``'s shapes plus ragged column tiles, both label
dtypes, ignore labels and a g with zeros. f32 throughout: the forward
within 1e-5 (absolute), the backward within 1e-4 x max|grad|, the bounds
the kernels are held to on the card.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ccnet_tpu.ops import upsampled_ce as jup

from ccnet_tpu_torch.ops import upsampled_ce as U

NLL_TOL, GRAD_TOL = 1e-5, 1e-4
SHAPES = [  # B, h, w, C, r: tests/test_torch_losses.py's shapes
    (2, 5, 7, 4, 3),
    (1, 9, 9, 6, 4),
    (1, 7, 5, 19, 8),
]
# ragged column tiles: band_tile(33, 8) = 17 gives tiles of 17 and 16, and
# an explicit T = 3 at w = 7 tiles of 3, 3 and 1
RAGGED = [((1, 3, 33, 5, 8), None), ((2, 5, 7, 4, 3), 3)]


def _case(B, h, w, C, r, seed, g_zeros=0.3):
    rng = np.random.RandomState(seed)
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    logits = rng.randn(B, h, w, C).astype(np.float32)
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.15] = 255  # ignore pixels
    g = rng.rand(B, H, W).astype(np.float32)
    g[rng.rand(B, H, W) < g_zeros] = 0.0  # OHEM drops pixels: g == 0 there
    return logits, labels, g


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _jax(logits, labels, g):
    """JAX upsampled_nll (interpret-mode Pallas kernel) and its VJP in g, NCHW."""
    jl, jlab = jnp.asarray(logits), jnp.asarray(labels)
    nll, vjp = jax.vjp(lambda L: jup.upsampled_nll(L, jlab, True, False), jl)
    return np.asarray(nll), np.asarray(vjp(jnp.asarray(g))[0]).transpose(0, 3, 1, 2)


CASES = [(s, None) for s in SHAPES] + RAGGED


@pytest.mark.parametrize("label_dtype", ["int32", "uint8"])
@pytest.mark.parametrize("shape,T", CASES)
def test_band_mirror_matches_jax(shape, T, label_dtype):
    logits, labels, g = _case(*shape, seed=sum(shape))
    want_nll, want_grad = _jax(logits, labels, g)
    lab = torch.from_numpy(labels.astype(label_dtype))
    nll = U.upsampled_nll_band_fwd(_nchw(logits), lab, T)
    grad = U.upsampled_nll_band_bwd(_nchw(logits), lab, torch.from_numpy(g), T)
    assert nll.dtype == grad.dtype == torch.float32
    assert np.abs(nll.numpy() - want_nll).max() <= NLL_TOL
    assert (nll.numpy()[labels == 255] == 0).all()
    assert np.abs(grad.numpy() - want_grad).max() <= GRAD_TOL * np.abs(want_grad).max()


def test_band_mirror_skips_pixels_that_carry_no_gradient():
    """g == 0 and ignore labels contribute exactly 0: a g that is zero but
    on a few pixels gives the gradient of those pixels alone, which JAX's
    VJP of the same g also gives."""
    logits, labels, g = _case(1, 5, 9, 6, 4, seed=3, g_zeros=0.98)
    want_nll, want_grad = _jax(logits, labels, g)
    got = U.upsampled_nll_band_bwd(_nchw(logits), torch.from_numpy(labels), torch.from_numpy(g))
    assert np.abs(got.numpy() - want_grad).max() <= GRAD_TOL * np.abs(want_grad).max()
    none = U.upsampled_nll_band_bwd(_nchw(logits), torch.from_numpy(labels),
                                    torch.zeros(labels.shape))
    assert float(none.abs().max()) == 0.0


@pytest.mark.parametrize("w,r,T", [(97, 8, 25), (257, 8, 29), (9, 4, 9), (7, 3, 7), (5, 8, 5),
                                   (2, 300, 1)])
def test_band_tile_covers_a_row_within_a_block(w, r, T):
    """The tile width the kernels are launched with: the 769² crops' 97
    coarse columns in 4 tiles of at most 25, full frame's 257 in 9 of at
    most 29; a tile's fine columns plus K6's halo fit one block of 256
    threads wherever r allows it."""
    assert U.band_tile(w, r) == T
    tiles = -(-w // T)
    assert (tiles - 1) * T < w <= tiles * T
    assert T * r + r - 1 <= U.BAND_COLS or T == 1
