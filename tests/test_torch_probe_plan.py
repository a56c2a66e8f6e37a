"""The launch plans of the probe kernels: the dot (P1/P4), the copy (P2/P5)
and the scale (P3), on the CPU.

``dot_plan`` sizes the dot's work items (a band of query rows of one line,
with all its keys, in at most 227 KB of shared memory) and its grid (one
block per resident slot, looping over items); ``dot_coverage`` replays
``mid_batch_dot_kernel``'s items, tiles and stores over a plan: every logit
is written once, from a shared-memory cell written once, for H of 1, 7, 96,
97 and 231 with the lines above and below two waves of blocks, and over
drawn shapes (hypothesis).

``csrc/probes.cu`` launches ``swap_leading_kernel`` and ``scale_kernel`` with
plans that ``ccnet_tpu_torch.ops.probes`` computes in Python (``swap_plan``,
``scale_plan``: one tile per block); ``swap_chunk_map`` and
``scale_coverage`` replay the kernels' grid-stride loops over a plan. Held
here, over grids of sizes, byte offsets and smaller grids that make the
loop stride (hypothesis): every element is written exactly once, the multiply-shift division equals integer division for every
32-bit index, and the copy's chunk map, applied to the input, is bit-equal
to the script's Pallas kernels ``_swap_kernel`` and
``_store_transposed_kernel`` run with ``interpret=True`` and the script's
grid and BlockSpecs (P5's padded columns cut to ``[:, :W]``), as is the
scale's split to ``_tile_kernel``.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ccnet_tpu_torch.ops import probes as P

SCRIPT = pathlib.Path(__file__).resolve().parent.parent / "scripts" / "probe_mosaic.py"
T = 16  # the script's column tile


@pytest.fixture(scope="module")
def pm():
    spec = importlib.util.spec_from_file_location("probe_mosaic", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _vmem(block, index_map):
    return pl.BlockSpec(block, index_map, memory_space=pltpu.VMEM)


@settings(max_examples=300, deadline=None)
@given(d=st.one_of(st.integers(1, 4096), st.integers(1, 2**31 - 1)),
       i=st.one_of(st.integers(0, 2**32 - 1), st.sampled_from([0, 1, 2**31, 2**32 - 1])))
def test_fast_divider_matches_integer_division(d, i):
    mul, shift = P.fast_divider(d)
    assert 0 < mul < 2**32 and 0 <= shift <= 31
    for j in (i, min(i + d, 2**32 - 1), i - i % d, max(i - i % d - 1, 0)):
        assert P.fast_div(j, mul, shift) == j // d
        assert int(P.fast_div(torch.tensor([j]), mul, shift)) == j // d  # int64, as the mirror


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 4), a=st.integers(1, 40), b=st.integers(1, 40), r=st.integers(1, 9),
       blocks=st.one_of(st.none(), st.integers(1, 5)))
def test_swap_plan_writes_every_chunk_once_from_its_source(n, a, b, r, blocks):
    plan = P.swap_plan(n, a, b, r)
    per_block = P.COPY_THREADS * P.COPY_UNROLL
    assert (plan.blocks - 1) * per_block < a * b * r <= plan.blocks * per_block  # one tile each
    if blocks is not None:  # a smaller grid: the grid-stride loop covers the rest
        plan = plan._replace(blocks=blocks)
    src, writes = P.swap_chunk_map(plan)
    assert bool((writes == 1).all())
    want = torch.arange(n * a * b * r).view(n, a, b, r).transpose(1, 2).reshape(-1)
    assert torch.equal(src, want)


@settings(max_examples=100, deadline=None)
@given(numel=st.one_of(st.integers(1, 64), st.integers(1, 300_000)),
       offset=st.integers(0, 3), blocks=st.one_of(st.none(), st.integers(1, 5)))
def test_scale_plan_writes_every_value_once(numel, offset, blocks):
    plan = P.scale_plan(numel, offset)
    per_block = P.COPY_THREADS * P.COPY_UNROLL
    assert plan.head <= 3 and plan.tail <= 3 and plan.body <= plan.blocks * per_block
    assert plan.body == 0 or (offset + plan.head) % 4 == 0  # the float4 body is 16-byte aligned
    if blocks is not None:
        plan = plan._replace(blocks=blocks)
    cover = P.scale_coverage(plan)
    assert cover.numel() == numel and bool((cover == 1).all())


@pytest.mark.parametrize("shape,blocks", [((96, 16, 128), None), ((9, 13, 8), None),
                                          ((7, 5, 24), 1), ((97, 97, 512), 7)])
def test_swap_chunk_map_matches_pallas_swap(pm, shape, blocks):
    A, B, C = shape
    x = np.random.RandomState(5).randn(A, B, C).astype(np.float32)
    want = pl.pallas_call(pm._swap_kernel, interpret=True,
                          out_shape=jax.ShapeDtypeStruct((B, A, C), jnp.bfloat16))(
        jnp.asarray(x, jnp.bfloat16))
    plan = P.swap_plan(1, A, B, C // 8)
    src, _ = P.swap_chunk_map(plan if blocks is None else plan._replace(blocks=blocks))
    chunks = torch.from_numpy(x).to(torch.bfloat16).reshape(-1, 8)  # 16-byte chunks
    got = chunks[src].reshape(B, A, C)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape,blocks", [((2, 96, 33, 512), None), ((1, 9, 17, 8), None),
                                          ((3, 5, 7, 16), 1), ((8, 13, 33, 64), 2)])
def test_swap_chunk_map_matches_pallas_store_transposed(pm, shape, blocks):
    B, H, W, C = shape
    x = np.random.RandomState(6).randn(*shape).astype(np.float32)
    want = pl.pallas_call(
        pm._store_transposed_kernel, grid=(B, pl.cdiv(W, T)), interpret=True,
        in_specs=[_vmem((1, H, T, C), lambda b, j: (b, 0, j, 0))],
        out_specs=_vmem((1, T, H, C), lambda b, j: (b, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, -(-W // T) * T, H, C), jnp.bfloat16))(
        jnp.asarray(x, jnp.bfloat16))
    plan = P.swap_plan(B, H, W, C // 8)
    src, _ = P.swap_chunk_map(plan if blocks is None else plan._replace(blocks=blocks))
    got = torch.from_numpy(x).to(torch.bfloat16).reshape(-1, 8)[src].reshape(B, W, H, C)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32))[:, :W])


@pytest.mark.parametrize("shape,offset,blocks", [((97, 256), 0, None), ((97, 256), 1, 3),
                                                 ((5, 7), 3, None), ((33, 3), 2, 1)])
def test_scale_split_matches_pallas_tile(pm, shape, offset, blocks):
    M, N = shape
    x = np.random.RandomState(7).randn(M, N).astype(np.float32)
    want = pl.pallas_call(
        pm._tile_kernel, grid=(pl.cdiv(M, T),), interpret=True,
        in_specs=[_vmem((T, N), lambda i: (i, 0))], out_specs=_vmem((T, N), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32))(jnp.asarray(x))
    plan = P.scale_plan(M * N, offset)
    cover = P.scale_coverage(plan if blocks is None else plan._replace(blocks=blocks))
    flat = torch.from_numpy(x).reshape(-1)
    # the kernel writes 2·x once where the replay covers a value; NaN elsewhere
    got = torch.where(cover == 1, flat * 2.0, torch.tensor(float("nan")))
    np.testing.assert_array_equal(got.reshape(M, N).numpy(), np.asarray(want))


@pytest.mark.parametrize("call", [
    lambda: P.fast_divider(0),
    lambda: P.fast_divider(2**31),
    lambda: P.swap_plan(0, 4, 4, 1),                  # no plane
    lambda: P.swap_plan(65536, 4, 4, 1),              # past the grid's y limit
    lambda: P.swap_plan(1, 65536, 65536, 1),          # 2**32 chunks in a plane
    lambda: P.scale_plan(0, 0),                       # nothing to scale
    lambda: P.scale_plan(5, 4),                       # not an offset within 16 bytes
])
def test_plans_reject_what_the_kernels_cannot_take(call):
    with pytest.raises(ValueError):
        call()


SMS = P.H100_SMS


def _dot_strides(T, H, C):  # P1's (H, T, C) layout
    return (0, T * C, C)


@pytest.mark.parametrize("H", [1, 7, 96, 97, 231])
@pytest.mark.parametrize("N,T", [(1, 3), (1, 97), (2, 100), (8, 97), (6, 100)])
def test_dot_plan_writes_every_logit_once(H, N, T):
    plan = P.dot_plan(N, T, H, 64, _dot_strides(T, H, 64))
    lines = N * T
    assert plan.smem <= P.SMEM_MAX and plan.vec == 1
    assert plan.items == lines * plan.bands and (plan.bands - 1) * plan.band < H
    # 8 warps, two blocks per SM, for lines on every SM; else 16, one per SM
    assert plan.warps == (8 if lines >= SMS else 16)
    slots = SMS * P.DOT_DESIGNS[plan.warps]
    assert plan.blocks == min(plan.items, slots)  # one block per resident slot at most
    assert -(-plan.band // 16) * -(-min(plan.group, H) // 16) <= P.DOT_TILES
    if lines >= slots and H <= 128:
        assert plan.bands == 1  # whole lines
    if 2 * lines <= slots and H > 16:
        assert plan.bands >= 2  # bands of the few lines fill the card
    cover = P.dot_coverage(plan, lines=min(lines, 8))  # 8 lines: every 16-byte phase of a run
    assert bool((cover == 1).all())


@settings(max_examples=40, deadline=None)
@given(N=st.integers(1, 3), T=st.integers(1, 300), H=st.integers(1, 140),
       C=st.integers(1, 200), aligned=st.booleans())
def test_dot_plan_covers_drawn_shapes(N, T, H, C, aligned):
    plan = P.dot_plan(N, T, H, C, (H * T * C, T * C, C), aligned=aligned)
    assert plan.vec == int(aligned and C % 8 == 0)
    assert plan.smem <= P.SMEM_MAX
    assert (plan.es_bytes, plan.smem) == P.dot_smem(H, plan.band, plan.group)
    assert bool((P.dot_coverage(plan, lines=min(N * T, 5)) == 1).all())


def test_dot_plan_key_passes_and_narrow_bands_past_512_keys():
    plan = P.dot_plan(1, 1, 1500, 64, (0, 64, 64))
    assert plan.group == P.DOT_PASS_KEYS and plan.band <= 16 and plan.smem <= P.SMEM_MAX
    assert bool((P.dot_coverage(plan) == 1).all())


def test_dot_plan_struct_matches_the_plan():
    plan = P.dot_plan(8, 97, 97, 64, (97 * 97 * 64, 97 * 64, 64))
    c = P._DotPlanC(*plan)
    assert tuple(getattr(c, f) for f in P.DotPlan._fields) == tuple(plan)
    assert (plan.band, plan.bands, plan.items, plan.blocks, plan.warps) == (97, 1, 776, 264, 8)
    p1 = P.dot_plan(1, 97, 97, 64, _dot_strides(97, 97, 64))  # a line per block, 16 warps
    assert (p1.band, p1.bands, p1.items, p1.blocks, p1.warps) == (97, 1, 97, 97, 16)


@pytest.mark.parametrize("call", [
    lambda: P.dot_plan(0, 1, 8, 8, (0, 8, 8)),          # no line
    lambda: P.dot_plan(1, 1, 0, 8, (0, 8, 8)),          # no pixel
    lambda: P.dot_plan(1, 1, 60000, 64, (0, 64, 64)),   # one row of e outgrows shared memory
])
def test_dot_plan_rejects_what_the_kernel_cannot_take(call):
    with pytest.raises(ValueError):
        call()


@pytest.mark.parametrize("strides,C,aligned", [((0, 70 * 3, 70), 70, True),
                                                ((0, 12, 4), 4, True),
                                                ((0, 512, 64), 64, False),
                                                ((3, 512, 64), 64, True)])
def test_dot_plan_stages_by_scalars_when_unaligned(strides, C, aligned):
    assert P.dot_plan(1, 3, 9, C, strides, aligned=aligned).vec == 0


def test_chip_smoke_variant_edits_apply_to_the_source():
    """Every text edit ``chip_smoke.py`` makes to ``csrc/probes.cu`` for its
    design variants and diagnostics finds its text there."""
    import importlib.util

    path = pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_edits", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    source = (pathlib.Path(P.__file__).resolve().parent.parent / "csrc" / "probes.cu").read_text()
    for variants in (cs.PROBE_VARIANTS, cs.DOT_DIAGNOSTICS):
        for name, edits in variants.items():
            for old, _ in edits:
                assert old in source, (name, old)
