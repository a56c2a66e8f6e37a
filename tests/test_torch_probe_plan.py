"""The launch plans of the probe copy (P2/P5) and scale (P3) kernels, on the CPU.

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
