"""Port's layout probes P1–P5 vs the Pallas kernels of ``scripts/probe_mosaic.py``.

Each plain version (the CPU route of its wrapper in
``ccnet_tpu_torch.ops.probes``) is held against the script's own kernel
body, launched here with ``pl.pallas_call(..., interpret=True)`` and the
script's grid and BlockSpecs, on the same numpy inputs. The dots at 1e-5 x
scale (the same bf16 products, f32 sums in another order), the copies and
the scale bit-exact. P4's and P5's Pallas outputs are padded to a multiple
of the 16-column tile; only the used ``[:, :W]`` part is compared. Also:
``cli.probe --device cpu`` prints five PASS lines, and wrong inputs raise.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
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


def _bf16(rng, shape):
    """bf16 values as f32 numpy (exact in both frameworks) and as torch bf16."""
    x = np.array(jnp.asarray(rng.randn(*shape), jnp.bfloat16).astype(jnp.float32))
    return x, torch.from_numpy(x).to(torch.bfloat16)


def _close(got, want, rel):
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _vmem(block, index_map):
    return pl.BlockSpec(block, index_map, memory_space=pltpu.VMEM)


def test_mid_batch_dot_matches_pallas(pm):
    H, Tt, C = 96, 16, 64
    rng = np.random.RandomState(0)
    (qn, q), (kn, k) = _bf16(rng, (H, Tt, C)), _bf16(rng, (H, Tt, C))
    want = pl.pallas_call(pm._mid_batch_kernel, interpret=True,
                          out_shape=jax.ShapeDtypeStruct((Tt, H, H), jnp.float32))(
        jnp.asarray(qn, jnp.bfloat16), jnp.asarray(kn, jnp.bfloat16))
    got = P.mid_batch_dot(q, k)
    assert got.dtype == torch.float32 and tuple(got.shape) == (Tt, H, H)
    _close(got.numpy(), np.asarray(want), 1e-5)


def test_swap_leading_matches_pallas(pm):
    rng = np.random.RandomState(1)
    xn, x = _bf16(rng, (96, 16, 128))
    want = pl.pallas_call(pm._swap_kernel, interpret=True,
                          out_shape=jax.ShapeDtypeStruct((16, 96, 128), jnp.bfloat16))(
        jnp.asarray(xn, jnp.bfloat16))
    got = P.swap_leading(x)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_scale_ragged_matches_pallas(pm):
    M, N = 97, 256
    x = np.random.RandomState(2).randn(M, N).astype(np.float32)
    want = pl.pallas_call(
        pm._tile_kernel, grid=(pl.cdiv(M, T),), interpret=True,
        in_specs=[_vmem((T, N), lambda i: (i, 0))], out_specs=_vmem((T, N), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((M, N), jnp.float32))(jnp.asarray(x))
    np.testing.assert_array_equal(P.scale_ragged(torch.from_numpy(x)).numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(2, 96, 33, 64), (1, 9, 17, 8)])
def test_mid_batch_dot_4d_matches_pallas(pm, shape):
    B, H, W, C = shape
    rng = np.random.RandomState(3)
    (qn, q), (kn, k) = _bf16(rng, shape), _bf16(rng, shape)
    spec = _vmem((1, H, T, C), lambda b, j: (b, 0, j, 0))
    want = pl.pallas_call(
        pm._mid_batch4_kernel, grid=(B, pl.cdiv(W, T)), interpret=True,
        in_specs=[spec, spec], out_specs=_vmem((1, T, H, H), lambda b, j: (b, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, -(-W // T) * T, H, H), jnp.float32))(
        jnp.asarray(qn, jnp.bfloat16), jnp.asarray(kn, jnp.bfloat16))
    got = P.mid_batch_dot_4d(q, k)
    assert tuple(got.shape) == (B, W, H, H)
    _close(got.numpy(), np.asarray(want)[:, :W], 1e-5)


@pytest.mark.parametrize("shape", [(2, 96, 33, 512), (1, 9, 17, 8)])
def test_store_transposed_matches_pallas(pm, shape):
    B, H, W, C = shape
    xn, x = _bf16(np.random.RandomState(4), shape)
    want = pl.pallas_call(
        pm._store_transposed_kernel, grid=(B, pl.cdiv(W, T)), interpret=True,
        in_specs=[_vmem((1, H, T, C), lambda b, j: (b, 0, j, 0))],
        out_specs=_vmem((1, T, H, C), lambda b, j: (b, j, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((B, -(-W // T) * T, H, C), jnp.bfloat16))(
        jnp.asarray(xn, jnp.bfloat16))
    got = P.store_transposed(x)
    assert tuple(got.shape) == (B, W, H, C)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32))[:, :W])


def test_probe_cli_cpu_passes(capsys):
    from ccnet_tpu_torch.cli.probe import main

    before = dict(P.LAUNCHES)
    results = main(["--device", "cpu"])
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(("PASS", "FAIL"))]
    assert len(lines) == 5 and all(ln.startswith("PASS  (") for ln in lines), lines
    assert len(results) == 5 and all(results.values())
    assert P.LAUNCHES == before  # the CPU route launches nothing


def test_probe_cli_fails_with_exit_1(monkeypatch, capsys):
    from ccnet_tpu_torch.cli import probe

    monkeypatch.setattr(probe.P, "scale_ragged", lambda x: x * 3.0)
    with pytest.raises(SystemExit) as exc:
        probe.main(["--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    assert "FAIL  (c) ragged grid (masked tail stores): AssertionError" in out
    assert out.count("PASS  ") == 4


@pytest.mark.parametrize("fn,args", [
    (P.mid_batch_dot, (torch.zeros(4, 2, 8, dtype=torch.bfloat16),
                       torch.zeros(4, 3, 8, dtype=torch.bfloat16))),       # shapes differ
    (P.mid_batch_dot, (torch.zeros(4, 2, 8), torch.zeros(4, 2, 8))),      # f32, not bf16
    (P.mid_batch_dot_4d, (torch.zeros(4, 2, 8, dtype=torch.bfloat16),) * 2),  # 3-D, not 4-D
    (P.swap_leading, (torch.zeros(4, 2, 8, dtype=torch.bfloat16).transpose(0, 1),)),
    (P.store_transposed, (torch.zeros(1, 4, 2, 8),)),                      # f32, not bf16
    (P.scale_ragged, (torch.zeros(3, 4, dtype=torch.bfloat16),)),          # bf16, not f32
    (P.scale_ragged, (torch.zeros(0, 4),)),                                # empty
])
def test_wrong_inputs_raise(fn, args):
    with pytest.raises(ValueError):
        fn(*args)
