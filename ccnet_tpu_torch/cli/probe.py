"""Probe CLI — the layout probes P1–P5 on the device, each against its plain version.

    python -m ccnet_tpu_torch.cli.probe            # on the card
    python -m ccnet_tpu_torch.cli.probe --device cpu

Counterpart of ``scripts/probe_mosaic.py``: the five probes (a)–(e) at the
script's shapes, inputs seeded with numpy, each held against its plain
PyTorch version with the script's tolerances (the dots at rtol 2e-2, atol
1e-2; the copies bit-exact; the scale at rtol 1e-6). It prints one
``PASS  <name>`` or ``FAIL  <name>: <error>`` line per probe and, unlike the
JAX script, exits 1 when any probe fails. ``--device`` defaults to ``cuda``
(the kernels of ``csrc/probes.cu``) and raises without CUDA; ``cpu`` runs
the wrappers' plain route.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ccnet_tpu_torch.ops import probes as P
from ccnet_tpu_torch.utils import resolve_device

DOT_TOL = dict(rtol=2e-2, atol=1e-2)  # the script's assert_allclose of the dots
SCALE_RTOL = 1e-6


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(device, dtype)


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), rtol=rtol, atol=atol)


def _equal(got, want):
    if got.shape != want.shape or not torch.equal(got, want):
        raise AssertionError(f"not bit-exact: shapes {tuple(got.shape)} vs {tuple(want.shape)}")


def _probes(device, rng):
    bf16 = torch.bfloat16

    def mid_batch():  # (a): H, T, C = 96, 16, 64
        q, k = (_randn(rng, (96, 16, 64), bf16, device) for _ in range(2))
        _close(P.mid_batch_dot(q, k), P.mid_batch_dot_plain(q, k), **DOT_TOL)

    def swapaxes():  # (b): H, T, C = 96, 16, 128
        x = _randn(rng, (96, 16, 128), bf16, device)
        _equal(P.swap_leading(x), P.swap_leading_plain(x))

    def ragged():  # (c): M = 97 rows, not a multiple of the 16-row tile
        x = _randn(rng, (97, 256), torch.float32, device)
        _close(P.scale_ragged(x), P.scale_ragged_plain(x), SCALE_RTOL)

    def mid_batch_4d():  # (d): B, H, W, C = 2, 96, 33, 64; W = 33 is ragged too
        q, k = (_randn(rng, (2, 96, 33, 64), bf16, device) for _ in range(2))
        _close(P.mid_batch_dot_4d(q, k), P.mid_batch_dot_4d_plain(q, k), **DOT_TOL)

    def transposed_store():  # (e): B, H, W, C = 2, 96, 33, 512
        x = _randn(rng, (2, 96, 33, 512), bf16, device)
        _equal(P.store_transposed(x), P.store_transposed_plain(x))

    return [("(a) middle-batch dot_general", mid_batch),
            ("(b) leading-dim swapaxes", swapaxes),
            ("(c) ragged grid (masked tail stores)", ragged),
            ("(d) middle-batch dot + 4D ragged grid", mid_batch_4d),
            ("(e) in-kernel transposed store", transposed_store)]


def get_parser():
    p = argparse.ArgumentParser(description="ccnet_tpu_torch layout probes P1-P5")
    p.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    return p


def main(argv=None) -> dict:
    """Run the five probes; returns ``{name: passed}``, or exits 1 if any failed."""
    args = get_parser().parse_args(argv)
    device = resolve_device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {device} ({name})", flush=True)
    results = {}
    for probe, fn in _probes(device, np.random.RandomState(0)):
        try:
            fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        except Exception as e:  # noqa: BLE001 -- report every probe, then exit 1 below
            msg = str(e).split("\n")[0][:200]
            print(f"FAIL  {probe}: {type(e).__name__}: {msg}", flush=True)
            results[probe] = False
        else:
            print(f"PASS  {probe}", flush=True)
            results[probe] = True
    if not all(results.values()):
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
