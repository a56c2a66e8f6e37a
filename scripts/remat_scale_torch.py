"""Remat at scale for the PyTorch/CUDA port: the batch at which the
backbone's activation recompute is the difference between running out of
memory and running. The port of ``scripts/remat_scale.py``.

Trains the flagship model (CCNet R101 R=2, bf16, OHEM at thresh 0.7 and
min_kept 100000, lr 1e-2) on random images (×30) and random labels from
seed 0, at ``--batch`` crops of ``--hw``, once per ``--modes`` entry: no
remat (``False``), every block of layers 3–4 recomputed (``True``), or the
selective policies ``conv12`` / ``convs``. Two warm steps, then six timed
by CUDA events. Prints one JSON line per mode: ok or out of memory, s/step,
crops/s, ``torch.cuda.max_memory_allocated()`` and the bytes held before
the first step (model, optimizer, inputs), the first step's loss, and the
kernels' launches.

    python scripts/remat_scale_torch.py [--batch 16] [--hw 769 769]
        [--modes False True conv12 convs] [--device cuda]

Only ``torch.cuda.OutOfMemoryError`` is caught, and reported as OOM; any
other error propagates. Run one mode per process where an OOM is expected
(``chip_smoke.py`` does), so that no fragment of it stays in the caching
allocator for the next mode. Runs on the CUDA card (it raises when there is
none) unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ccnet_tpu_torch.losses import build_criterion  # noqa: E402
from ccnet_tpu_torch.models import build_model  # noqa: E402
from ccnet_tpu_torch.ops import launch_counts  # noqa: E402
from ccnet_tpu_torch.train import create_train_state, make_train_step  # noqa: E402
from ccnet_tpu_torch.utils import resolve_device  # noqa: E402

MODES = {"False": False, "True": True, "conv12": "conv12", "convs": "convs"}
WARM_STEPS, TIMED_STEPS = 2, 6


def _train(mode: str, batch: int, hw, dev: torch.device, depth: int, steps: int) -> dict:
    """The steps of :func:`try_mode`; its tensors go when it returns or raises."""
    cuda = dev.type == "cuda"
    out = {}
    model = build_model("ccnet", num_classes=19, recurrence=2, depth=depth,
                        dtype=torch.bfloat16, impl="auto", device=dev, remat=MODES[mode])
    state = create_train_state(model, base_lr=1e-2, max_steps=60000, weight_decay=1e-4)
    step = make_train_step(build_criterion(ohem=True, thresh=0.7, min_kept=100000))
    rng = np.random.RandomState(0)  # the JAX script's draws, NHWC, then to NCHW
    images = torch.from_numpy(np.ascontiguousarray(
        (rng.randn(batch, *hw, 3).astype(np.float32) * 30.0).transpose(0, 3, 1, 2))).to(dev)
    labels = torch.from_numpy(rng.randint(0, 19, size=(batch, *hw)).astype(np.int32)).to(dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out["held_bytes"] = torch.cuda.memory_allocated(dev)
    losses = [step(state, images, labels)["loss"] for _ in range(WARM_STEPS)]
    out["first_loss"] = float(losses[0])  # waits for the warm steps
    if cuda:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
    t0 = time.perf_counter()
    for _ in range(steps):
        loss = step(state, images, labels)["loss"]
    if cuda:
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / steps
    else:
        float(loss)
        dt = (time.perf_counter() - t0) / steps
    out.update(s_per_step=dt, crops_per_s=batch / dt,
               timed_by="CUDA events" if cuda else "host clock")
    return out


def try_mode(mode: str, batch: int, hw=(769, 769), device: str = "cuda", depth: int = 101,
             steps: int = TIMED_STEPS) -> dict:
    """``WARM_STEPS`` + ``steps`` train steps with remat ``MODES[mode]``;
    ``{"ok": False, "oom": True, ...}`` where the card runs out of memory."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    out = {"mode": mode, "batch": batch, "hw": list(hw), "depth": depth,
           "device": torch.cuda.get_device_name(dev) if cuda else "cpu"}
    before = launch_counts()
    try:
        out.update(ok=True, oom=False, **_train(mode, batch, hw, dev, depth, steps))
    except torch.cuda.OutOfMemoryError as e:  # the outcome measured, for remat=False
        out.update(ok=False, oom=True, error=str(e).splitlines()[0][:200])
    gc.collect()
    if cuda:
        out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        torch.cuda.empty_cache()
    after = launch_counts()
    out["launches"] = {n: after[n] - before[n] for n in after if after[n] != before[n]}
    return out


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--hw", type=int, nargs=2, default=(769, 769))
    p.add_argument("--modes", type=str, nargs="*", default=list(MODES), choices=list(MODES))
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = p.parse_args(argv)
    results = []
    for mode in args.modes:
        print(f"-- remat={mode} batch={args.batch} hw={tuple(args.hw)}", flush=True)
        results.append(try_mode(mode, args.batch, tuple(args.hw), args.device))
        print(json.dumps(results[-1]), flush=True)
    return results


if __name__ == "__main__":
    main()
