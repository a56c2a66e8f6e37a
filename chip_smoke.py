#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ccnet_tpu_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card of compute
capability 9.0 and ``nvcc``. It imports nothing of JAX. Phases, in order; any
failure raises and exits non-zero:

1. card: the ``nvidia-smi`` name and power limit; capability (9, 0) required;
2. build: the six CUDA libraries of ``ccnet_tpu_torch/csrc`` (``cca_fwd``,
   ``cca_bwd``, ``upsampled_ce``, ``cca_lines``, ``cca_lines_tc``,
   ``probes``), one ``nvcc`` each, started together;
3. kernels vs plain: K1 ``cca_fwd_col`` and K2 ``cca_fwd_row`` against their
   plain-torch versions, and the routed op against the joint-softmax
   oracle, at the sliding-tile, whole-image and edge shapes, in f32 (TF32
   off: the CUDA-core kernel) and bf16 (each kernel's own line: lines of at
   most 128 on the one-block tensor-core design, longer ones on K7a's
   tensor-core kernel, as at the whole-image shape and the edge shapes of
   bf16 natural-route lines of 129 to 400; both against the plain versions
   on the same bf16 tensors, their bf16 outputs bit-equal to the rounding
   plain versions' but for a few flipped roundings, which the plain version
   that does not round p is not); at the sliding shape CUDA-event times of
   the tensor-core and CUDA-core designs and the plain versions, and the
   CCA forward against the plain op;
4. backward kernels vs plain: K3 ``cca_bwd_col`` and K4 ``cca_bwd_row``
   against their plain versions, and the autograd Function's grads against
   torch.autograd of the plain op, at the same shapes and dtypes (bf16: the
   one-block tensor-core design on lines of at most 128, K7b's tensor-core
   kernels on longer ones, against the plain version on the same bf16
   tensors; f32: the CUDA-core pair); times of the tensor-core and
   CUDA-core designs at the sliding shape;
5. loss kernels vs plain: K5 ``upsampled_nll_fwd`` and K6
   ``upsampled_nll_bwd`` against the materialised upsample + NLL and its
   autograd, int32 and uint8 labels, at the 769² and full-frame shapes,
   ragged column tiles and r = 300, K6 also with a sparse and a zero g;
   times at (8, 97, 97, 19) → 769² and (2, 129, 257, 19) → 1025×2049, K6
   with a dense g and with g live on 2 % of the pixels, beside the bounds;
   ``criterion_ohem_dsn`` forward + backward at the 769² step's logits,
   kernel route against plain route, timed in turns;
6. line kernels vs plain: K7a ``cca_line_fwd`` and K7b ``cca_line_bwd`` on
   both paths as the line route calls them, and the routed Function's
   output and grads (each direction routed as the JAX package routes it),
   at the whole-image shapes of scales 1.0 and 1.75 and edge shapes, f32
   (the CUDA-core kernels against the f32 plain versions) and bf16 (the
   tensor-core kernels against the plain versions fed the same bf16
   tensors, which round p and de where the kernels do; K7a's o bit-equal
   to theirs but for a few flipped roundings, which the plain version that
   keeps p in f32 is not), plus edge lines of N = 16, 17, 65, 128 and
   463-465 in bf16; times at the long shapes of both designs, the rounding
   plain versions, the plain op and K1–K4 forced at the same shape;
   (3, 4 and 6 also time the one-call yardstick of the attention,
   ``F.scaled_dot_product_attention`` with a row-or-column mask on
   ``(B, 1, H·W, C)``, forward and forward + backward, on every backend
   that takes it, after checking it computes the plain op's function)
7. probes vs plain: P1–P5 (``ccnet_tpu_torch/ops/probes.py``) at the shapes
   of ``scripts/probe_mosaic.py`` and at the model's (P4 at K1's column
   logits (8, 97, 97, 64), P5 at v (8, 97, 97, 512)): the copies and the
   scale bit-exact, the dots at 1e-4 x scale; times (``probe_times``: the
   burst time, and the device µs per call from ``torch.profiler`` beside
   the host µs per call of back-to-back calls, of the kernel and of the one
   library call, which says whether the device or the host's pace sets
   the time; for P1/P4 beside the ``einsum``'s); the dot also at the
   shapes that reach its other paths (one pixel, scalar staging for C % 8
   != 0 and for a base 2 bytes past 16, bands past 64 tiles at H = 231,
   three channel chunks at C = 136, P4's bands of a ragged line); then the
   probe main path, ``ccnet_tpu_torch.cli.probe.main``, prints five PASS
   lines and launches each kernel;
8. full model: CCNet-R101 R=2 bf16 with seeded random weights (``gamma`` =
   0.5, so the attention moves the logits), kernel route vs plain route on
   one (8, 3, 769, 769) batch (K1/K2) and on one (1, 3, 1024, 2048) image
   (K7a), and both routes' eval forward timed in turns in this process;
   the weights go to a ``.pth``;
9. train step: one OHEM+DSN ``train_step`` from that ``.pth`` with the
   kernels (CCA and loss) and one with the plain versions: loss, CCA grads,
   launch counts, peak memory, then steps of the two timed in turns; at
   batch 8 of 769² (K1–K6);
10. train main path: ``ccnet_tpu_torch.cli.train.main`` with ``--synthetic``,
    batch 8 of 769², OHEM, 4 steps from that ``.pth``; launch counts of
    K1–K6; the exported ``CS_scenes_4.pth`` loads strictly; the card's
    s/step (CUDA events, augment + step: the batch was copied by the
    prefetch thread) beside the median host wall s/step;
11. full-frame training: 9 and 10 at batch 2 of 1025×2049 crops padded from
    the 1024×2048 images (features 129×257: K7a/K7b and K5/K6), 2 steps;
12. evaluation main path: ``ccnet_tpu_torch.cli.evaluate.main`` on the
    synthetic 1024×2048 set with the trained ``.pth``, sliding 769²
    windows (K1/K2, every launch on the tensor cores); then ``--whole 1``
    (K7a at 129×257); then multi-scale
    + flip whole image, scales 0.75–1.75, ``--save-preds 1`` (K7a at
    97×193 … 225×449), whose prediction PNGs are decoded with ``zlib``.
    Each run's launch counts must show that it went through its kernels;
    the card's s/img (predict + confusion) beside the median host wall
    s/img;
13. PSPNet-R101 and DeepLabv3-R101 (bf16, seeded random weights): 9 and 10
    (2 steps) at batch 8 of 769² through K5/K6 (2 launches of each per step,
    none of the attention), and sliding ``cli.evaluate --model X
    --save-preds 1`` of the exported ``.pth`` on the synthetic set.

Every kernel's time stands beside its bound: the larger of the bytes the
function must move (each input read once, each output written once,
counted from this run's tensors, the attention's intermediates and
gradients in the value dtype as the TPU functions hold them) over 3.35
TB/s and its operations over the peak rate of its inputs' type (989
TFLOP/s bf16 tensor cores, 67 TFLOP/s f32). Timed calls cycle through
copies of their inputs that hold 4x the L2 cache between them, so every
time reads its inputs from HBM as the bound assumes. It prints one JSON
line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

also profiles one kernel-route train step of CCNet (769², batch 8),
PSPNet and DeepLabv3 and prints their top kernels by device time and the
time of the attention kernels (``cca_*``) among them.

    python3 chip_smoke.py --ab outputs/parent

runs nothing of the above: it times P1/P4 (``probe_times``) and 4 steps of
``cli.train --synthetic`` at batch 8 of 769² with ``--num-workers 8``
(``train_wall``) in the checkout ``outputs/parent`` (a ``git archive`` of
the parent commit) and in this one, in turns (parent, this, this, parent),
each turn in its own process, and prints one ``[ab]`` JSON line per turn.
"""

from __future__ import annotations

import argparse
import itertools
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time
import warnings
import zlib

import numpy as np
import torch

SLIDING = (8, 97, 97, 64, 512)  # B, H, W, Cq, Cv of the sliding tile batch
SHAPES = [SLIDING, (1, 129, 257, 64, 512), (2, 9, 8, 8, 16), (1, 1, 7, 4, 8), (1, 7, 1, 4, 8)]
# max |kernel - plain| <= TOL * max(1, max|plain|): f32 differs by summation
# order only; bf16 outputs are rounded to 8 bits of mantissa (2^-8 = 0.4%)
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# full model: the two routes share every bf16 layer except CCA, whose
# outputs differ by bf16 rounding (the plain route rounds the attention
# weights to bf16); ~4 bf16 layers follow it
MODEL_TOL, MODEL_ARGMAX = 5e-2, 0.995
TIMING_REPS = 20
# K3/K4 and the Function's grads: f32 (TF32 off) differs by summation order;
# bf16 against the plain version in f32 from the same bf16 inputs, where the
# kernels round the output and the final grads to bf16
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 3e-2}
# the tensor-core K1–K4 against the plain versions fed the same bf16
# tensors, which round p (and de), o_col, the output and the grads where the
# kernels do: f32 sums in another order flip one of those roundings here
# and there (the same plain versions and the TPU kernels in interpret mode
# agree to 2^-8 x scale on the CPU)
TC_TOL = 1e-2
# ... and their bf16 outputs (K1's o_col, K2's out) bit-equal to the
# rounding plain versions' but for at most this share of flipped roundings;
# the plain version that keeps p in f32 differs from them in more
TC_FLIPS = 1e-2
# edge lines of the tensor-core designs beyond SHAPES (B, H, W, Cq, Cv): the
# longest line (128) of the one-block design on both paths, N = 16 / 17 with
# 4 or 8 q/k channels, and bf16 natural-route lines past 128, which K1–K4 run
# on the tensor-core line kernels: the forward at H = 129 and the model's
# widths (K1 on them, K2 not), and narrow widths with lines of 129 to 400
TC_EDGE_SHAPES = [(1, 128, 128, 64, 512), (2, 16, 17, 8, 16), (1, 17, 16, 4, 512),
                  (1, 129, 120, 64, 512), (2, 300, 200, 8, 16), (1, 300, 129, 8, 16)]
EVAL_AB_REPS = 6  # timed eval forwards of each CCA route, in turns
# B, H, W, Cq, Cv of the line route: whole image at scale 1.0 (and full-frame
# training), at scale 1.75, and edge shapes (N = 1 on either path)
LINE_SHAPES = [(1, 129, 257, 64, 512), (1, 225, 449, 64, 512), (2, 9, 441, 8, 16),
               (1, 1, 300, 4, 8), (1, 300, 1, 4, 8)]
# edge lines of the tensor-core K7a/K7b beyond LINE_SHAPES: N = 16, 17, 65,
# 128 and 463-465 on either path, Cq 12 and 128, odd Cv
LINE_TC_EDGE_SHAPES = [(2, 16, 17, 8, 16), (1, 65, 128, 64, 512), (1, 463, 5, 64, 512),
                       (1, 3, 464, 16, 32), (2, 465, 3, 12, 21), (1, 33, 97, 128, 64)]
TRAIN_AB_REPS = 3  # timed train steps of each route, in turns
# B, h, w, C, r of K5/K6: the 769² crops, small shapes, full frame (129 x 257
# -> 1025 x 2049), ragged column tiles (94 -> 24, 24, 24, 22; 85 -> 43, 42 at
# r = 4) and r = 256 (a tile's fine columns outnumber a block's threads); the
# large ones at ratios of 2^n, where the plain version's F.interpolate
# computes the source index exactly (at r = 3, W = 253 it misses by 1e-5)
LOSS_SHAPES = [(8, 97, 97, 19, 8), (2, 5, 7, 4, 3), (1, 9, 9, 6, 4), (2, 129, 257, 19, 8),
               (1, 5, 94, 19, 8), (2, 3, 85, 7, 4), (1, 2, 3, 3, 256)]
LOSS_TIMED = {"769²": LOSS_SHAPES[0], "full frame": LOSS_SHAPES[3]}  # the train steps' shapes
SPARSE_G = 0.02  # share of pixels with g != 0 in the sparse case (OHEM once trained)
NLL_TOL = 1e-5        # K5: max abs err of the f32 nll
NLL_GRAD_TOL = 1e-4   # K6: max abs err over max |plain grad|
CRITERION_AB_REPS = 6  # timed criterion_ohem_dsn forward + backward of each route, in turns
# train step, kernel route vs plain route from one state (bf16 model): the
# plain route rounds the attention weights to bf16 in the forward; the
# kernel route's backward takes delta = sum(out * g) from the bf16 output,
# as the JAX package's bf16 route does, and de = p (dp - delta) cancels.
# The q/k conv grads of the two routes differ by 5.4 % (relative norm) on
# the CPU stand-in (plain versions behind the Function, R50, 2 x 65^2).
TRAIN_LOSS_RTOL = 1e-2
TRAIN_GRAD_RTOL = 0.15  # ||kernel grad - plain grad|| / ||plain grad||
TRAIN_BATCH, CROP, DEPTH, TRAIN_STEPS = 8, 769, 101, 4
# full-frame training: 1025x2049 crops (features 129x257, integer ratio 8 to
# the labels, so K5/K6 stay on) padded from the 1024x2048 images
FULL_FRAME, FULL_FRAME_BATCH, FULL_FRAME_STEPS = (1025, 2049), 2, 2
HEAD_TRAIN_STEPS = 2  # cli.train steps of PSPNet and DeepLabv3
MS_SCALES = (0.75, 1.0, 1.25, 1.5, 1.75)  # multi-scale + flip whole-image evaluation
EVAL_HW = (1024, 2048)  # the synthetic Cityscapes-sized images of training and evaluation
CCA_GRADS = ("head.cca.query_conv.weight", "head.cca.key_conv.weight",
             "head.cca.value_conv.weight", "head.cca.gamma")


# (wrapper, source in csrc/, the TPU kernel it replaces)
KERNELS = [
    ("cca_fwd_col", "cca_fwd.cu", "ccnet_tpu/ops/cc_attention_pallas.py:123"),
    ("cca_fwd_row", "cca_fwd.cu", "ccnet_tpu/ops/cc_attention_pallas.py:159"),
    ("cca_bwd_col", "cca_bwd.cu", "ccnet_tpu/ops/cc_attention_pallas.py:304"),
    ("cca_bwd_row", "cca_bwd.cu", "ccnet_tpu/ops/cc_attention_pallas.py:350"),
    ("upsampled_nll_fwd", "upsampled_ce.cu", "ccnet_tpu/ops/upsampled_ce.py:102"),
    ("upsampled_nll_bwd", "upsampled_ce.cu", "ccnet_tpu/ops/upsampled_ce.py:126"),
    ("cca_line_fwd", "cca_lines_tc.cu", "ccnet_tpu/ops/cc_attention_pallas.py:552"),
    ("cca_line_bwd", "cca_lines_tc.cu", "ccnet_tpu/ops/cc_attention_pallas.py:661"),
    ("mid_batch_dot", "probes.cu", "scripts/probe_mosaic.py:33"),
    ("swap_leading", "probes.cu", "scripts/probe_mosaic.py:55"),
    ("scale_ragged", "probes.cu", "scripts/probe_mosaic.py:70"),
    ("mid_batch_dot_4d", "probes.cu", "scripts/probe_mosaic.py:89"),
    ("store_transposed", "probes.cu", "scripts/probe_mosaic.py:119"),
]

# the H100 SXM's published peaks (NVIDIA's data sheet, dense): memory, and
# the rate of the operations on inputs of each type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# timed calls cycle through copies of their inputs holding 4x the H100's
# 50 MB L2 between them, so each call reads its inputs from HBM
ROTATE_BYTES = 4 * 50 * 2**20


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    log(smi)
    from ccnet_tpu_torch.utils import is_hopper

    cap = torch.cuda.get_device_capability(0)
    if not is_hopper():
        raise RuntimeError(f"need a Hopper card (capability 9.0), got {cap} "
                           f"({torch.cuda.get_device_name(0)})")
    log(f"[card] {torch.cuda.get_device_name(0)} capability {cap}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    return smi


LIBRARIES = ("cca_fwd", "cca_bwd", "upsampled_ce", "cca_lines", "cca_lines_tc", "probes")


def phase_build() -> None:
    from ccnet_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_libraries(LIBRARIES)  # one nvcc per source, started together
    log(f"[build] {', '.join(LIBRARIES)} built in {time.perf_counter() - t0:.2f} s (nvcc "
        + ", ".join(f"{n} {_build.BUILD_SECONDS[n]:.2f} s" for n in LIBRARIES) + ")")
    for name in LIBRARIES:
        for line in _build.PTXAS_REPORT.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[build] {name}: {line.strip()}")


def _inputs(shape, dtype, seed):
    B, H, W, Cq, Cv = shape
    rng = np.random.RandomState(seed)
    q, k = (torch.from_numpy(rng.randn(B, H, W, Cq).astype(np.float32)) for _ in range(2))
    v = torch.from_numpy(rng.randn(B, H, W, Cv).astype(np.float32))
    return [t.to("cuda", dtype) for t in (q, k, v)]


def _err(got, want) -> tuple:
    want = want.float()
    err = (got.float() - want).abs().max().item()
    return err, max(1.0, want.abs().max().item())


def _flipped(got, want) -> float:
    """The share of the elements of ``got`` not bit-equal to ``want``."""
    return (got != want).float().mean().item()


def _rel_check(what: str, got, want, tol: float) -> float:
    """max |got - want| <= tol * max(1, max |want|); returns the error."""
    err, scale = _err(got, want)
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max abs err {err:.3e} > {tol:g} x scale {scale:.3g}")
    return err


def _copies(args) -> list:
    """Argument tuples for timing: ``args`` and copies of its tensors, as
    many as hold ROTATE_BYTES between them (at most 64)."""
    size = sum(a.numel() * a.element_size() for a in args if isinstance(a, torch.Tensor))
    n = 1 if size == 0 else min(64, max(1, math.ceil(ROTATE_BYTES / size)))

    def copy(a):
        if not isinstance(a, torch.Tensor):
            return a
        return a.detach().clone().requires_grad_(a.requires_grad)

    return [tuple(args)] + [tuple(copy(a) for a in args) for _ in range(n - 1)]


def _time_ms(fn, *args, sets=None) -> float:
    """Median CUDA-event time of one ``fn(*args)`` over TIMING_REPS bursts,
    after warm-up. A burst is one call, or as many back-to-back calls as fill
    about 1 ms, so that a call of a few microseconds is not timed as the
    host's launch latency. Successive calls take successive argument tuples
    of ``sets`` (default :func:`_copies` of ``args``), and a burst's results
    stay allocated until it ends, so that no call reads an input that an
    earlier call left in the L2 cache, nor writes over an earlier output."""
    calls = itertools.cycle(sets or _copies(args))
    for _ in range(3):
        fn(*next(calls))
    times, n = [], 1
    for rep in range(TIMING_REPS + 1):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        keep = [fn(*next(calls)) for _ in range(n)]
        b.record()
        b.synchronize()
        del keep
        if rep == 0:  # a first single call sizes the burst
            n = int(min(50, max(1, math.ceil(1.0 / max(a.elapsed_time(b), 1e-3)))))
        else:
            times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def _bound(inputs, outputs, flops: float, dtype) -> dict:
    """The least time the card could take for a call: the larger of its
    bytes (each distinct input tensor read once, each output written once;
    views of one tensor count once) over HBM_BYTES_PER_S and ``flops`` over
    the peak rate of ``dtype``. An entry ``(t, dt)`` counts tensor ``t`` at
    the element size of ``dt``: the attention's TPU functions hold their
    intermediates and gradients in the value dtype where the port's kernels
    write f32, and the bound counts the bytes the function needs. The
    bytes the port moves are ``port_bytes``."""
    seen, nbytes, port = set(), 0, 0
    for entry in (*inputs, *outputs):
        t, dt = entry if isinstance(entry, tuple) else (entry, entry.dtype)
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            nbytes += t.numel() * dt.itemsize
            port += t.numel() * t.element_size()
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return {"bound_ms": max(by_bytes, by_ops), "bound_by": "bytes" if by_bytes >= by_ops
            else "operations", "bound_bytes": nbytes, "port_bytes": port, "bound_flops": flops}


def _in_value_dtype(tensors, dtype) -> list:
    """``tensors`` as :func:`_bound` counts them at ``dtype``."""
    return [(t, dtype) for t in tensors]


def _cca_flops(shape, fwd: bool, path: str) -> float:
    """FLOPs of one CCA path at (B, H, W, Cq, Cv): the forward's q·kᵀ and
    p·v (2·Cq + 2·Cv per pair), the backward's recomputed q·kᵀ, dq, dk
    (3 · 2·Cq) and g·vᵀ, dv (2 · 2·Cv); a path has B·W·H² (columns) or
    B·H·W² (rows) pairs."""
    B, H, W, Cq, Cv = shape
    pairs = B * W * H * H if path == "col" else B * H * W * W
    return pairs * (2 * (Cq + Cv) if fwd else 2 * (3 * Cq + 2 * Cv))


def _cca_mask(H: int, W: int, device) -> torch.Tensor:
    """(H·W, H·W) bool: pixel j is in pixel i's row or column (itself once)."""
    idx = torch.arange(H * W, device=device)
    r, c = idx // W, idx % W
    return (r[:, None] == r[None, :]) | (c[:, None] == c[None, :])


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION", "MATH")


def _sdpa_yardstick(q, k, v, g=None) -> tuple:
    """The one-call yardstick of the CCA on NHWC bf16 q, k, v:
    ``F.scaled_dot_product_attention(q, k, v, attn_mask=row-or-column,
    scale=1.0)`` on ``(B, 1, H·W, C)``, its forward (``g`` None) or forward
    + backward through autograd. Each backend is asked in turn; one that
    refuses the call is recorded with its reason; each one that runs is
    checked against the plain op (f32) at the bf16 tolerances, then timed.
    Returns (fastest ms, its backend, {backend: ms or refusal})."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from ccnet_tpu_torch.ops import cc_attention as plain

    B, H, W, _ = q.shape
    mask = _cca_mask(H, W, q.device)
    flat = [t.detach().reshape(B, 1, H * W, t.shape[-1]).requires_grad_(g is not None)
            for t in (q, k, v)]
    if g is not None:
        flat.append(g.reshape(B, 1, H * W, -1))

    def call(backend, *qkvg):
        with sdpa_kernel(backend):
            out = F.scaled_dot_product_attention(*qkvg[:3], attn_mask=mask, scale=1.0)
            if g is None:
                return (out,)
            return torch.autograd.grad(out, qkvg[:3], qkvg[3])

    leaves = [t.detach().float().requires_grad_(g is not None) for t in (q, k, v)]
    want = plain.criss_cross_attention(*leaves)
    wants = (want,) if g is None else torch.autograd.grad(want, leaves, g.float())
    del want, leaves
    results = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name)
        try:
            with warnings.catch_warnings(record=True) as why:  # a refusal's reasons
                warnings.simplefilter("always")
                got = call(backend, *flat)
                torch.cuda.synchronize()
        except RuntimeError as e:  # this backend does not take the call: recorded
            reasons = [str(w.message).strip() for w in why
                       if not any(x in str(w.message) for x in ("not used because", "disabled"))]
            reasons.append(str(e).strip())
            results[name] = "refused: " + " | ".join(r.splitlines()[0][:160] for r in reasons
                                                     if r.splitlines())
            continue
        for i, (a, b) in enumerate(zip(got, wants)):
            _rel_check(f"SDPA {name} output {i} vs the plain CCA at {tuple(q.shape)}",
                       a.reshape(b.shape), b, TOL[torch.bfloat16] if g is None
                       else BWD_TOL[torch.bfloat16])
        del got
        results[name] = _time_ms(lambda *t: call(backend, *t), *flat)
    timed = {n: ms for n, ms in results.items() if isinstance(ms, float)}
    if not timed:
        raise RuntimeError(f"no SDPA backend ran the CCA yardstick: {results}")
    best = min(timed, key=timed.get)
    del mask, flat, wants
    torch.cuda.empty_cache()
    return timed[best], best, results


def _log_sdpa(tag: str, shape, res: tuple) -> None:
    ms, best, results = res
    log(f"[{tag}] library yardstick at {shape} bf16: F.scaled_dot_product_attention with the "
        f"row-or-column mask, fastest {best} {ms:.4f} ms; "
        + "; ".join(f"{n} {v:.4f} ms" if isinstance(v, float) else f"{n} {v}"
                    for n, v in results.items()))


def phase_kernels() -> dict:
    """K1/K2 against their plain versions, and the routed op against the
    joint-softmax oracle, at every shape in f32 and bf16 (and the edge lines
    of the tensor-core design in bf16). Where the call takes the
    tensor-core design (bf16, lines of at most 128) the plain versions get
    the same bf16 tensors and round where the kernels round; elsewhere (the
    CUDA-core kernel) they compute in f32. Then, at the sliding shape, times
    of both designs and the plain versions, and the CCA forward against the
    plain op."""
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    cases = [(torch.float32, s) for s in SHAPES]
    cases += [(torch.bfloat16, s) for s in SHAPES + TC_EDGE_SHAPES]
    with torch.inference_mode():
        for dtype, shape in cases:
            q, k, v = _inputs(shape, dtype, seed=sum(shape))
            q32, k32, v32 = q.float(), k.float(), v.float()
            tc = dtype == torch.bfloat16  # every bf16 design rounds p as the TPU kernels
            tol = TC_TOL if tc else TOL[dtype]
            before = dict(K.LAUNCHES)
            col = K.cca_fwd_col(q, k, v)
            row = K.cca_fwd_row(q, k, v, *col)  # K2 fed K1's own outputs
            out, m, L = K.criss_cross_attention_cuda(q, k, v)
            torch.cuda.synchronize()
            moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
            want = _cca_want(shape, dtype, fwd=1)  # the op's launches, K1/K2 or K7a
            _add_natural(want, shape, dtype, "fwd")  # and the wrappers' own
            if moved != want:
                raise RuntimeError(f"K1/K2 at {shape} {dtype} launched {moved}, not {want}")
            ins = (q, k, v) if tc else (q32, k32, v32)
            want_col, want_row = K.cca_fwd_col_plain(*ins), K.cca_fwd_row_plain(*ins, *col)
            checks = {
                "K1": zip(("o_col", "m_col", "l_col"), col, want_col),
                "K2": zip(("out", "m", "L"), row, want_row),
                "op": zip(("out", "m", "L"), (out, m, L),
                          plain.criss_cross_attention_stats(q32, k32, v32)),
            }
            errs = {}
            for kern, pairs in checks.items():
                for name, got, want in pairs:
                    errs[f"{kern}.{name}"] = _rel_check(f"{kern} {name} at {shape} {dtype}", got,
                                                        want, TOL[dtype] if kern == "op" else tol)
            if col[0].dtype != v.dtype:
                raise AssertionError(f"K1 o_col is {col[0].dtype}, not v's {v.dtype}")
            flips = ""
            if tc:  # p rounded where the plain versions round it, not kept in f32
                unrounded = K.cca_fwd_row_plain(q32, k32, v32, *K.cca_fwd_col_plain(q32, k32, v32))
                share = {"K1.o_col": _flipped(col[0], want_col[0]),
                         "K2.out": _flipped(row[0], want_row[0]),
                         "unrounded.out": _flipped(unrounded[0].to(v.dtype), want_row[0])}
                flips = " flipped " + " ".join(f"{n}={x:.2e}" for n, x in share.items())
                if max(share["K1.o_col"], share["K2.out"]) > TC_FLIPS:
                    raise AssertionError(f"K1/K2 at {shape}: {flips.strip()}, over {TC_FLIPS:g}")
                if share["unrounded.out"] <= TC_FLIPS:
                    raise AssertionError(f"at {shape} the unrounded plain version is within "
                                         f"{TC_FLIPS:g} of the rounding one: {flips.strip()}")
                del unrounded
            if shape[1] == 1 and not (torch.all(col[1] == plain.NEG_INF)
                                      and torch.all(col[2] == 1.0)):
                raise AssertionError(f"K1 at {shape} {dtype}: H = 1 stats are not (-1e9, 1)")
            if shape == SLIDING and dtype == torch.bfloat16:
                for kern, key in (("K1", "cca_fwd_col"), ("K2", "cca_fwd_row")):
                    report[key] = {"max_abs_err": max(e for n, e in errs.items()
                                                      if n.startswith(kern))}
            log(f"[kernels] {str(dtype)[6:]} {shape} {_designs(shape, dtype)}: "
                f"ok (K1/K2 tol {tol:g} x scale, op {TOL[dtype]:g}) "
                + " ".join(f"{n}={e:.2e}" for n, e in errs.items()) + flips)

        # times at the sliding shape, bf16: the tensor-core design, the
        # CUDA-core kernel forced at the same shape (the earlier design, held
        # against the f32 plain versions first) and the plain versions on the
        # same bf16 tensors; the yardstick of K1 + K2 is one SDPA forward
        bf16 = torch.bfloat16
        q, k, v = _inputs(SLIDING, bf16, seed=1)
        f32_ins = (q.float(), k.float(), v.float())
        col = K.cca_fwd_col(q, k, v)
        row = K.cca_fwd_row(q, k, v, *col)
        col_cc = K.cca_fwd_col(q, k, v, design="cuda_core")
        row_cc = K.cca_fwd_row(q, k, v, *col_cc, design="cuda_core")
        for kern, got_t, want_t in (("K1", col_cc, K.cca_fwd_col_plain(*f32_ins)),
                                    ("K2", row_cc, K.cca_fwd_row_plain(*f32_ins, *col_cc))):
            for i, (got, want) in enumerate(zip(got_t, want_t)):
                _rel_check(f"{kern} CUDA-core design output {i} at {SLIDING}", got, want,
                           TOL[bf16])
        del col_cc, row_cc, f32_ins
        report["cca_fwd_col"].update(_bound((q, k, v), col, _cca_flops(SLIDING, True, "col"),
                                            bf16))
        report["cca_fwd_row"].update(_bound((q, k, v, *col), row,
                                            _cca_flops(SLIDING, True, "row"), bf16))
        for name, extra in (("cca_fwd_col", ()), ("cca_fwd_row", col)):
            fn, fn_plain = getattr(K, name), getattr(K, f"{name}_plain")
            r = report[name]
            r["ms"] = _time_ms(fn, q, k, v, *extra)
            r["earlier_ms"] = _time_ms(lambda *a: fn(*a, design="cuda_core"), q, k, v, *extra)
            r["plain_ms"] = _time_ms(fn_plain, q, k, v, *extra)
            r.update(design="tensor cores (mma.sync m16n8k16 bf16), one block per line, p in "
                            "registers", share=r["bound_ms"] / r["ms"],
                     tflops=r["bound_flops"] / r["ms"] / 1e9)
        op_ms = _time_ms(K.criss_cross_attention_cuda, q, k, v)
        plain_op_ms = _time_ms(plain.criss_cross_attention, q, k, v)
        del col, row
    sdpa = _sdpa_yardstick(q, k, v)
    _log_sdpa("kernels", SLIDING, sdpa)
    for name in ("cca_fwd_col", "cca_fwd_row"):
        r = report[name]
        r["library_ms"] = sdpa[0]
        log(f"[kernels] {name} at {SLIDING} bf16: {r['design']} {r['ms']:.4f} ms "
            f"({r['share']:.1%} of the bound {r['bound_ms']:.4f} ms by {r['bound_by']}, "
            f"{r['tflops']:.1f} TFLOP/s); earlier design (CUDA cores, online softmax) "
            f"{r['earlier_ms']:.4f} ms; plain {r['plain_ms']:.4f} ms (median of {TIMING_REPS})")
    log(f"[kernels] CCA forward at {SLIDING} bf16: kernels {op_ms:.4f} ms, plain "
        f"criss_cross_attention {plain_op_ms:.4f} ms (median of {TIMING_REPS})")
    return report


def phase_bwd_kernels() -> dict:
    """K3/K4 against their plain versions, and the autograd Function's grads
    against torch.autograd of the plain op, at every shape in f32 and bf16
    (and the edge lines of the tensor-core design in bf16). Where the call
    takes the tensor-core design (bf16, lines of at most 128) the plain
    version gets the same bf16 tensors and rounds where the kernels round;
    elsewhere (the CUDA-core pair) it computes in f32. Then times of both
    designs at the sliding shape."""
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    cases = [(torch.float32, s) for s in SHAPES]
    cases += [(torch.bfloat16, s) for s in SHAPES + TC_EDGE_SHAPES]
    for dtype, shape in cases:
        q, k, v = _inputs(shape, dtype, seed=sum(shape) + 1)
        g = _inputs(shape, dtype, seed=sum(shape) + 2)[2]
        q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
        tc = dtype == torch.bfloat16  # every bf16 design rounds p and de as the TPU kernels
        tol = TC_TOL if tc else BWD_TOL[dtype]
        with torch.no_grad():
            out, m, L = K.criss_cross_attention_cuda(q, k, v)
            delta = (g32 * out.float()).sum(dim=-1)
            before = dict(K.LAUNCHES)
            col = K.cca_bwd_col(q, k, v, g, m, L, delta)
            row = K.cca_bwd_row(q, k, v, g, m, L, delta, *col)
            torch.cuda.synchronize()
            moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
            if moved != _add_natural({n: 0 for n in K.LAUNCHES}, shape, dtype, "bwd"):
                raise RuntimeError(f"K3/K4 at {shape} {dtype} launched {moved}")
            ins = (q, k, v, g) if tc else (q32, k32, v32, g32)
            col_p = K.cca_bwd_col_plain(*ins, m, L, delta)
            row_p = K.cca_bwd_row_plain(*ins, m, L, delta, *col)
        errs = {}
        for kern, got_t, want_t in (("K3", col, col_p), ("K4", row, row_p)):
            for name, got, want in zip(("dq", "dk", "dv"), got_t, want_t):
                errs[f"{kern}.{name}"] = _rel_check(f"{kern} {name} at {shape} {dtype}",
                                                    got, want, tol)
        if shape[1] == 1 and any(c.abs().max().item() != 0.0 for c in col):
            raise AssertionError(f"K3 at {shape} {dtype}: H = 1 column grads are not all 0")
        # the Function (K1 K2 K3 K4) vs torch.autograd of the plain op in f32
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        grads = torch.autograd.grad(K.criss_cross_attention_cuda(*leaves)[0], leaves, g)
        leaves32 = [t.detach().clone().requires_grad_(True) for t in (q32, k32, v32)]
        grads_p = torch.autograd.grad(plain.criss_cross_attention(*leaves32), leaves32, g32)
        for name, got, want in zip(("dq", "dk", "dv"), grads, grads_p):
            errs[f"fn.{name}"] = _rel_check(f"Function {name} at {shape} {dtype}",
                                            got, want, BWD_TOL[dtype])
        if shape == SLIDING and dtype == torch.bfloat16:
            for kern, key in (("K3", "cca_bwd_col"), ("K4", "cca_bwd_row")):
                report[key] = {"max_abs_err": max(e for n, e in errs.items()
                                                  if n.startswith(kern))}
        log(f"[bwd] {str(dtype)[6:]} {shape} {_designs(shape, dtype)}: ok "
            f"(K3/K4 tol {tol:g} x scale, Function {BWD_TOL[dtype]:g}) "
            + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))
        del q, k, v, g, out, m, L, delta, col, row, col_p, row_p, leaves, grads, grads_p

    # times at the training shape, bf16, of the tensor-core design, the
    # CUDA-core pair forced at the same shape (the earlier design) and the
    # plain version; the bounds count the column path's grads in the value
    # dtype, as both the TPU function and the tensor-core design write them
    bf16 = torch.bfloat16
    q, k, v = _inputs(SLIDING, bf16, seed=1)
    g = _inputs(SLIDING, bf16, seed=2)[2]
    with torch.no_grad():
        out, m, L = K.criss_cross_attention_cuda(q, k, v)
        delta = (g.float() * out.float()).sum(dim=-1)
        stats = (q, k, v, g, m, L, delta)
        col = K.cca_bwd_col(*stats)
        row = K.cca_bwd_row(*stats, *col)
        report["cca_bwd_col"].update(_bound(stats, _in_value_dtype(col, bf16),
                                            _cca_flops(SLIDING, False, "col"), bf16))
        report["cca_bwd_row"].update(_bound((*stats, *_in_value_dtype(col, bf16)), row,
                                            _cca_flops(SLIDING, False, "row"), bf16))
        del row
        for name, extra in (("cca_bwd_col", ()), ("cca_bwd_row", col)):
            fn, fn_plain = getattr(K, name), getattr(K, f"{name}_plain")
            r = report[name]
            r["ms"] = _time_ms(fn, *stats, *extra)
            r["earlier_ms"] = _time_ms(lambda *a: fn(*a, design="cuda_core"), *stats, *extra)
            r["plain_ms"] = _time_ms(fn_plain, *stats, *extra)
            r.update(design="tensor cores (mma.sync m16n8k16 bf16), one block per line",
                     share=r["bound_ms"] / r["ms"], tflops=r["bound_flops"] / r["ms"] / 1e9)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd(fn):
        return lambda q_, k_, v_, g_: torch.autograd.grad(fn(q_, k_, v_), (q_, k_, v_), g_)

    op_ms = _time_ms(fwd_bwd(lambda *a: K.criss_cross_attention_cuda(*a)[0]), *leaves, g)
    plain_op_ms = _time_ms(fwd_bwd(plain.criss_cross_attention), *leaves, g)
    del col, out, m, L, delta, leaves, stats
    sdpa = _sdpa_yardstick(q, k, v, g)  # forward + backward: the yardstick of K3 + K4
    _log_sdpa("bwd", SLIDING, sdpa)
    for name in ("cca_bwd_col", "cca_bwd_row"):
        r = report[name]
        r["library_ms"] = sdpa[0]
        log(f"[bwd] {name} at {SLIDING} bf16: {r['design']} {r['ms']:.4f} ms ({r['share']:.1%} "
            f"of the bound {r['bound_ms']:.4f} ms by {r['bound_by']}, {r['tflops']:.1f} TFLOP/s); "
            f"earlier design (CUDA cores, two passes, f32 scratch) {r['earlier_ms']:.4f} ms; "
            f"plain {r['plain_ms']:.4f} ms (median of {TIMING_REPS})")
    log(f"[bwd] CCA forward+backward at {SLIDING} bf16: kernels {op_ms:.4f} ms, plain "
        f"criss_cross_attention + autograd {plain_op_ms:.4f} ms (median of {TIMING_REPS})")
    return report


# the two views the line route hands K7a/K7b: (path, masked, view of NHWC)
LINE_PATHS = (("col", True, lambda t: t.transpose(1, 2)), ("row", False, lambda t: t))


def _line_check(shape, dtype, errs: dict, flips: dict) -> None:
    """K7a then K7b on both paths vs their plain versions, from the joint
    stats of the route's own combine. bf16 takes the tensor-core design and
    its plain versions the same bf16 tensors, rounding p and de where the
    kernels do (K7a's o must also be bit-equal to theirs but for at most
    TC_FLIPS of its elements, and the plain version that keeps p in f32
    must differ in more on lines of 64 and longer); f32 the CUDA-core
    design against the f32 plain versions."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    tc = dtype == torch.bfloat16
    tol = TC_TOL if tc else BWD_TOL[dtype]
    round_to = torch.bfloat16 if tc else None
    q, k, v = _inputs(shape, dtype, seed=sum(shape) + 3)
    g = _inputs(shape, dtype, seed=sum(shape) + 4)[2]
    with torch.no_grad():
        before = dict(K.LAUNCHES)
        fwd = {}
        for path, masked, view in LINE_PATHS:
            fwd[path] = K.cca_line_fwd(view(q), view(k), view(v), masked)
            want = K.cca_line_fwd_plain(view(q), view(k), view(v), masked, round_to=round_to)
            want = (want[0].to(v.dtype), *want[1:])
            for name, got, ref in zip(("o", "m", "l"), fwd[path], want):
                errs[f"K7a.{path}.{name}"] = _rel_check(
                    f"K7a {path} {name} at {shape} {dtype}", got, ref, tol)
            if tc:
                flips[f"K7a.{path}.o"] = _flipped(fwd[path][0], want[0])
                unrounded = K.cca_line_fwd_plain(*(view(t).float() for t in (q, k, v)), masked)[0]
                flips[f"unrounded.{path}.o"] = _flipped(unrounded.to(v.dtype), want[0])
                if flips[f"K7a.{path}.o"] > TC_FLIPS:
                    raise AssertionError(f"K7a {path} at {shape}: {flips}, over {TC_FLIPS:g}")
                if view(q).shape[2] >= 64 and flips[f"unrounded.{path}.o"] <= TC_FLIPS:
                    raise AssertionError(f"K7a {path} at {shape}: the unrounded plain version is "
                                         f"within {TC_FLIPS:g} of the rounding one: {flips}")
        o_c, m_c, l_c = (K._to_col(t) for t in fwd["col"])
        out, m, L = K._combine(o_c.float(), m_c, l_c, fwd["row"][0].float(), *fwd["row"][1:])
        delta = (g.float() * out).sum(dim=-1)
        for path, masked, view in LINE_PATHS:
            args = [view(t) for t in (q, k, v, g, m, L, delta)]
            got = K.cca_line_bwd(*args, masked)
            want = K.cca_line_bwd_plain(*args, masked, round_to=round_to)
            for name, a, b in zip(("dq", "dk", "dv"), got, want):
                errs[f"K7b.{path}.{name}"] = _rel_check(f"K7b {path} {name} at {shape} {dtype}",
                                                        a, b.to(a.dtype), tol)
                if tc:
                    flips[f"K7b.{path}.{name}"] = _flipped(a, b.to(a.dtype))
        torch.cuda.synchronize()
        moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
        if moved != {**{n: 0 for n in K.LAUNCHES}, "cca_line_fwd": 2, "cca_line_bwd": 2,
                     "cca_line_fwd_tc": 2 * tc, "cca_line_bwd_tc": 2 * tc}:
            raise RuntimeError(f"K7a/K7b at {shape} {dtype} launched {moved}")
    if shape[1] == 1 and not (torch.all(fwd["col"][1] == -1e9) and torch.all(fwd["col"][2] == 1.0)
                              and torch.equal(fwd["col"][0].to(v.dtype), K._to_col(v))):
        raise AssertionError(f"K7a at {shape} {dtype}: the all-self-slot column is not "
                             f"(o = v, m = -1e9, l = 1)")


def phase_line_kernels() -> dict:
    """K7a/K7b against their plain versions on both paths as the line route
    calls them (columns through the transposed view, masked; rows), and the
    routed Function's output and grads against torch.autograd of the plain
    op, at every line shape in f32 and bf16 (and the tensor-core design's
    edge lines in bf16). Then CUDA-event times at the long shapes: each
    kernel in both designs vs its plain version, and the route's forward
    and forward + backward vs K1–K4 forced at the same shape and vs the
    plain op."""
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"cca_line_fwd": {"max_abs_err": 0.0}, "cca_line_bwd": {"max_abs_err": 0.0}}
    cases = [(torch.float32, s) for s in LINE_SHAPES]
    cases += [(torch.bfloat16, s) for s in LINE_SHAPES + LINE_TC_EDGE_SHAPES]
    for dtype, shape in cases:
        errs, flips = {}, {}
        _line_check(shape, dtype, errs, flips)
        if shape in LINE_SHAPES:  # the routed Function vs torch.autograd of the plain op in f32
            q, k, v = _inputs(shape, dtype, seed=sum(shape) + 3)
            g = _inputs(shape, dtype, seed=sum(shape) + 4)[2]
            f32 = [t.float() for t in (q, k, v, g)]
            before = dict(K.LAUNCHES)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            out_fn = K.criss_cross_attention_cuda(*leaves)[0]
            grads = torch.autograd.grad(out_fn, leaves, g)
            leaves32 = [t.detach().clone().requires_grad_(True) for t in f32[:3]]
            out_p = plain.criss_cross_attention(*leaves32)
            grads_p = torch.autograd.grad(out_p, leaves32, f32[3])
            torch.cuda.synchronize()
            moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
            want = _cca_want(shape, dtype, fwd=1, bwd=1)
            if moved != want:
                raise AssertionError(f"the Function at {shape} {dtype} launched {moved}, "
                                     f"not {want}")
            tol = BWD_TOL[dtype]
            errs["fn.out"] = _rel_check(f"Function out at {shape} {dtype}", out_fn, out_p, tol)
            for name, a, b in zip(("dq", "dk", "dv"), grads, grads_p):
                errs[f"fn.{name}"] = _rel_check(f"Function {name} at {shape} {dtype}", a, b, tol)
            del q, k, v, g, f32, leaves, out_fn, grads, leaves32, out_p, grads_p
        if shape == LINE_SHAPES[0] and dtype == torch.bfloat16:
            for kern, key in (("K7a", "cca_line_fwd"), ("K7b", "cca_line_bwd")):
                report[key]["max_abs_err"] = max(e for n, e in errs.items() if n.startswith(kern))
        log(f"[lines] {str(dtype)[6:]} {shape} "
            f"{'tensor cores' if dtype == torch.bfloat16 else 'CUDA cores'}: ok (kernels tol "
            f"{TC_TOL if dtype == torch.bfloat16 else BWD_TOL[dtype]:g} x scale, Function "
            f"{BWD_TOL[dtype]:g}) " + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
            + (" flipped " + " ".join(f"{n}={x:.2e}" for n, x in flips.items()) if flips else ""))
        torch.cuda.empty_cache()

    def line_fwd(fn):
        return lambda q, k, v: [fn(view(q), view(k), view(v), masked)
                                for _, masked, view in LINE_PATHS]

    def line_bwd(fn):
        return lambda *qkvgmld: [fn(*(view(t) for t in qkvgmld), masked)
                                 for _, masked, view in LINE_PATHS]

    def k1_k4(q, k, v, g):  # the natural route forced at a long shape (K7a/K7b's kernels)
        o, m_, L_ = K.cca_fwd_row(q, k, v, *K.cca_fwd_col(q, k, v))
        d = (g.float() * o.float()).sum(dim=-1)
        K.cca_bwd_row(q, k, v, g, m_, L_, d, *K.cca_bwd_col(q, k, v, g, m_, L_, d))

    def fwd_bwd(fn):
        return lambda q, k, v, g: torch.autograd.grad(fn(q, k, v), (q, k, v), g)

    bf16 = torch.bfloat16
    cuda_core = {"design": "cuda_core"}
    rounding = {"round_to": bf16}
    for shape in LINE_SHAPES[:2]:  # the long shapes, bf16
        q, k, v = _inputs(shape, bf16, seed=1)
        g = _inputs(shape, bf16, seed=2)[2]
        with torch.no_grad():
            out, m, L = K.criss_cross_attention_cuda(q, k, v)
            delta = (g.float() * out.float()).sum(dim=-1)
            stats = (q, k, v, g, m, L, delta)
            if shape == LINE_SHAPES[0]:  # the CUDA-core design forced here: the f32 function
                f32 = [t.float() for t in stats[:4]]
                for kern, got_t, want_t in (
                        ("K7a", line_fwd(lambda *a: K.cca_line_fwd(*a, **cuda_core))(q, k, v),
                         line_fwd(K.cca_line_fwd_plain)(*f32[:3])),
                        ("K7b", line_bwd(lambda *a: K.cca_line_bwd(*a, **cuda_core))(*stats),
                         line_bwd(K.cca_line_bwd_plain)(*f32, m, L, delta))):
                    for p, (got_p, want_p) in enumerate(zip(got_t, want_t)):
                        for i, (got, want) in enumerate(zip(got_p, want_p)):
                            _rel_check(f"{kern} CUDA-core design path {p} output {i} at {shape}",
                                       got, want, BWD_TOL[bf16])
                del f32, got_t, want_t
            t = {"K7a": _time_ms(line_fwd(K.cca_line_fwd), q, k, v),
                 "K7a CUDA-core": _time_ms(line_fwd(
                     lambda *a: K.cca_line_fwd(*a, **cuda_core)), q, k, v),
                 "K7a plain": _time_ms(line_fwd(
                     lambda *a: K.cca_line_fwd_plain(*a, **rounding)), q, k, v),
                 "K7b": _time_ms(line_bwd(K.cca_line_bwd), *stats),
                 "K7b CUDA-core": _time_ms(line_bwd(
                     lambda *a: K.cca_line_bwd(*a, **cuda_core)), *stats),
                 "K7b plain": _time_ms(line_bwd(
                     lambda *a: K.cca_line_bwd_plain(*a, **rounding)), *stats),
                 "route fwd": _time_ms(K.cca_line_route_fwd, q, k, v),
                 "K1+K2 fwd": _time_ms(lambda *a: K.cca_fwd_row(*a, *K.cca_fwd_col(*a)), q, k, v),
                 "plain fwd": _time_ms(plain.criss_cross_attention, q, k, v),
                 "K1-K4 fwd+bwd": _time_ms(k1_k4, q, k, v, g)}
        leaves = [t_.detach().clone().requires_grad_(True) for t_ in (q, k, v)]
        t["route fwd+bwd"] = _time_ms(fwd_bwd(lambda *a: K.criss_cross_attention_cuda(*a)[0]),
                                      *leaves, g)
        t["plain fwd+bwd"] = _time_ms(fwd_bwd(plain.criss_cross_attention), *leaves, g)
        with torch.no_grad():  # both paths of one call, as timed
            fwd_out = [e for o, m_, l_ in line_fwd(K.cca_line_fwd)(q, k, v) for e in (o, m_, l_)]
            bwd_out = [e for grads in line_bwd(K.cca_line_bwd)(*stats) for e in grads]
        bounds = {"K7a": _bound((q, k, v), fwd_out,
                                sum(_cca_flops(shape, True, p) for p in ("col", "row")), bf16),
                  "K7b": _bound(stats, bwd_out,
                                sum(_cca_flops(shape, False, p) for p in ("col", "row")), bf16)}
        # K7b's dq parts: ceil(N / 64) x pixels x Cq f32 per path, written and read back
        B, H, W, Cq, _ = shape
        dq_part_mb = sum(-(-n // 64) for n in (H, W)) * B * H * W * Cq * 4 * 2 / 1e6
        del fwd_out, bwd_out, out, m, L, delta, leaves, stats
        torch.cuda.empty_cache()
        if shape == LINE_SHAPES[0]:  # the yardstick's row-or-column mask is 1.1 GB here
            fwd_sdpa, bwd_sdpa = _sdpa_yardstick(q, k, v), _sdpa_yardstick(q, k, v, g)
            _log_sdpa("lines fwd", shape, fwd_sdpa)
            _log_sdpa("lines fwd+bwd", shape, bwd_sdpa)
            design = ("tensor cores (mma.sync m16n8k16 bf16), keys tiled by 64, p rounded to bf16 "
                      "after the line's max")
            for kern, key, sdpa in (("K7a", "cca_line_fwd", fwd_sdpa),
                                    ("K7b", "cca_line_bwd", bwd_sdpa)):
                r = report[key]
                r.update(ms=t[kern], earlier_ms=t[f"{kern} CUDA-core"], plain_ms=t[f"{kern} plain"],
                         library_ms=sdpa[0], **bounds[kern])
                r.update(design=design, share=r["bound_ms"] / r["ms"],
                         tflops=r["bound_flops"] / r["ms"] / 1e9)
        else:
            log(f"[lines] library yardstick at {shape}: not run, its (H·W)² bool mask would "
                f"take {(shape[1] * shape[2]) ** 2 / 1e9:.1f} GB")
        log(f"[lines] times at {shape} bf16, ms (median of {TIMING_REPS}; K7a/K7b: both paths "
            f"of one call, two launches; plain: the rounding plain versions on the bf16 tensors): "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in t.items())
            + "; bounds " + ", ".join(
                f"{n} {b['bound_ms']:.4f} ms by {b['bound_by']} ({b['bound_ms'] / t[n]:.1%} of "
                f"it; {b['bound_bytes'] / 1e6:.1f} MB, port {b['port_bytes'] / 1e6:.1f} MB, "
                f"{b['bound_flops'] / 1e9:.1f} GFLOP)" for n, b in bounds.items())
            + f"; K7b also writes and reads {dq_part_mb:.1f} MB of dq parts")
    return report


def _loss_case(shape, seed, live: float = 1.0):
    """logits, int32 labels (15 % ignore) and g, nonzero on a share ``live``
    of the pixels."""
    B, h, w, C, r = shape
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32)).cuda()
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.15] = 255  # ignore pixels
    g = rng.rand(B, H, W).astype(np.float32)
    g[rng.rand(B, H, W) >= live] = 0.0
    return logits, torch.from_numpy(labels).cuda(), torch.from_numpy(g).cuda()


def phase_loss_kernels() -> dict:
    """K5/K6 against the materialised upsample + NLL and its autograd, int32
    and uint8 labels, at every shape of LOSS_SHAPES, with a dense g and, at
    the 769² shape, a g nonzero on SPARSE_G of the pixels and one zero
    everywhere; then :func:`loss_times` and :func:`criterion_ab`."""
    from ccnet_tpu_torch.ops import upsampled_ce as U

    errs = {}
    cases = [(shape, 1.0) for shape in LOSS_SHAPES] + [(LOSS_SHAPES[0], SPARSE_G),
                                                       (LOSS_SHAPES[0], 0.0)]
    for shape, live in cases:
        logits, labels, g = _loss_case(shape, seed=sum(shape), live=live)
        errs = {}
        for lab in (labels, labels.to(torch.uint8)):
            before = dict(U.LAUNCHES)
            nll = U.upsampled_nll_fwd(logits, lab)
            dl = U.upsampled_nll_bwd(logits, lab, g)
            x = logits.clone().requires_grad_(True)
            fn_nll = U.UpsampledNLLFn.apply(x, lab)
            (fn_dl,) = torch.autograd.grad(fn_nll, x, g)
            torch.cuda.synchronize()
            if U.LAUNCHES != {n: c + 2 for n, c in before.items()}:
                raise RuntimeError(f"launch counts did not advance: {before} -> {U.LAUNCHES}")
            want_nll = U.upsampled_nll_reference(logits, lab)
            want_dl = U.upsampled_nll_bwd_plain(logits, lab, g)
            tag = f"{shape} {str(lab.dtype)[6:]} labels, g live on {live:.0%}"
            if live == 0.0 and float(dl.abs().max()) != 0.0:
                raise AssertionError(f"K6 at {tag}: a zero g gives a nonzero gradient")
            for name, got, want, tol in (("K5", nll, want_nll, NLL_TOL),
                                         ("fn.fwd", fn_nll, want_nll, NLL_TOL),
                                         ("K6", dl, want_dl, NLL_GRAD_TOL),
                                         ("fn.bwd", fn_dl, want_dl, NLL_GRAD_TOL)):
                err = (got - want).abs().max().item()
                limit = tol * (1.0 if name in ("K5", "fn.fwd") else want.abs().max().item())
                if not err <= limit:
                    raise AssertionError(f"{name} at {tag}: max abs err {err:.3e} > {limit:.3e}")
                errs[name] = max(errs.get(name, 0.0), err)
            del nll, dl, x, fn_nll, fn_dl, want_nll, want_dl
        if shape == LOSS_SHAPES[0] and live == 1.0:
            report = {"upsampled_nll_fwd": {"max_abs_err": errs["K5"]},
                      "upsampled_nll_bwd": {"max_abs_err": errs["K6"]}}
        log(f"[loss] {shape} (B, h, w, C, r), int32 and uint8 labels, g live on {live:.0%}: ok "
            f"(K5 <= {NLL_TOL:g} abs, K6 <= {NLL_GRAD_TOL:g} x max|plain grad|) "
            + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))
        del logits, labels, g
        torch.cuda.empty_cache()
    for name, r in loss_times().items():
        report[name].update(r)
    criterion_ab()
    return report


def loss_times() -> dict:
    """CUDA-event times of K5 and K6 and of their plain versions at the
    shapes of LOSS_TIMED, K6 with a dense g and with one live on SPARSE_G of
    the pixels, each beside its bound; returns the 769² numbers as the
    report's. Uses only what every version of ``ccnet_tpu_torch`` has, so
    it also times an earlier tree's kernels (run from its checkout)."""
    from ccnet_tpu_torch.ops import upsampled_ce as U

    report = {}
    for tag, shape in LOSS_TIMED.items():
        B, h, w, C, r = shape
        t, b = {}, {}
        for live in (1.0, SPARSE_G, 0.0):  # g = 0: K6's cost without a softmax
            logits, labels, g = _loss_case(shape, seed=7, live=live)
            kind = {1.0: "dense", SPARSE_G: "sparse", 0.0: "zero g"}[live]
            t[f"K6 {kind}"] = _time_ms(U.upsampled_nll_bwd, logits, labels, g)
            # the operations the function needs per live fine pixel and class:
            # the height lerp (2), the width lerp shared by r rows (~1), exp
            # and sum (2); the backward twice that (recompute, then the
            # transposed lerps); every valid pixel's nll, the live pixels' grad
            valid = int((labels != 255).sum())
            active = int(((labels != 255) & (g != 0)).sum())
            b[f"K6 {kind}"] = _bound((logits, labels, g), (U.upsampled_nll_bwd(logits, labels, g),),
                                     10 * C * active, torch.float32)
            if live == 1.0:
                t["K5"] = _time_ms(U.upsampled_nll_fwd, logits, labels)
                t["K5 plain"] = _time_ms(U.upsampled_nll_reference, logits, labels)
                b["K5"] = _bound((logits, labels), (U.upsampled_nll_fwd(logits, labels),),
                                 5 * C * valid, torch.float32)
                graphs = []  # one graph per copy of the inputs, its backward timed alone
                for lg, lab, gg in _copies((logits, labels, g)):
                    x = lg.clone().requires_grad_(True)
                    graphs.append((U.upsampled_nll_reference(x, lab), x, gg))
                t["K6 plain"] = _time_ms(
                    lambda nll, x, g_: torch.autograd.grad(nll, x, g_, retain_graph=True),
                    sets=graphs)
                del graphs
            del logits, labels, g
            torch.cuda.empty_cache()
        log(f"[loss] times at {shape} (B, h, w, C, r) -> {tag}, ms (median of {TIMING_REPS}): "
            + ", ".join(f"{n} {ms:.4f}" for n, ms in t.items())
            + f"; K6 dense / sparse {t['K6 dense'] / t['K6 sparse']:.2f}; bounds "
            + ", ".join(f"{n} {x['bound_ms']:.4f} ms by {x['bound_by']} ({x['bound_ms'] / t[n]:.1%} "
                        f"of it; {x['bound_bytes'] / 1e6:.1f} MB, {x['bound_flops'] / 1e9:.2f} GFLOP)"
                        for n, x in b.items()))
        if shape == LOSS_SHAPES[0]:
            for name, kern in (("upsampled_nll_fwd", "K5"), ("upsampled_nll_bwd", "K6 dense")):
                plain = t[f"{kern.split()[0]} plain"]
                report[name] = {"ms": t[kern], "plain_ms": plain, "library_ms": None, **b[kern],
                                "share": b[kern]["bound_ms"] / t[kern],
                                "design": "one block per (image, coarse band or row, tile of "
                                          "coarse columns), the band in shared memory"}
            report["upsampled_nll_bwd"]["sparse_ms"] = t["K6 sparse"]
    for name in report:  # F.interpolate + F.cross_entropy: two calls
        log(f"[loss] {name}: no one library call computes it")
    return report


def criterion_ab(reps: int = CRITERION_AB_REPS) -> dict:
    """``criterion_ohem_dsn`` forward + backward at the 769² step's main and
    DSN logits (8, 19, 97, 97) f32 and labels (8, 769, 769): the kernel
    route (K5/K6) against the plain route (materialised upsample), the two
    agreeing first, then timed in turns (kernel, plain, plain, kernel, ...)
    after one untimed call of each; returns the medians (ms)."""
    from ccnet_tpu_torch.losses import criterion_ohem_dsn

    B, h, w, C, r = LOSS_SHAPES[0]
    rng = np.random.RandomState(11)
    heads = [torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32)).cuda().requires_grad_(True)
             for _ in range(2)]
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    y = rng.randint(0, C, (B, H, W)).astype(np.int32)
    y[rng.rand(B, H, W) < 0.1] = 255
    y = torch.from_numpy(y).cuda()

    def step(impl):
        loss = criterion_ohem_dsn({"main": heads[0], "aux": heads[1]}, y, impl=impl)
        return (loss, *torch.autograd.grad(loss, heads))

    got = {impl: step(impl) for impl in ("kernel", "torch")}
    rel = abs(got["kernel"][0].item() - got["torch"][0].item()) / abs(got["torch"][0].item())
    gerr = max((a - b).abs().max().item() / b.abs().max().item()
               for a, b in zip(got["kernel"][1:], got["torch"][1:]))
    del got
    times = {"kernel": [], "torch": []}
    for rep in range(reps):
        for impl in ("kernel", "torch") if rep % 2 == 0 else ("torch", "kernel"):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            step(impl)
            end.record()
            end.synchronize()
            times[impl].append(start.elapsed_time(end))
    med = {impl: float(np.median(v)) for impl, v in times.items()}
    log(f"[loss] criterion_ohem_dsn forward + backward at main/DSN {(B, C, h, w)} -> {H}x{W}, "
        f"the two NLL routes in turns: kernel median {med['kernel']:.4f} ms, plain median "
        f"{med['torch']:.4f} ms, kernel faster by {med['torch'] - med['kernel']:.4f} ms (CUDA "
        f"events, {reps} each; kernel {' '.join(f'{v:.4f}' for v in times['kernel'])}; plain "
        f"{' '.join(f'{v:.4f}' for v in times['torch'])}); loss rel diff {rel:.2e}, grads "
        f"{gerr:.2e} x max")
    if not rel <= 1e-4 or not gerr <= NLL_GRAD_TOL * 10:
        raise AssertionError(f"criterion_ohem_dsn: kernel route disagrees (loss {rel:.2e}, "
                             f"grads {gerr:.2e})")
    del heads, y
    torch.cuda.empty_cache()
    return med


# the probes: wrapper -> (the script's shape, the model's shape, input dtype);
# P1, P2, P3 at the model's widths: one image's columns of q (H, W, 64) and
# of v (H, W, 512), and a scale over an f32 tensor of o_col's size (8·97·97, 512)
PROBES = {
    "mid_batch_dot": ((96, 16, 64), (97, 97, 64), torch.bfloat16),
    "swap_leading": ((96, 16, 128), (97, 97, 512), torch.bfloat16),
    "scale_ragged": ((97, 256), (8 * 97 * 97, 512), torch.float32),
    "mid_batch_dot_4d": ((2, 96, 33, 64), (8, 97, 97, 64), torch.bfloat16),
    "store_transposed": ((2, 96, 33, 512), (8, 97, 97, 512), torch.bfloat16),
}
PROBE_DOT_TOL = 1e-4  # x scale: the same bf16 products, f32 sums in another order
# the dot's other paths (csrc/probes.cu): (wrapper, shape, first element's offset);
# one pixel, scalar staging (C % 8 != 0, or a base 2 bytes past 16), bands
# past 64 tiles (H = 231), three channel chunks, P4 with bands of a ragged line
PROBE_DOT_EDGES = [("mid_batch_dot", (1, 1, 8), 0), ("mid_batch_dot", (7, 3, 70), 0),
                   ("mid_batch_dot", (97, 97, 64), 1), ("mid_batch_dot", (231, 2, 64), 0),
                   ("mid_batch_dot", (97, 97, 136), 0), ("mid_batch_dot_4d", (1, 33, 5, 8), 0)]
PROBE_HOST_CALLS = 200  # back-to-back calls timed on the host's clock
PROBE_TRACE_CALLS = 20  # back-to-back calls traced by torch.profiler


def _probe_inputs(name: str, shape) -> list:
    _, _, dtype = PROBES[name]
    rng = np.random.RandomState(sum(shape))
    return [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to("cuda", dtype)
            for _ in range(2 if "dot" in name else 1)]


def _probe_library(name: str):
    """The one PyTorch call computing probe ``name``'s function: a bf16
    ``einsum`` for the dots, the plain version (``contiguous()``, ``2*x``)
    for the copies and the scale."""
    from ccnet_tpu_torch.ops import probes as P

    if "dot" not in name:
        return getattr(P, f"{name}_plain")
    eq = "htc,gtc->thg" if name == "mid_batch_dot" else "bhwc,bgwc->bwhg"
    return lambda *a: torch.einsum(eq, *a)


def _device_us(fn, sets) -> tuple:
    """(device µs per call, kernels per call) of PROBE_TRACE_CALLS
    back-to-back ``fn`` calls under ``torch.profiler``, from the exported
    chrome trace's kernel events (their device time alone). A trace now and
    then comes back without its kernel events; it is taken again, up to
    three times in all, and then reported as not measured (None, None)."""
    from torch.profiler import ProfilerActivity, profile

    calls = itertools.cycle(sets)
    for _ in range(3):
        fn(*next(calls))
    for _ in range(3):
        torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as d:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                keep = [fn(*next(calls)) for _ in range(PROBE_TRACE_CALLS)]
                torch.cuda.synchronize()
            del keep
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                durs = [e["dur"] for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
        if durs:
            return sum(durs) / PROBE_TRACE_CALLS, len(durs) / PROBE_TRACE_CALLS
    log("[probe-times] torch.profiler recorded no kernel on the card in three traces: "
        "device time not measured")
    return None, None


def _host_us(fn, sets) -> float:
    """Host wall µs per call of back-to-back ``fn`` calls with no
    synchronise between them, the pace at which the host issues the work
    whatever the device does with it: the median over 10 rounds of
    PROBE_HOST_CALLS / 10 calls (the host's cores are shared)."""
    calls = itertools.cycle(sets)
    for _ in range(3):
        fn(*next(calls))
    n, rounds = PROBE_HOST_CALLS // 10, []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*next(calls))
        rounds.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return float(np.median(rounds))


def probe_times(names=tuple(PROBES)) -> dict:
    """At the model's shapes, for each probe of ``names``: the burst time
    of :func:`_time_ms` (``ms``) of the kernel, of its plain version and of
    the one library call, and for the kernel and the library call the
    device µs and host µs per call (:func:`_device_us`, :func:`_host_us`);
    the burst time is about the larger of the two. Uses only what every
    version of ``ccnet_tpu_torch.ops.probes`` has, so it also times an
    earlier tree's kernels (run from its checkout)."""
    from ccnet_tpu_torch.ops import probes as P

    report = {}
    for name in names:
        shape = PROBES[name][1]
        sets = _copies(_probe_inputs(name, shape))
        kernel, plain, library = getattr(P, name), getattr(P, f"{name}_plain"), _probe_library(name)
        r = {"ms": _time_ms(kernel, sets=sets), "library_ms": _time_ms(library, sets=sets)}
        r["plain_ms"] = _time_ms(plain, sets=sets) if "dot" in name else r["library_ms"]
        r["device_us"], r["kernels_per_call"] = _device_us(kernel, sets)
        r["host_us"] = _host_us(kernel, sets)
        r["library_device_us"], r["library_kernels_per_call"] = _device_us(library, sets)
        r["library_host_us"] = _host_us(library, sets)
        report[name] = r
        us = {k: "not measured" if v is None else f"{v:.2f}" for k, v in r.items()}
        log(f"[probe-times] {name} at {shape}: kernel burst {r['ms'] * 1e3:.2f} µs/call, device "
            f"{us['device_us']} µs/call ({us['kernels_per_call']} kernels), host "
            f"{us['host_us']} µs/call; library burst {r['library_ms'] * 1e3:.2f}, device "
            f"{us['library_device_us']} ({us['library_kernels_per_call']} kernels), host "
            f"{us['library_host_us']}; plain burst {r['plain_ms'] * 1e3:.2f} (bursts: median "
            f"of {TIMING_REPS}; device: {PROBE_TRACE_CALLS} calls under torch.profiler; host: "
            f"median of 10 rounds of {PROBE_HOST_CALLS // 10} calls, no synchronise)")
        del sets
    torch.cuda.empty_cache()
    return report


# design variants of csrc/probes.cu's copy and scale kernels, as text edits
# of the source: (old, new) pairs, each of which must occur
PROBE_VARIANTS = {
    "streaming hints": [
        ("v[u] = x[(a * p.b + b) * p.r + (i - row * p.r)];",
         "v[u] = __ldcs(&x[(a * p.b + b) * p.r + (i - row * p.r)]);"),
        ("if (i < plane) y[i] = v[u];", "if (i < plane) __stcs(&y[i], v[u]);"),
        ("if (i < p.body) v[u] = x4[i];", "if (i < p.body) v[u] = __ldcs(&x4[i]);"),
        ("if (i < p.body) y4[i] = make_float4(v[u].x * s, v[u].y * s, v[u].z * s, v[u].w * s);",
         "if (i < p.body) __stcs(&y4[i], make_float4(v[u].x * s, v[u].y * s, v[u].z * s, "
         "v[u].w * s));")],
    "128 threads x 2 loads": [
        ("constexpr int COPY_THREADS = 256;", "constexpr int COPY_THREADS = 128;"),
        ("constexpr int COPY_UNROLL = 1;", "constexpr int COPY_UNROLL = 2;")],
    "256 threads x 4 loads": [("constexpr int COPY_UNROLL = 1;", "constexpr int COPY_UNROLL = 4;")],
}


def _probes_variant(name: str, edits) -> tuple:
    """``csrc/probes.cu`` with the text ``edits`` ((old, new) pairs, each of
    which must occur), built by its own ``nvcc`` under the build directory:
    (name, (the declared ctypes library, the edited source))."""
    import ctypes
    import shutil

    from ccnet_tpu_torch.ops import _build
    from ccnet_tpu_torch.ops import probes as P

    text = (_build.CSRC / "probes.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"variant {name!r}: {old!r} not in csrc/probes.cu")
        text = text.replace(old, new)
    d = _build.BUILD_DIR / "variants" / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    for f in _build.CSRC.glob("*.cuh"):
        shutil.copy(f, d / f.name)
    (d / "probes.cu").write_text(text)
    so = d / "libprobes.so"
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(so),
                           str(d / "probes.cu")], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for variant {name!r}:\n{proc.stderr}")
    return name, (P.declare(ctypes.CDLL(str(so))), text)


def probe_variants(rounds: int = 2) -> dict:
    """Device µs (:func:`_device_us`) of the probe copy (P2 and P5 at the
    model's shapes) and scale (P3) kernels: this source's design, the
    variants of PROBE_VARIANTS (each built by its own ``nvcc``), this design
    on grids of one and of four waves (2048 threads on each SM) striding
    over the tiles instead of one tile per block, and the one library call;
    each checked bit-exact, all timed in ``rounds`` turns (the order
    reversed every other round). Returns {(variant, grid, probe): [µs]}."""
    from concurrent.futures import ThreadPoolExecutor

    from ccnet_tpu_torch.ops import probes as P

    def build(name):
        name, (lib, text) = _probes_variant(name, PROBE_VARIANTS.get(name, ()))
        threads, unroll = (int(text.split(f"constexpr int {k} = ")[1].split(";")[0])
                           for k in ("COPY_THREADS", "COPY_UNROLL"))
        return name, (lib, threads, unroll)

    names = ["this design", *PROBE_VARIANTS]
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(ex.map(build, names))
    wave = torch.cuda.get_device_properties(0).multi_processor_count * 2048
    cases = {"swap_leading": (1, 97, 97), "store_transposed": (8, 97, 97), "scale_ragged": None}
    sets = {name: _copies(_probe_inputs(name, PROBES[name][1])) for name in cases}
    runs = [(v, "one tile per block") for v in names]
    runs += [("this design", g) for g in ("1 wave", "4 waves")] + [("library", "one call")]

    def launcher(variant, grid, name):
        if variant == "library":
            return _probe_library(name)
        lib, threads, unroll = libs[variant]
        waves = {"1 wave": 1, "4 waves": 4}.get(grid)
        x = sets[name][0][0]
        if name == "scale_ragged":  # fresh tensors: 16-byte aligned, no head
            body = x.numel() // 4
            plan = P.ScalePlan(0, body, x.numel() % 4, -(-body // (threads * unroll)))
            if waves:
                plan = plan._replace(blocks=min(plan.blocks, waves * wave // threads))
            c = P._ScalePlanC(*plan)
            return lambda t: _probe_call(lib.probe_scale, t, torch.empty_like(t), c, 2.0)
        n, a, b = cases[name]
        r = x.shape[-1] // 8
        plan = P.SwapPlan(n, a, b, r, *P.fast_divider(r), *P.fast_divider(a),
                          -(-a * b * r // (threads * unroll)))
        if waves:
            plan = plan._replace(blocks=max(1, min(plan.blocks, waves * wave // threads // n)))
        c = P._SwapPlanC(*plan)
        shape = (b, a, x.shape[-1]) if n == 1 else (n, b, a, x.shape[-1])
        return lambda t: _probe_call(lib.probe_swap_leading, t,
                                     torch.empty(shape, device=t.device, dtype=t.dtype), c)

    times = {}
    for rnd in range(rounds):
        for variant, grid in (runs if rnd % 2 == 0 else runs[::-1]):
            for name in cases:
                fn = launcher(variant, grid, name)
                x = sets[name][0][0]
                if not torch.equal(fn(x), getattr(P, f"{name}_plain")(x)):
                    raise AssertionError(f"{name}, {variant} on {grid}: not bit-exact")
                times.setdefault((variant, grid, name), []).append(_device_us(fn, sets[name])[0])
    for name in cases:
        log(f"[probe-variants] {name} at {PROBES[name][1]}, device µs per call ({rounds} rounds "
            f"in turns): " + "; ".join(f"{v} on {g} " + " ".join(
                "not measured" if t is None else f"{t:.2f}" for t in ts)
                                       for (v, g, n), ts in times.items() if n == name))
    del sets
    torch.cuda.empty_cache()
    return times


# what holds the dot back, as text edits of csrc/probes.cu that each leave
# out one phase of its work (their results are wrong, so they are timed only)
DOT_DIAGNOSTICS = {
    "no global stores": [("for (int i = threadIdx.x; i < body; i += 32 * WARPS) out4[i] = es4[i];",
                          "")],
    "no products": [("mma_2(acc[i][0], acc[i][1], a, b);",
                     "acc[i][0][0] += __uint_as_float(a[0] ^ b[0]);")],
    "no shared-memory band": [("if (r < w.bh && g < H) es[r * H + g] = acc[i][j >> 2][j & 3];",
                               "if (r < w.bh && g < H && acc[i][j >> 2][j & 3] == 1.2345f) "
                               "es[r * H + g] = 0.f;")],
}
# ... and the staging alone: no products, no band, no stores
DOT_DIAGNOSTICS["loads alone"] = [*DOT_DIAGNOSTICS["no global stores"],
                                  *DOT_DIAGNOSTICS["no products"],
                                  *DOT_DIAGNOSTICS["no shared-memory band"]]
# ... everything but the loads; and the launch of blocks that do nothing
DOT_DIAGNOSTICS["no loads"] = [
    ("cp_async16(dst + r * KP + j, valid ? src + r * sH + c0 + j : src, valid);", "(void)valid;")]
DOT_DIAGNOSTICS["empty blocks"] = [
    ("  extern __shared__ __align__(16) unsigned char smem[];\n  const int band_p",
     "  extern __shared__ __align__(16) unsigned char smem[];\n  if (p.H > 0) return;\n"
     "  const int band_p")]


def dot_diagnostics(rounds: int = 2) -> dict:
    """Device µs (:func:`_device_us`) of P1 and P4 at the model's shapes on
    this source and on each DOT_DIAGNOSTICS variant, under ``dot_plan``'s
    plan, in ``rounds`` turns: the time a phase costs is what leaving it
    out saves. Returns {(probe, variant): [µs]}."""
    from concurrent.futures import ThreadPoolExecutor

    from ccnet_tpu_torch.ops import probes as P

    names = ["this design", *DOT_DIAGNOSTICS]
    with ThreadPoolExecutor(len(names)) as ex:
        libs = dict(ex.map(lambda n: _probes_variant(n, DOT_DIAGNOSTICS.get(n, ())), names))
    for name in ("mid_batch_dot", "mid_batch_dot_4d"):
        plan = P.dot_plan(*_dot_layout(name, PROBES[name][1]))
        resident = P.dot_occupancy(plan.warps, plan.smem)
        log(f"[dot-diagnostics] {name}: {plan}; {resident} blocks resident per SM")
    times = {}
    for rnd in range(rounds):
        for name in ("mid_batch_dot", "mid_batch_dot_4d"):
            shape = PROBES[name][1]
            N, T, H, C, strides = _dot_layout(name, shape)
            c = P._DotPlanC(*P.dot_plan(N, T, H, C, strides))
            sets = _copies(_probe_inputs(name, shape))
            for variant in (names if rnd % 2 == 0 else names[::-1]):
                lib = libs[variant][0]

                def fn(q, k, lib=lib):
                    e = torch.empty((N, T, H, H), device=q.device, dtype=torch.float32)
                    return _probe_call(lib.probe_mid_batch_dot, q, k, c, out=e)
                if variant == "this design":
                    want = getattr(P, f"{name}_plain")(*sets[0])
                    _rel_check(f"{name} {variant}", fn(*sets[0]).reshape(want.shape), want,
                               PROBE_DOT_TOL)
                times.setdefault((name, variant), []).append(_device_us(fn, sets)[0])
            del sets
    for name in ("mid_batch_dot", "mid_batch_dot_4d"):
        log(f"[dot-diagnostics] {name} at {PROBES[name][1]}, device µs per call ({rounds} "
            f"rounds in turns): " + "; ".join(f"{v} " + " ".join(
                "not measured" if t is None else f"{t:.2f}" for t in ts)
                                           for (n, v), ts in times.items() if n == name))
    torch.cuda.empty_cache()
    return times


def _dot_layout(name: str, shape) -> tuple:
    """(N, T, H, C, element strides) of probe ``name``'s dot at ``shape``."""
    if name == "mid_batch_dot":
        H, T, C = shape
        return 1, T, H, C, (0, T * C, C)
    N, H, T, C = shape
    return N, T, H, C, (H * T * C, T * C, C)


def dot_variants(rounds: int = 2) -> dict:
    """Device µs (:func:`_device_us`) of the dot kernel under other launch
    plans than ``dot_plan``'s, all through the one built library: P1 in
    blocks of 16 warps (one per SM) with bands of 16, 32, 48, 64 and 97
    query rows, and of 8 warps (two per SM) with bands of 64 and 97; P4 in
    blocks of 8 warps on grids of 132, 264, 388 and 776 blocks (its 776
    whole-line items), and of 16 on 132; each checked against the
    plain version (the bf16 ``einsum`` beside them rounds its output, so it
    is timed only), in ``rounds`` turns (the order reversed every other
    round). Returns {(probe, variant): [µs]}."""
    from ccnet_tpu_torch.ops import probes as P

    lib = P._lib()
    cases = {}
    for name in ("mid_batch_dot", "mid_batch_dot_4d"):
        N, T, H, C, strides = _dot_layout(name, PROBES[name][1])
        base = P.dot_plan(N, T, H, C, strides)
        # (warps, band, blocks); blocks None: one per resident slot or item
        runs = ([(16, b, None) for b in (16, 32, 48, 64, 97)] + [(8, 64, None), (8, 97, None)]
                if name == "mid_batch_dot" else
                [(8, base.band, b) for b in (132, 264, 388, 776)] + [(16, base.band, None)])
        plans = {}
        for warps, band, blocks in runs:
            es_bytes, smem = P.dot_smem(H, band, base.group)
            items = N * T * -(-H // band)
            blocks = blocks or min(items, P.H100_SMS * P.DOT_DESIGNS[warps])
            plans[f"{warps} warps, band {band}, {blocks} blocks"] = base._replace(
                band=band, bands=-(-H // band), warps=warps, es_bytes=es_bytes, smem=smem,
                items=items, blocks=blocks)
        cases[name] = (N, T, H, plans)
    times = {}
    for rnd in range(rounds):
        for name, (N, T, H, plans) in cases.items():
            sets = _copies(_probe_inputs(name, PROBES[name][1]))
            runs = [*plans, "einsum"]
            for variant in (runs if rnd % 2 == 0 else runs[::-1]):
                if variant == "einsum":
                    fn = _probe_library(name)
                else:
                    c = P._DotPlanC(*plans[variant])

                    def fn(q, k, c=c):
                        e = torch.empty((N, T, H, H), device=q.device, dtype=torch.float32)
                        _probe_call(lib.probe_mid_batch_dot, q, k, c, out=e)
                        return e
                    q, k = sets[0]
                    want = getattr(P, f"{name}_plain")(q, k)
                    _rel_check(f"{name} {variant}", fn(q, k).reshape(want.shape), want,
                               PROBE_DOT_TOL)
                times.setdefault((name, variant), []).append(_device_us(fn, sets)[0])
            del sets
    for name in cases:
        log(f"[dot-variants] {name} at {PROBES[name][1]}, device µs per call ({rounds} rounds "
            f"in turns): " + "; ".join(f"{v} " + " ".join(
                "not measured" if t is None else f"{t:.2f}" for t in ts)
                                       for (n, v), ts in times.items() if n == name))
    torch.cuda.empty_cache()
    return times


def _probe_call(fn, x, y, *args, out=None):
    """One launch of a probe kernel variant on x into y (on x and y into
    ``out``, for the dot); returns y (``out``)."""
    from ccnet_tpu_torch.ops import probes as P

    ptrs = (x.data_ptr(), y.data_ptr()) + (() if out is None else (out.data_ptr(),))
    rc = fn(*ptrs, *args, P._stream(x.get_device()))
    if rc != 0:
        raise RuntimeError(f"probe variant launch failed: CUDA error {rc}")
    return y if out is None else out


def phase_probes() -> dict:
    """P1–P5 against their plain versions at the script's and the model's
    shapes (the copies and the scale bit-exact); at the model's shapes the
    bound and :func:`probe_times`."""
    from ccnet_tpu_torch.ops import probes as P

    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    for name, (small, big, dtype) in PROBES.items():
        kernel, plain = getattr(P, name), getattr(P, f"{name}_plain")
        dot = "dot" in name
        for shape in (small, big):
            xs = _probe_inputs(name, shape)
            before = P.LAUNCHES[name]
            got = kernel(*xs)
            torch.cuda.synchronize()
            if P.LAUNCHES[name] != before + 1:
                raise RuntimeError(f"{name} did not count its launch")
            want = plain(*xs)
            if dot:
                err = _rel_check(f"{name} at {shape}", got, want, PROBE_DOT_TOL)
            elif got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"{name} at {shape} is not bit-exact")
            else:
                err = 0.0
        # the model's shape: the bound. Operations: a multiply-add per channel
        # of each logit; one multiply per scaled value; the copies do no
        # arithmetic
        flops = 2 * got.numel() * shape[-1] if dot else got.numel() * (name == "scale_ragged")
        report[name] = {"max_abs_err": err, **_bound(xs, (got,), flops, dtype)}
        report[name]["design"] = (
            "a band of query rows and all its line's keys staged once per block, mma.sync, "
            "the band's run of e stored as float4 from shared memory" if dot else
            "one 16-byte chunk per thread, one tile per block, no staging")
        log(f"[probes] {name}: ok at {small} and {shape} {str(dtype)[6:]} "
            f"({'<= %g x scale, err %.2e' % (PROBE_DOT_TOL, err) if dot else 'bit-exact'})")
        del xs, got, want
    for name, shape, offset in PROBE_DOT_EDGES:
        n = math.prod(shape)
        xs = [x[offset:offset + n].view(shape) for x in _probe_inputs(name, (n + 8,))]
        before = P.LAUNCHES[name]
        got = getattr(P, name)(*xs)
        torch.cuda.synchronize()
        if P.LAUNCHES[name] != before + 1:
            raise RuntimeError(f"{name} did not count its launch")
        err = _rel_check(f"{name} at {shape}, offset {offset}", got,
                         getattr(P, f"{name}_plain")(*xs), PROBE_DOT_TOL)
        log(f"[probes] {name}: ok at {shape}, base {2 * offset} bytes past 16 (<= "
            f"{PROBE_DOT_TOL:g} x scale, err {err:.2e})")
        del xs, got
    for name, r in probe_times().items():
        e = report[name]
        e.update(r)
        dev = {k: "not measured" if e[k] is None else f"{e[k]:.2f}"
               for k in ("device_us", "library_device_us")}
        us = "" if "dot" not in name else (
            f"; device µs {dev['device_us']} vs einsum {dev['library_device_us']}, host µs "
            f"{e['host_us']:.2f} vs einsum {e['library_host_us']:.2f}")
        log(f"[probes] {name} at {PROBES[name][1]}: kernel {e['ms']:.4f} ms, plain "
            f"{e['plain_ms']:.4f} ms, library {e['library_ms']:.4f} ms, bound "
            f"{e['bound_ms']:.4f} ms by {e['bound_by']} ({e['bound_ms'] / e['ms']:.1%} of it; "
            f"median of {TIMING_REPS}){us}")
    return report


def phase_probe_cli() -> dict:
    """The probes' main path: ``cli.probe.main`` on the card prints five
    PASS lines (exits 1 otherwise) and launches every probe kernel."""
    from ccnet_tpu_torch.cli.probe import main

    _reset_counts()
    results = main(["--device", "cuda"])
    launches = _counts()
    if len(results) != 5 or not all(results.values()):
        raise AssertionError(f"cli.probe: {results}")
    moved = {n: launches[n] for n in PROBES}
    if any(c < 1 for c in moved.values()) or any(
            c for n, c in launches.items() if n not in PROBES):
        raise AssertionError(f"cli.probe launches {launches}")
    log(f"[probe-cli] 5 PASS; launches {moved}")
    return moved


def randomize_(model: torch.nn.Module, seed: int = 0) -> None:
    """Seeded perturbation in place: gamma = 0.5, BN running stats and every
    1-D parameter (BN weight/bias, conv bias) perturbed, so the attention
    path and every BN move the logits."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("gamma"):
                t.fill_(0.5)
            elif name.endswith("running_mean"):
                t.copy_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1))
            elif name.endswith("running_var"):
                t.copy_(torch.from_numpy(rng.rand(*t.shape).astype(np.float32) + 0.5))
            elif t.dim() == 1:
                t.add_(torch.from_numpy(rng.randn(*t.shape).astype(np.float32) * 0.1).to(t))


def _eval_ab(model, x, tag: str, want: dict) -> None:
    """The eval forward of ``model`` on ``x`` through each CCA route: the
    kernel route's main logits against the plain route's, the kernel
    route's launches against ``want``, then both routes timed in turns
    (kernel, plain, plain, kernel, ...) after one untimed call of each."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    with torch.inference_mode():
        before = dict(K.LAUNCHES)
        model.set_cca_impl("kernel")
        main_k = model(x)["main"]
        moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
        if moved != want:
            raise RuntimeError(f"{tag}: impl='kernel' launched {moved}, not {want}")
        model.set_cca_impl("torch")
        main_t = model(x)["main"]
        times = {"kernel": [], "torch": []}
        for rep in range(EVAL_AB_REPS + 1):
            for impl in ("kernel", "torch") if rep % 2 else ("torch", "kernel"):
                model.set_cca_impl(impl)
                start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
                model(x)
                end.record()
                end.synchronize()
                if rep:
                    times[impl].append(start.elapsed_time(end))
        model.set_cca_impl("auto")
    torch.cuda.synchronize()
    B, _, H, W = x.shape
    if (tuple(main_k.shape) != (B, 19, _features(H), _features(W))
            or not torch.isfinite(main_k).all()):
        raise AssertionError(f"{tag}: kernel-route logits malformed: {tuple(main_k.shape)}")
    err, scale = _err(main_k, main_t)
    agree = (main_k.argmax(1) == main_t.argmax(1)).float().mean().item()
    log(f"[model] {tag}, gamma=0.5: kernel vs plain main logits max abs err {err:.3e} (scale "
        f"{scale:.3g}, tol {MODEL_TOL:g} x scale), argmax agreement {agree:.6f} "
        f"(>= {MODEL_ARGMAX})")
    log(f"[model] {tag} eval forward, the two CCA routes in turns in one process: impl='kernel' "
        f"median {np.median(times['kernel']):.4f} ms, impl='torch' median "
        f"{np.median(times['torch']):.4f} ms (CUDA events, {EVAL_AB_REPS} each; kernel "
        f"{' '.join(f'{t:.4f}' for t in times['kernel'])}; torch "
        f"{' '.join(f'{t:.4f}' for t in times['torch'])})")
    if not err <= MODEL_TOL * scale or agree < MODEL_ARGMAX:
        raise AssertionError(f"{tag}: the kernel route disagrees with the plain route")


def phase_model(pth: str) -> None:
    """R101 R=2 bf16 with seeded random weights (saved to ``pth``): the eval
    forward's kernel route against its plain route on 8 crops of 769²
    (K1/K2) and on one whole 1024×2048 image (K7a, the line route)."""
    from ccnet_tpu_torch.models import build_model

    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's default setting
    model = build_model("ccnet", num_classes=19, recurrence=2, depth=101,
                        dtype=torch.bfloat16, device="cuda")
    randomize_(model, seed=0)
    torch.save(model.state_dict(), pth)
    rng = np.random.RandomState(2)
    for batch, hw in ((8, (CROP, CROP)), (1, EVAL_HW)):
        x = torch.from_numpy((rng.rand(batch, 3, *hw) * 255.0 - 120.0).astype(np.float32)).cuda()
        want = _cca_want((batch, *map(_features, hw), 64, 512), torch.bfloat16,
                         fwd=2)  # R=2 recurrences
        _eval_ab(model, x, f"R101 R=2 bf16 ({batch},3,{hw[0]},{hw[1]})", want)
        del x
    del model
    torch.cuda.empty_cache()


def _launch_counts() -> tuple:
    from ccnet_tpu_torch.ops import cc_attention_cuda as K
    from ccnet_tpu_torch.ops import probes as P
    from ccnet_tpu_torch.ops import upsampled_ce as U

    return K.LAUNCHES, U.LAUNCHES, P.LAUNCHES


def _reset_counts() -> None:
    for counts in _launch_counts():
        for key in counts:
            counts[key] = 0


def _counts() -> dict:
    return {n: c for counts in _launch_counts() for n, c in counts.items()}


def _path_designs(shape, dtype) -> dict:
    """{path: the design K1–K4 of that path take} for ``(B, H, W, Cq, Cv)``
    features of ``dtype`` (``kernel_design``, from the path's own line)."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    q = torch.empty(shape[:3] + (shape[3],), dtype=dtype, device="meta")
    return {path: K.kernel_design(q, path) for path in K.PATHS}


def _designs(shape, dtype) -> str:
    return ", ".join(f"{path} {d.replace('_', ' ')}"
                     for path, d in _path_designs(shape, dtype).items())


def _add_natural(want: dict, shape, dtype, d: str, n: int = 1) -> dict:
    """Add to ``want`` the launches of ``n`` calls of K1 and K2 (``d`` =
    ``"fwd"``) or K3 and K4 (``"bwd"``): each under its own name and, on the
    tensor cores, under its design's count (``cca_{d}_{path}_tc`` for one
    block per line, ``cca_line_{d}_tc`` for the line kernels, which bf16
    lines past 128 take); the CUDA-core design (f32) has none."""
    for path, design in _path_designs(shape, dtype).items():
        want[f"cca_{d}_{path}"] += n
        if design == "tensor_core":
            want[f"cca_{d}_{path}_tc"] += n
        elif design == "tensor_core_lines":
            want[f"cca_line_{d}_tc"] += n
    return want


def _cca_want(shape, dtype, fwd: int = 0, bwd: int = 0) -> dict:
    """The attention kernels' launch counts of ``fwd`` forward and ``bwd``
    backward calls of the routed Function on ``(B, H, W, Cq, Cv)`` features
    of ``dtype``: each direction routed as the JAX package routes it
    (``uses_line_route``), one launch of each of K1/K2 (K3/K4) per call
    (:func:`_add_natural`), or one of K7a (K7b) per path and call on the
    line route; every bf16 launch on the tensor cores."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    _, H, W, Cq, Cv = shape
    bf16 = dtype == torch.bfloat16
    want = {n: 0 for n in K.LAUNCHES}
    for d, n in (("fwd", fwd), ("bwd", bwd)):
        if K.uses_line_route(d, H, W, Cq, Cv, dtype):
            want[f"cca_line_{d}"] += 2 * n
            want[f"cca_line_{d}_tc"] += 2 * n * bf16
        else:
            _add_natural(want, shape, dtype, d, n)
    return want


def _features(n: int) -> int:
    """The model's output-stride-8 feature length of an ``n``-pixel side:
    the stem's stride-2 3x3 convolution, the ceil-mode 3x3 max pool, and
    layer2's stride-2 3x3 convolution (769 -> 97, 1024 -> 129, 2048 -> 257)."""
    a = (n + 1) // 2
    b = -(-(a - 1) // 2) + 1
    return (b + 1) // 2


def _want(hw, fwd: int, bwd: int = 0, loss: int = 0) -> dict:
    """The launch counts of ``fwd`` forward and ``bwd`` backward CCA calls of
    the bf16 model on the OS-8 features of an ``hw`` input
    (:func:`_cca_want`) and ``loss`` calls of each of K5/K6."""
    want = {n: 0 for n in _counts()}
    want.update(_cca_want((1, *map(_features, hw), 64, 512), torch.bfloat16, fwd, bwd))
    want.update(upsampled_nll_fwd=loss, upsampled_nll_bwd=loss)
    return want


def _train_batch(seed: int, batch: int, hw):
    rng = np.random.RandomState(seed)
    x = (rng.rand(batch, 3, *hw) * 255.0 - 120.0).astype(np.float32)
    y = rng.randint(0, 19, (batch, *hw)).astype(np.int32)
    y[rng.rand(batch, *hw) < 0.1] = 255
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def _top_kernels(fn, top: int = 6) -> str:
    """One ``fn()`` under ``torch.profiler``: its device kernel time, the
    ``top`` kernels by summed device time (read from the exported chrome
    trace, whose kernel events carry device time alone), and the summed
    time and count of each hand-written attention kernel (``cca_*``)."""
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as d:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"]
    by_name = {}
    for e in events:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e3
    total = sum(by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    cca = {}
    for e in events:
        if "cca_" in e["name"]:
            name = e["name"].split("cca_", 1)[1].split("(")[0]
            ms, n = cca.get(name, (0.0, 0))
            cca[name] = (ms + e["dur"] / 1e3, n + 1)
    return (f"kernels {total:.1f} ms; top: "
            + "; ".join(f"{ms:.1f} ms {name[:90]}" for name, ms in ranked)
            + "; attention kernels: "
            + ("; ".join(f"cca_{n} {ms:.3f} ms ({c} launches)" for n, (ms, c) in cca.items())
               or "none"))


def random_pth(name: str, pth: str) -> None:
    """R101 bf16 ``name`` with seeded random weights (:func:`randomize_`), saved."""
    from ccnet_tpu_torch.models import build_model

    model = build_model(name, num_classes=19, depth=DEPTH, dtype=torch.bfloat16)
    randomize_(model, seed=0)
    torch.save(model.state_dict(), pth)


# the grads compared between the kernel and plain routes of a train step:
# the attention's for CCNet, the classifiers' (right behind K6) otherwise
HEAD_GRADS = ("head.1.weight", "dsn.3.weight")


def phase_train_step(pth: str, batch: int, hw, model_name: str = "ccnet",
                     profile: bool = False) -> None:
    """One train step from the same state through the kernels and through
    the plain versions: the loss and the grads agree (CCNet: the CCA
    grads; PSPNet/DeepLabv3, whose kernels are K5/K6 alone: the
    classifiers'); then TRAIN_AB_REPS more steps of each from its state,
    timed in turns. ``profile``: also one kernel-route step under
    :func:`_top_kernels`."""
    from ccnet_tpu_torch.losses import build_criterion
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.train import create_train_state, make_train_step
    from ccnet_tpu_torch.utils import load_pth

    torch.backends.cudnn.allow_tf32 = True
    x, y = _train_batch(3, batch, hw)
    ccnet = model_name == "ccnet"
    grads = CCA_GRADS if ccnet else HEAD_GRADS
    runs, routes = {}, {}
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    for impl in ("kernel", "torch"):
        held = torch.cuda.memory_allocated() - base  # the other route's model and state
        model = build_model(model_name, num_classes=19, recurrence=2, depth=DEPTH,
                            dtype=torch.bfloat16, impl=impl, drop_rate=0.0, device="cuda")
        load_pth(pth, model, strict=True)
        state = create_train_state(model)
        step = make_train_step(build_criterion(ohem=True, impl=impl))
        _reset_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss = step(state, x, y)["loss"].item()
        runs[impl] = {"loss": loss, "launches": _counts(),
                      "peak": torch.cuda.max_memory_allocated() - held,
                      "grads": {n: p.grad.float().clone() for n, p in model.named_parameters()
                                if n in grads}}
        routes[impl] = (state, step)
    # more steps of the two routes from their states, timed in turns (kernel,
    # plain, plain, kernel, ...); the first step of each paid for cuDNN's set-up
    times = {"kernel": [], "torch": []}
    for rep in range(TRAIN_AB_REPS):
        for impl in ("kernel", "torch") if rep % 2 == 0 else ("torch", "kernel"):
            state, step = routes[impl]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            step(state, x, y)
            end.record()
            end.synchronize()
            times[impl].append(start.elapsed_time(end) / 1000.0)
    for impl in runs:
        runs[impl]["s"] = float(np.median(times[impl]))
    if profile:  # where the step's time goes
        state, step = routes["kernel"]
        log(f"[train-step] {model_name} kernel route, one step under torch.profiler: "
            + _top_kernels(lambda: step(state, x, y)))
    del routes, state, step, model
    torch.cuda.empty_cache()
    k, t = runs["kernel"], runs["torch"]
    # each CCA call once per recurrence (R=2), each loss kernel once per head
    want = _want(hw, 2 * ccnet, 2 * ccnet, 2)
    if k["launches"] != want or any(t["launches"].values()):
        raise AssertionError(f"launches: kernel route {k['launches']} (want {want}), plain "
                             f"{t['launches']}")
    rel_loss = abs(k["loss"] - t["loss"]) / abs(t["loss"])
    rel = {n: (k["grads"][n] - t["grads"][n]).norm().item() / t["grads"][n].norm().item()
           for n in grads}
    tag = (f"{model_name} R{DEPTH}{' R=2' if ccnet else ''} bf16 ({batch},3,{hw[0]},{hw[1]}) "
           f"OHEM{', gamma=0.5' if ccnet else ''}")
    log(f"[train-step] {tag}: loss kernel {k['loss']:.6f} vs plain {t['loss']:.6f} (rel "
        f"{rel_loss:.2e}, tol {TRAIN_LOSS_RTOL:g}); grads rel err "
        + " ".join(f"{n}={e:.2e}" for n, e in rel.items())
        + f" (tol {TRAIN_GRAD_RTOL:g}); launches {k['launches']}")
    log(f"[train-step] {tag}: peak memory kernel route {k['peak'] / 2**30:.2f} GiB, plain "
        f"route {t['peak'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated, less the other "
        f"route's model and state); steps in turns: kernel route median {k['s']:.4f} s "
        f"({batch / k['s']:.2f} crops/s; {' '.join(f'{v:.4f}' for v in times['kernel'])}), "
        f"plain route {t['s']:.4f} s ({' '.join(f'{v:.4f}' for v in times['torch'])}) "
        f"(CUDA events, {TRAIN_AB_REPS} each)")
    if not rel_loss <= TRAIN_LOSS_RTOL or not all(e <= TRAIN_GRAD_RTOL for e in rel.values()):
        raise AssertionError("train step: kernel route disagrees with the plain route")
    if not all(t["grads"][n].abs().max().item() > 0 for n in grads):
        raise AssertionError(f"a grad of {grads} is zero: the backward kernels were not exercised")


def phase_train_main_path(pth: str, snap_dir: str, batch: int, hw, steps: int,
                          model_name: str = "ccnet") -> tuple:
    """``cli.train.main --model model_name`` on the synthetic set of
    :data:`EVAL_HW` images; returns (launches, the exported ``.pth``)."""
    from ccnet_tpu_torch.cli.train import main
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.utils import load_pth

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    result = main(["--model", model_name, "--synthetic", "--synthetic-size",
                   f"{EVAL_HW[0]},{EVAL_HW[1]}", "--device", "cuda", "--batch-size", str(batch),
                   "--input-size", f"{hw[0]},{hw[1]}",
                   "--depth", str(DEPTH), "--ohem", "1", "--num-steps", str(steps),
                   "--save-pred-every", str(steps), "--restore-from", pth,
                   "--snapshot-dir", snap_dir])
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = result["losses"]
    if len(losses) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses {losses}")
    cca = 2 * steps * (model_name == "ccnet")  # R=2 recurrences of CCNet's attention
    want = _want(hw, cca, cca, 2 * steps)  # the loss kernels once per head (main + aux)
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    out = os.path.join(snap_dir, f"CS_scenes_{steps}.pth")
    model = build_model(model_name, num_classes=19, recurrence=2, depth=DEPTH,
                        dtype=torch.bfloat16, device="cuda")
    load_pth(out, model, strict=True)
    del model
    torch.cuda.empty_cache()
    dev = result["step_seconds"][1:]
    wall = result["wall_seconds"][1:]
    tag = (f"cli.train --model {model_name} R{DEPTH}{' R=2' if cca else ''} bf16 OHEM bs "
           f"{batch} {hw[0]}x{hw[1]}")
    log(f"[train] {tag}, {steps} steps: losses {' '.join(f'{v:.4f}' for v in losses)}; "
        f"launches {launches}")
    log(f"[train] {tag}, steps 2-{steps}: {np.mean(dev):.4f} s/step on the card (CUDA events, "
        f"augment + step; median {np.median(dev):.4f}), {batch / np.mean(dev):.2f} crops/s; "
        f"host wall {np.mean(wall):.4f} s/step (median {np.median(wall):.4f}; the loader's "
        f"wait, the step and the last step's checkpoint), {batch / np.mean(wall):.2f} "
        f"crops/s; first step {result['step_seconds'][0]:.3f} s on the card; peak memory "
        f"{peak / 2**30:.2f} GiB; {out} loads with strict=True")
    return launches, out


def train_wall(steps: int = 4, batch: int = TRAIN_BATCH, workers: int = 8) -> dict:
    """``cli.train --synthetic`` (R101 R=2 bf16 OHEM, seeded init) at batch
    ``batch`` of 769², ``steps`` steps, ``--num-workers workers``: the
    medians over steps 2.. of the host wall s/step and of the card's
    s/step. Uses only what every version of ``cli.train`` has, so it also
    times an earlier tree (run from its checkout)."""
    from ccnet_tpu_torch.cli.train import main

    with tempfile.TemporaryDirectory() as d:
        result = main(["--synthetic", "--synthetic-size", f"{EVAL_HW[0]},{EVAL_HW[1]}",
                       "--device", "cuda", "--batch-size", str(batch), "--input-size",
                       f"{CROP},{CROP}", "--depth", str(DEPTH), "--ohem", "1", "--num-steps",
                       str(steps), "--save-pred-every", str(steps), "--export-pth", "0",
                       "--num-workers", str(workers), "--snapshot-dir", d])
    r = {"wall_s_per_step": float(np.median(result["wall_seconds"][1:])),
         "card_s_per_step": float(np.median(result["step_seconds"][1:])),
         "wall_seconds": result["wall_seconds"], "step_seconds": result["step_seconds"]}
    log(f"[train-wall] cli.train --synthetic bs {batch} {CROP}x{CROP}, {steps} steps, "
        f"--num-workers {workers}: host wall median {r['wall_s_per_step']:.4f} s/step "
        f"({' '.join(f'{v:.4f}' for v in r['wall_seconds'])}), card median "
        f"{r['card_s_per_step']:.4f} s/step ({' '.join(f'{v:.4f}' for v in r['step_seconds'])})")
    return r


def eval_times(mode: str) -> dict:
    """``cli.evaluate --synthetic`` (R101 R=2 bf16, seeded random weights)
    on the 2 images of :data:`EVAL_HW` in ``EVAL_MODES[mode]``: the card's
    s/img of each image (``batch_seconds``). Uses only what every version
    of ``cli.evaluate`` has, so it also times an earlier tree."""
    from ccnet_tpu_torch.cli.evaluate import main

    flags, _ = EVAL_MODES[mode]
    with tempfile.TemporaryDirectory() as d:
        result = main(["--synthetic", "--synthetic-size", f"{EVAL_HW[0]},{EVAL_HW[1]}",
                       "--input-size", f"{CROP},{CROP}", "--device", "cuda", "--save-preds",
                       "0", "--output-dir", d] + flags)
    secs = [float(v) for v in result["batch_seconds"]]
    log(f"[eval-times] cli.evaluate {mode}: s/img on the card "
        + " ".join(f"{v:.4f}" for v in secs))
    return {"s_per_img": secs}


def ab_turn() -> None:
    """One turn of the parent/change A/B, run from a checkout's root: the
    card, P1/P4's :func:`probe_times`, :func:`train_wall` and the sliding
    and whole-image :func:`eval_times`, then one JSON line tagged ``[ab]``."""
    from ccnet_tpu_torch.ops import _build

    phase_card()
    _build.build_libraries(LIBRARIES)
    out = {"dots": probe_times(("mid_batch_dot", "mid_batch_dot_4d")), "train": train_wall(),
           "sliding": eval_times("sliding"), "whole": eval_times("whole")}
    out["train"] = {k: v for k, v in out["train"].items() if "per_step" in k}
    log("[ab] " + json.dumps({"checkout": os.getcwd(), **out}))


def ab(parent: str, order=("parent", "tree", "tree", "parent")) -> None:
    """:func:`ab_turn` in the checkout ``parent`` (a ``git archive`` of the
    parent commit) and in this one, in turns, each in its own process."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import importlib.util as u, sys; sys.path.insert(0, '.'); "
            f"sp = u.spec_from_file_location('cs', {os.path.abspath(__file__)!r}); "
            "cs = u.module_from_spec(sp); sp.loader.exec_module(cs); cs.ab_turn()")
    for who in order:
        log(f"[ab] turn: {who}")
        subprocess.run([sys.executable, "-c", code], cwd=parent if who == "parent" else here,
                       check=True, timeout=900)


def _read_png(path: str) -> np.ndarray:
    """The (H, W) palette indices of a PNG the evaluator wrote, decoded with
    the standard library: 8-bit colour type 3, 256 palette entries, filter-0
    scanlines."""
    data = open(path, "rb").read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path} is not a PNG")
    chunks, pos = {}, 8
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, ctype) != (8, 3) or len(chunks[b"PLTE"]) != 768:
        raise AssertionError(f"{path}: depth {depth}, colour type {ctype}, "
                             f"{len(chunks[b'PLTE'])} palette bytes")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(h, w + 1)
    if (rows[:, 0] != 0).any():
        raise AssertionError(f"{path}: a scanline filter other than 0")
    return rows[:, 1:]


# evaluation modes: extra cli.evaluate flags, and the forward CCA calls of
# one image at R=2 at each scale (sliding: per chunk of 8 tiles; whole
# image; the whole image at 5 scales x 2 flips)
EVAL_MODES = {
    "sliding": ([], {1.0: 2}),
    "sliding-png": (["--save-preds", "1"], {1.0: 2}),
    "whole": (["--whole", "1"], {1.0: 2}),
    "msflip": (["--whole", "1", "--scales", ",".join(map(str, MS_SCALES)), "--flip", "1",
                "--save-preds", "1"], {s: 2 * 2 for s in MS_SCALES}),
}


def phase_main_path(pth: str, mode: str, model_name: str = "ccnet") -> dict:
    """``cli.evaluate.main --model model_name`` on the synthetic 1024×2048
    set in one of :data:`EVAL_MODES`: meanIU, the confusion sum, launch
    counts (CCNet: its attention kernels; the other heads launch none),
    PNGs, s/img, peak memory."""
    from ccnet_tpu_torch.cli.evaluate import main
    from ccnet_tpu_torch.data import SyntheticDataset
    from ccnet_tpu_torch.evaluation import compute_tiles

    flags, calls = EVAL_MODES[mode]
    ds = SyntheticDataset(n=2, hw=EVAL_HW, num_classes=19)
    want = {n: 0 for n in _counts()}
    for scale, n in calls.items():
        n *= model_name == "ccnet"
        if mode.startswith("sliding"):  # chunks of 8 tiles
            hw, n = (CROP, CROP), n * -(-len(compute_tiles(EVAL_HW, (CROP, CROP))) // 8)
        else:  # predict_multiscale's round(H * s)
            hw = tuple(int(round(x * scale)) for x in EVAL_HW)
        for name, c in _want(hw, len(ds) * n).items():
            want[name] += c
    with tempfile.TemporaryDirectory() as out_dir:
        _reset_counts()
        torch.cuda.reset_peak_memory_stats()
        result = main(["--model", model_name, "--synthetic", "--synthetic-size",
                       f"{EVAL_HW[0]},{EVAL_HW[1]}", "--input-size", f"{CROP},{CROP}",
                       "--restore-from", pth, "--device", "cuda", "--save-preds", "0",
                       "--output-dir", out_dir] + flags)
        peak = torch.cuda.max_memory_allocated()
        launches = _counts()
        if not 0.0 <= result["meanIU"] <= 1.0:
            raise AssertionError(f"meanIU {result['meanIU']} outside [0, 1]")
        if not os.path.isfile(os.path.join(out_dir, "result.txt")):
            raise AssertionError("result.txt was not written")
        valid = sum(int((ds[i][1] != 255).sum()) for i in range(len(ds)))
        total = int(np.asarray(result["confusion"]).sum())
        if total != valid:
            raise AssertionError(f"confusion matrix sums to {total}, {valid} pixels are not ignored")
        if launches != want:
            raise AssertionError(f"{mode}: expected launches {want}, got {launches}")
        pngs = ""
        if "--save-preds" in flags:
            for i in range(len(ds)):
                pred = _read_png(os.path.join(out_dir, f"{ds.name(i)}.png"))
                if pred.shape != EVAL_HW or pred.max() >= 19:
                    raise AssertionError(f"prediction PNG {i}: shape {pred.shape}, "
                                         f"max index {pred.max()}")
            pngs = (f"; {len(ds)} prediction PNGs written, decoded with zlib: "
                    f"{EVAL_HW[0]}x{EVAL_HW[1]}, indices < 19")
    secs, wall = result["batch_seconds"], result["wall_seconds"]
    log(f"[{mode}] {model_name} R{DEPTH}{' R=2' if model_name == 'ccnet' else ''} bf16 "
        f"{EVAL_HW[0]}x{EVAL_HW[1]} synthetic, 2 images {' '.join(flags)}: meanIU "
        f"{result['meanIU']:.6f}, launches {launches}, s/img {secs[1]:.4f} on the card (CUDA "
        f"events, predict + confusion; second image; first {secs[0]:.4f}), host wall "
        f"median {np.median(wall):.4f} s/img ({' '.join(f'{v:.4f}' for v in wall)}); peak "
        f"memory {peak / 2**30:.2f} GiB{pngs}")
    return launches


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run one kernel-route train step of CCNet, PSPNet and "
                             "DeepLabv3 under torch.profiler and print its top kernels by "
                             "device time")
    parser.add_argument("--ab", metavar="PARENT_DIR",
                        help="instead, time P1/P4 and cli.train --synthetic in the checkout "
                             "PARENT_DIR and in this one in turns (parent, this, this, parent)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one H100")
    if args.ab:
        ab(args.ab)
        return
    smi = phase_card()
    phase_build()
    report = phase_kernels()
    report.update(phase_bwd_kernels())
    report.update(phase_loss_kernels())
    report.update(phase_line_kernels())
    report.update(phase_probes())
    probe_launches = phase_probe_cli()
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "ccnet_r101_random.pth")
        phase_model(pth)
        phase_train_step(pth, TRAIN_BATCH, (CROP, CROP), profile=args.profile)
        launches, trained = phase_train_main_path(pth, os.path.join(tmp, "snapshots"),
                                                  TRAIN_BATCH, (CROP, CROP), TRAIN_STEPS)
        phase_train_step(pth, FULL_FRAME_BATCH, FULL_FRAME)
        full_frame, _ = phase_train_main_path(pth, os.path.join(tmp, "snapshots_full"),
                                              FULL_FRAME_BATCH, FULL_FRAME, FULL_FRAME_STEPS)
        sliding = phase_main_path(trained, "sliding")
        whole = phase_main_path(trained, "whole")
        msflip = phase_main_path(trained, "msflip")
        heads = []
        for name in ("pspnet", "deeplabv3"):  # the heads without attention: K5/K6
            pth = os.path.join(tmp, f"{name}_r101_random.pth")
            random_pth(name, pth)
            phase_train_step(pth, TRAIN_BATCH, (CROP, CROP), name, profile=args.profile)
            head, trained = phase_train_main_path(pth, os.path.join(tmp, f"snapshots_{name}"),
                                                  TRAIN_BATCH, (CROP, CROP), HEAD_TRAIN_STEPS,
                                                  name)
            heads.append(head)
            phase_main_path(trained, "sliding-png", name)
    # each kernel's launches in the main paths that run it: K1–K6 in the 769²
    # cli.train run (K1/K2 plus the sliding evaluation's, K5/K6 plus
    # full-frame, PSPNet's and DeepLabv3's cli.train), K7a in the --whole and
    # MS+flip evaluations and full-frame cli.train, K7b in full-frame
    # cli.train, P1–P5 in cli.probe
    for name in ("cca_fwd_col", "cca_fwd_row", "cca_fwd_col_tc", "cca_fwd_row_tc"):
        launches[name] += sliding[name]
    for name in ("upsampled_nll_fwd", "upsampled_nll_bwd"):
        launches[name] += full_frame[name] + sum(head[name] for head in heads)
    for name in ("cca_line_fwd", "cca_line_fwd_tc"):
        launches[name] = whole[name] + msflip[name] + full_frame[name]
    for name in ("cca_line_bwd", "cca_line_bwd_tc"):
        launches[name] = full_frame[name]
    launches.update(probe_launches)
    kernels = [{"name": name, "route": "cuda", "source": f"ccnet_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                **{key: report[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "bound_by", "library_ms")},
                **{key: report[name][key] for key in ("design", "earlier_ms", "share", "tflops",
                                                      "device_us", "host_us")
                   if key in report[name]}}
               for name, source, replaces in KERNELS]
    for k in kernels:  # K1–K4, K7a/K7b: how many of the path's launches took the tensor cores
        if f"{k['name']}_tc" in launches:
            k["launches_tensor_core"] = launches[f"{k['name']}_tc"]
    log("[summary] kernel: ms / bound ms (share of bound) / plain ms / library ms")
    for k in kernels:
        lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f}"
        r = report[k["name"]]
        log(f"[summary] {k['name']}: {k['ms']:.4f} / {k['bound_ms']:.4f} by {k['bound_by']} "
            f"({k['bound_ms'] / k['ms']:.1%}) / {k['plain_ms']:.4f} / {lib}; "
            f"{k['launches']} launches on its path; bound from {r['bound_bytes'] / 1e6:.2f} MB "
            f"(the port moves {r['port_bytes'] / 1e6:.2f} MB), {r['bound_flops'] / 1e9:.3f} GFLOP")
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
