#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ccnet_tpu_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card of compute
capability 9.0 and ``nvcc``. It imports nothing of JAX. Phases, in order; any
failure raises and exits non-zero:

1. card: the ``nvidia-smi`` name and power limit; capability (9, 0) required;
2. build: the five CUDA libraries of ``ccnet_tpu_torch/csrc`` (``cca_fwd``,
   ``cca_bwd``, ``upsampled_ce``, ``cca_lines``, ``probes``), one ``nvcc``
   each, started together;
3. kernels vs plain: K1 ``cca_fwd_col`` and K2 ``cca_fwd_row`` against their
   plain-torch versions, and the routed op against the joint-softmax
   oracle, at the sliding-tile, whole-image and edge shapes, in f32 (TF32
   off) and bf16; CUDA-event times of kernel vs plain at the sliding shape;
4. backward kernels vs plain: K3 ``cca_bwd_col`` and K4 ``cca_bwd_row``
   against their plain versions, and the autograd Function's grads against
   torch.autograd of the plain op, at the same shapes and dtypes; times;
5. loss kernels vs plain: K5 ``upsampled_nll_fwd`` and K6
   ``upsampled_nll_bwd`` against the materialised upsample + NLL and its
   autograd, int32 and uint8 labels; times at (8, 97, 97, 19) → 769²;
6. line kernels vs plain: K7a ``cca_line_fwd`` and K7b ``cca_line_bwd`` on
   both paths as the line route calls them, and the routed Function's
   output and grads, at the whole-image shapes of scales 1.0 and 1.75 and
   edge shapes, f32 and bf16; times at the long shapes against the plain
   versions, the plain op and K1–K4 forced at the same shape;
   (3, 4 and 6 also time the one-call yardstick of the attention,
   ``F.scaled_dot_product_attention`` with a row-or-column mask on
   ``(B, 1, H·W, C)``, forward and forward + backward, on every backend
   that takes it, after checking it computes the plain op's function)
7. probes vs plain: P1–P5 (``ccnet_tpu_torch/ops/probes.py``) at the shapes
   of ``scripts/probe_mosaic.py`` and at the model's (P4 at K1's column
   logits (8, 97, 97, 64), P5 at v (8, 97, 97, 512)): the copies and the
   scale bit-exact, the dots at 1e-4 x scale; times; then the probe main
   path, ``ccnet_tpu_torch.cli.probe.main``, prints five PASS lines and
   launches each kernel;
8. full model: CCNet-R101 R=2 bf16 with seeded random weights (``gamma`` =
   0.5, so the attention moves the logits), kernel route vs plain route on
   one (8, 3, 769, 769) batch; the weights go to a ``.pth``;
9. train step: one OHEM+DSN ``train_step`` from that ``.pth`` with the
   kernels (CCA and loss) and one with the plain versions: loss, CCA grads,
   launch counts, peak memory; at batch 8 of 769² (K1–K6);
10. train main path: ``ccnet_tpu_torch.cli.train.main`` with ``--synthetic``,
    batch 8 of 769², OHEM, 4 steps from that ``.pth``; launch counts of
    K1–K6; the exported ``CS_scenes_4.pth`` loads strictly;
11. full-frame training: 9 and 10 at batch 2 of 1025×2049 crops padded from
    the 1024×2048 images (features 129×257: K7a/K7b and K5/K6), 2 steps;
12. evaluation main path: ``ccnet_tpu_torch.cli.evaluate.main`` on the
    synthetic 1024×2048 set with the trained ``.pth``, sliding 769²
    windows (K1/K2); then ``--whole 1`` (K7a at 129×257); then multi-scale
    + flip whole image, scales 0.75–1.75, ``--save-preds 1`` (K7a at
    97×193 … 225×449), whose prediction PNGs are decoded with ``zlib``.
    Each run's launch counts must show that it went through its kernels;
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

also profiles one kernel-route train step of PSPNet and DeepLabv3 and
prints their top kernels by device time.
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
# B, H, W, Cq, Cv of the line route: whole image at scale 1.0 (and full-frame
# training), at scale 1.75, and edge shapes (N = 1 on either path)
LINE_SHAPES = [(1, 129, 257, 64, 512), (1, 225, 449, 64, 512), (2, 9, 441, 8, 16),
               (1, 1, 300, 4, 8), (1, 300, 1, 4, 8)]
LOSS_SHAPES = [(8, 97, 97, 19, 8), (2, 5, 7, 4, 3), (1, 9, 9, 6, 4)]  # B, h, w, C, r
NLL_TOL = 1e-5        # K5: max abs err of the f32 nll
NLL_GRAD_TOL = 1e-4   # K6: max abs err over max |plain grad|
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
    ("cca_line_fwd", "cca_lines.cu", "ccnet_tpu/ops/cc_attention_pallas.py:552"),
    ("cca_line_bwd", "cca_lines.cu", "ccnet_tpu/ops/cc_attention_pallas.py:661"),
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


LIBRARIES = ("cca_fwd", "cca_bwd", "upsampled_ce", "cca_lines", "probes")


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
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL[dtype]
            for shape in SHAPES:
                q, k, v = _inputs(shape, dtype, seed=sum(shape))
                q32, k32, v32 = q.float(), k.float(), v.float()  # plain in f32
                before = dict(K.LAUNCHES)
                col = K.cca_fwd_col(q, k, v)
                row = K.cca_fwd_row(q, k, v, *col)  # K2 fed K1's own outputs
                out, m, L = K.criss_cross_attention_cuda(q, k, v)
                torch.cuda.synchronize()
                line = K.uses_line_route(shape[1], shape[2])  # the op took K7a, not K1/K2
                if (K.LAUNCHES["cca_fwd_col"] != before["cca_fwd_col"] + 2 - line
                        or K.LAUNCHES["cca_fwd_row"] != before["cca_fwd_row"] + 2 - line
                        or K.LAUNCHES["cca_line_fwd"] != before["cca_line_fwd"] + 2 * line):
                    raise RuntimeError(f"launch counts did not advance: {before} -> {K.LAUNCHES}")
                checks = {
                    "K1": zip(("o_col", "m_col", "l_col"), col, K.cca_fwd_col_plain(q32, k32, v32)),
                    "K2": zip(("out", "m", "L"), row, K.cca_fwd_row_plain(q32, k32, v32, *col)),
                    "op": zip(("out", "m", "L"), (out, m, L),
                              plain.criss_cross_attention_stats(q32, k32, v32)),
                }
                errs = {}
                for kern, pairs in checks.items():
                    for name, got, want in pairs:
                        err = _rel_check(f"{kern} {name} at {shape} {dtype}", got, want, tol)
                        errs[f"{kern}.{name}"] = err
                        if shape == SLIDING and dtype == torch.bfloat16:
                            key = "cca_fwd_col" if kern == "K1" else "cca_fwd_row"
                            if kern != "op":
                                report.setdefault(key, {"max_abs_err": 0.0})
                                report[key]["max_abs_err"] = max(report[key]["max_abs_err"], err)
                log(f"[kernels] {str(dtype)[6:]} {shape}: ok (tol {tol:g} x scale) "
                    + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))

        # times at the sliding shape, bf16: each kernel vs its plain version
        # and its bound (K1's o_col counted in the value dtype, as the TPU
        # function writes it); the yardstick of K1 + K2 is one SDPA forward
        bf16 = torch.bfloat16
        q, k, v = _inputs(SLIDING, bf16, seed=1)
        col = K.cca_fwd_col(q, k, v)
        row = K.cca_fwd_row(q, k, v, *col)
        o_col = [(col[0], bf16), *col[1:]]
        report["cca_fwd_col"].update(_bound((q, k, v), o_col, _cca_flops(SLIDING, True, "col"),
                                            bf16))
        report["cca_fwd_row"].update(_bound((q, k, v, *o_col), row,
                                            _cca_flops(SLIDING, True, "row"), bf16))
        report["cca_fwd_col"]["ms"] = _time_ms(K.cca_fwd_col, q, k, v)
        report["cca_fwd_col"]["plain_ms"] = _time_ms(K.cca_fwd_col_plain, q, k, v)
        report["cca_fwd_row"]["ms"] = _time_ms(K.cca_fwd_row, q, k, v, *col)
        report["cca_fwd_row"]["plain_ms"] = _time_ms(K.cca_fwd_row_plain, q, k, v, *col)
        op_ms = _time_ms(K.criss_cross_attention_cuda, q, k, v)
        plain_op_ms = _time_ms(plain.criss_cross_attention, q, k, v)
        del col, row, o_col
    sdpa = _sdpa_yardstick(q, k, v)
    _log_sdpa("kernels", SLIDING, sdpa)
    for name in ("cca_fwd_col", "cca_fwd_row"):
        report[name]["library_ms"] = sdpa[0]
        log(f"[kernels] {name} at {SLIDING} bf16: kernel {report[name]['ms']:.4f} ms, "
            f"plain {report[name]['plain_ms']:.4f} ms (median of {TIMING_REPS}), bound "
            f"{report[name]['bound_ms']:.4f} ms by {report[name]['bound_by']}")
    log(f"[kernels] CCA forward at {SLIDING} bf16: kernels {op_ms:.4f} ms, plain "
        f"criss_cross_attention {plain_op_ms:.4f} ms (median of {TIMING_REPS})")
    return report


def phase_bwd_kernels() -> dict:
    """K3/K4 against their plain versions, and the autograd Function's grads
    against torch.autograd of the plain op, at every shape in f32 and bf16."""
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    for dtype in (torch.float32, torch.bfloat16):
        tol = BWD_TOL[dtype]
        for shape in SHAPES:
            q, k, v = _inputs(shape, dtype, seed=sum(shape) + 1)
            g = _inputs(shape, dtype, seed=sum(shape) + 2)[2]
            q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
            with torch.no_grad():
                out, m, L = K.criss_cross_attention_cuda(q, k, v)
                delta = (g32 * out.float()).sum(dim=-1)
                before = dict(K.LAUNCHES)
                col = K.cca_bwd_col(q, k, v, g, m, L, delta)
                row = K.cca_bwd_row(q, k, v, g, m, L, delta, *col)
                torch.cuda.synchronize()
                if (K.LAUNCHES["cca_bwd_col"] != before["cca_bwd_col"] + 1
                        or K.LAUNCHES["cca_bwd_row"] != before["cca_bwd_row"] + 1):
                    raise RuntimeError(f"launch counts did not advance: {before} -> {K.LAUNCHES}")
                col_p = K.cca_bwd_col_plain(q32, k32, v32, g32, m, L, delta)
                row_p = K.cca_bwd_row_plain(q32, k32, v32, g32, m, L, delta, *col)
            errs = {}
            for kern, got_t, want_t in (("K3", col, col_p), ("K4", row, row_p)):
                for name, got, want in zip(("dq", "dk", "dv"), got_t, want_t):
                    errs[f"{kern}.{name}"] = _rel_check(f"{kern} {name} at {shape} {dtype}",
                                                        got, want, tol)
            # the Function (K1 K2 K3 K4) vs torch.autograd of the plain op in f32
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            grads = torch.autograd.grad(K.criss_cross_attention_cuda(*leaves)[0], leaves, g)
            leaves32 = [t.detach().clone().requires_grad_(True) for t in (q32, k32, v32)]
            grads_p = torch.autograd.grad(plain.criss_cross_attention(*leaves32), leaves32, g32)
            for name, got, want in zip(("dq", "dk", "dv"), grads, grads_p):
                errs[f"fn.{name}"] = _rel_check(f"Function {name} at {shape} {dtype}",
                                                got, want, tol)
            if shape == SLIDING and dtype == torch.bfloat16:
                for kern, key in (("K3", "cca_bwd_col"), ("K4", "cca_bwd_row")):
                    report[key] = {"max_abs_err": max(e for n, e in errs.items()
                                                      if n.startswith(kern))}
            log(f"[bwd] {str(dtype)[6:]} {shape}: ok (tol {tol:g} x scale) "
                + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))

    # times at the training shape, bf16; the bounds count the column path's
    # grads in the value dtype, as the TPU function writes them
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
        report["cca_bwd_col"]["ms"] = _time_ms(K.cca_bwd_col, *stats)
        report["cca_bwd_col"]["plain_ms"] = _time_ms(K.cca_bwd_col_plain, *stats)
        report["cca_bwd_row"]["ms"] = _time_ms(K.cca_bwd_row, *stats, *col)
        report["cca_bwd_row"]["plain_ms"] = _time_ms(K.cca_bwd_row_plain, *stats, *col)
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd(fn):
        return lambda q_, k_, v_, g_: torch.autograd.grad(fn(q_, k_, v_), (q_, k_, v_), g_)

    op_ms = _time_ms(fwd_bwd(lambda *a: K.criss_cross_attention_cuda(*a)[0]), *leaves, g)
    plain_op_ms = _time_ms(fwd_bwd(plain.criss_cross_attention), *leaves, g)
    del col, out, m, L, delta, leaves, stats
    sdpa = _sdpa_yardstick(q, k, v, g)  # forward + backward: the yardstick of K3 + K4
    _log_sdpa("bwd", SLIDING, sdpa)
    for name in ("cca_bwd_col", "cca_bwd_row"):
        report[name]["library_ms"] = sdpa[0]
        log(f"[bwd] {name} at {SLIDING} bf16: kernel {report[name]['ms']:.4f} ms, "
            f"plain {report[name]['plain_ms']:.4f} ms (median of {TIMING_REPS}), bound "
            f"{report[name]['bound_ms']:.4f} ms by {report[name]['bound_by']}")
    log(f"[bwd] CCA forward+backward at {SLIDING} bf16: kernels {op_ms:.4f} ms, plain "
        f"criss_cross_attention + autograd {plain_op_ms:.4f} ms (median of {TIMING_REPS})")
    return report


# the two views the line route hands K7a/K7b: (path, masked, view of NHWC)
LINE_PATHS = (("col", True, lambda t: t.transpose(1, 2)), ("row", False, lambda t: t))


def phase_line_kernels() -> dict:
    """K7a/K7b against their plain versions on both paths as the line route
    calls them (columns through the transposed view, masked; rows), and the
    routed Function's output and grads against torch.autograd of the plain
    op, at every line shape in f32 and bf16. Then CUDA-event times at the
    long shapes: each kernel vs its plain version, and the route's forward
    and forward + backward vs K1–K4 forced at the same shape and vs the
    plain op (the routing evidence)."""
    from ccnet_tpu_torch.ops import cc_attention as plain
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"cca_line_fwd": {"max_abs_err": 0.0}, "cca_line_bwd": {"max_abs_err": 0.0}}
    for dtype in (torch.float32, torch.bfloat16):
        tol = BWD_TOL[dtype]
        for shape in LINE_SHAPES:
            if not K.uses_line_route(shape[1], shape[2]):
                raise AssertionError(f"{shape} does not take the line route")
            q, k, v = _inputs(shape, dtype, seed=sum(shape) + 3)
            g = _inputs(shape, dtype, seed=sum(shape) + 4)[2]
            f32 = [t.float() for t in (q, k, v, g)]
            errs = {}
            with torch.no_grad():
                before = dict(K.LAUNCHES)
                fwd = {}
                for path, masked, view in LINE_PATHS:
                    fwd[path] = K.cca_line_fwd(view(q), view(k), view(v), masked)
                    want = K.cca_line_fwd_plain(*(view(t) for t in f32[:3]), masked)
                    for name, got, ref in zip(("o", "m", "l"), fwd[path], want):
                        errs[f"K7a.{path}.{name}"] = _rel_check(
                            f"K7a {path} {name} at {shape} {dtype}", got, ref, tol)
                out, m, L = K._combine(*map(K._to_col, fwd["col"]), *fwd["row"])
                delta = (f32[3] * out).sum(dim=-1)
                for path, masked, view in LINE_PATHS:
                    got = K.cca_line_bwd(*(view(t) for t in (q, k, v, g, m, L, delta)), masked)
                    want = K.cca_line_bwd_plain(*(view(t) for t in (*f32, m, L, delta)), masked)
                    for name, a, b in zip(("dq", "dk", "dv"), got, want):
                        errs[f"K7b.{path}.{name}"] = _rel_check(
                            f"K7b {path} {name} at {shape} {dtype}", a, b, tol)
                torch.cuda.synchronize()
                if (K.LAUNCHES["cca_line_fwd"] != before["cca_line_fwd"] + 2
                        or K.LAUNCHES["cca_line_bwd"] != before["cca_line_bwd"] + 2):
                    raise RuntimeError(f"launch counts did not advance: {before} -> {K.LAUNCHES}")
            # the routed Function vs torch.autograd of the plain op in f32
            before = dict(K.LAUNCHES)
            leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
            out_fn = K.criss_cross_attention_cuda(*leaves)[0]
            grads = torch.autograd.grad(out_fn, leaves, g)
            leaves32 = [t.detach().clone().requires_grad_(True) for t in f32[:3]]
            out_p = plain.criss_cross_attention(*leaves32)
            grads_p = torch.autograd.grad(out_p, leaves32, f32[3])
            torch.cuda.synchronize()
            moved = {n: K.LAUNCHES[n] - before[n] for n in K.LAUNCHES}
            if moved != {**{n: 0 for n in K.LAUNCHES}, "cca_line_fwd": 2, "cca_line_bwd": 2}:
                raise AssertionError(f"the Function at {shape} launched {moved}")
            errs["fn.out"] = _rel_check(f"Function out at {shape} {dtype}", out_fn, out_p, tol)
            for name, a, b in zip(("dq", "dk", "dv"), grads, grads_p):
                errs[f"fn.{name}"] = _rel_check(f"Function {name} at {shape} {dtype}", a, b, tol)
            if shape == LINE_SHAPES[0] and dtype == torch.bfloat16:
                for kern, key in (("K7a", "cca_line_fwd"), ("K7b", "cca_line_bwd")):
                    report[key]["max_abs_err"] = max(e for n, e in errs.items()
                                                     if n.startswith(kern))
            log(f"[lines] {str(dtype)[6:]} {shape}: ok (tol {tol:g} x scale) "
                + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))

    def line_fwd(fn):
        return lambda q, k, v: [fn(view(q), view(k), view(v), masked)
                                for _, masked, view in LINE_PATHS]

    def line_bwd(fn):
        return lambda *qkvgmld: [fn(*(view(t) for t in qkvgmld), masked)
                                 for _, masked, view in LINE_PATHS]

    def k1_k4(q, k, v, g):  # the natural route forced at a long shape
        o, m_, L_ = K.cca_fwd_row(q, k, v, *K.cca_fwd_col(q, k, v))
        d = (g.float() * o.float()).sum(dim=-1)
        K.cca_bwd_row(q, k, v, g, m_, L_, d, *K.cca_bwd_col(q, k, v, g, m_, L_, d))

    def fwd_bwd(fn):
        return lambda q, k, v, g: torch.autograd.grad(fn(q, k, v), (q, k, v), g)

    bf16 = torch.bfloat16
    for shape in LINE_SHAPES[:2]:  # the long shapes, bf16
        q, k, v = _inputs(shape, bf16, seed=1)
        g = _inputs(shape, bf16, seed=2)[2]
        with torch.no_grad():
            out, m, L = K.criss_cross_attention_cuda(q, k, v)
            delta = (g.float() * out.float()).sum(dim=-1)
            stats = (q, k, v, g, m, L, delta)
            t = {"K7a": _time_ms(line_fwd(K.cca_line_fwd), q, k, v),
                 "K7a plain": _time_ms(line_fwd(K.cca_line_fwd_plain), q, k, v),
                 "K7b": _time_ms(line_bwd(K.cca_line_bwd), *stats),
                 "K7b plain": _time_ms(line_bwd(K.cca_line_bwd_plain), *stats),
                 "route fwd": _time_ms(K.cca_line_route_fwd, q, k, v),
                 "K1+K2 fwd": _time_ms(lambda *a: K.cca_fwd_row(*a, *K.cca_fwd_col(*a)), q, k, v),
                 "plain fwd": _time_ms(plain.criss_cross_attention, q, k, v),
                 "K1-K4 fwd+bwd": _time_ms(k1_k4, q, k, v, g)}
        leaves = [t_.detach().clone().requires_grad_(True) for t_ in (q, k, v)]
        t["route fwd+bwd"] = _time_ms(fwd_bwd(lambda *a: K.criss_cross_attention_cuda(*a)[0]),
                                      *leaves, g)
        t["plain fwd+bwd"] = _time_ms(fwd_bwd(plain.criss_cross_attention), *leaves, g)
        with torch.no_grad():  # both paths of one call, as timed; o and the
            # grads counted in the value dtype, as the TPU function writes them
            fwd_out = [e for o, m_, l_ in line_fwd(K.cca_line_fwd)(q, k, v)
                       for e in ((o, bf16), m_, l_)]
            bwd_out = [(e, bf16) for grads in line_bwd(K.cca_line_bwd)(*stats) for e in grads]
        bounds = {"K7a": _bound((q, k, v), fwd_out,
                                sum(_cca_flops(shape, True, p) for p in ("col", "row")), bf16),
                  "K7b": _bound(stats, bwd_out,
                                sum(_cca_flops(shape, False, p) for p in ("col", "row")), bf16)}
        del fwd_out, bwd_out, out, m, L, delta, leaves, stats
        torch.cuda.empty_cache()
        if shape == LINE_SHAPES[0]:  # the yardstick's row-or-column mask is 1.1 GB here
            fwd_sdpa, bwd_sdpa = _sdpa_yardstick(q, k, v), _sdpa_yardstick(q, k, v, g)
            _log_sdpa("lines fwd", shape, fwd_sdpa)
            _log_sdpa("lines fwd+bwd", shape, bwd_sdpa)
            report["cca_line_fwd"].update(ms=t["K7a"], plain_ms=t["K7a plain"],
                                          library_ms=fwd_sdpa[0], **bounds["K7a"])
            report["cca_line_bwd"].update(ms=t["K7b"], plain_ms=t["K7b plain"],
                                          library_ms=bwd_sdpa[0], **bounds["K7b"])
        else:
            log(f"[lines] library yardstick at {shape}: not run, its (H·W)² bool mask would "
                f"take {(shape[1] * shape[2]) ** 2 / 1e9:.1f} GB")
        log(f"[lines] times at {shape} bf16, ms (median of {TIMING_REPS}; K7a/K7b: both paths "
            f"of one call): " + ", ".join(f"{n} {ms:.4f}" for n, ms in t.items())
            + "; bounds " + ", ".join(f"{n} {b['bound_ms']:.4f} ms by {b['bound_by']}"
                                      for n, b in bounds.items()))
    return report


def _loss_case(shape, seed):
    B, h, w, C, r = shape
    H, W = (h - 1) * r + 1, (w - 1) * r + 1
    rng = np.random.RandomState(seed)
    logits = torch.from_numpy(rng.randn(B, C, h, w).astype(np.float32)).cuda()
    labels = rng.randint(0, C, (B, H, W)).astype(np.int32)
    labels[rng.rand(B, H, W) < 0.15] = 255  # ignore pixels
    g = torch.from_numpy(rng.rand(B, H, W).astype(np.float32)).cuda()
    return logits, torch.from_numpy(labels).cuda(), g


def phase_loss_kernels() -> dict:
    """K5/K6 against the materialised upsample + NLL and its autograd."""
    from ccnet_tpu_torch.ops import upsampled_ce as U

    report = {}
    for shape in LOSS_SHAPES:
        logits, labels, g = _loss_case(shape, seed=sum(shape))
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
            tag = f"{shape} {str(lab.dtype)[6:]} labels"
            for name, got, want, tol in (("K5", nll, want_nll, NLL_TOL),
                                         ("fn.fwd", fn_nll, want_nll, NLL_TOL),
                                         ("K6", dl, want_dl, NLL_GRAD_TOL),
                                         ("fn.bwd", fn_dl, want_dl, NLL_GRAD_TOL)):
                err = (got - want).abs().max().item()
                limit = tol * (1.0 if name in ("K5", "fn.fwd") else want.abs().max().item())
                if not err <= limit:
                    raise AssertionError(f"{name} at {tag}: max abs err {err:.3e} > {limit:.3e}")
                errs[name] = max(errs.get(name, 0.0), err)
        if shape == LOSS_SHAPES[0]:
            report["upsampled_nll_fwd"] = {"max_abs_err": errs["K5"]}
            report["upsampled_nll_bwd"] = {"max_abs_err": errs["K6"]}
        log(f"[loss] {shape} (B, h, w, C, r), int32 and uint8 labels: ok (K5 <= {NLL_TOL:g} abs, "
            f"K6 <= {NLL_GRAD_TOL:g} x max|plain grad|) "
            + " ".join(f"{n}={e:.2e}" for n, e in errs.items()))

    logits, labels, g = _loss_case(LOSS_SHAPES[0], seed=7)
    report["upsampled_nll_fwd"]["ms"] = _time_ms(U.upsampled_nll_fwd, logits, labels)
    report["upsampled_nll_fwd"]["plain_ms"] = _time_ms(U.upsampled_nll_reference, logits, labels)
    report["upsampled_nll_bwd"]["ms"] = _time_ms(U.upsampled_nll_bwd, logits, labels, g)
    graphs = []  # one graph per copy of the inputs, its backward timed alone
    for lg, lab, gg in _copies((logits, labels, g)):
        x = lg.clone().requires_grad_(True)
        graphs.append((U.upsampled_nll_reference(x, lab), x, gg))
    report["upsampled_nll_bwd"]["plain_ms"] = _time_ms(
        lambda nll, x, g_: torch.autograd.grad(nll, x, g_, retain_graph=True), sets=graphs)
    del graphs
    # operations per fine pixel and class, the least the function needs: the
    # height lerp (2), the width lerp shared by r rows (~1), exp and sum (2);
    # the backward twice that (recompute, then the transposed lerps)
    B, h, w, C, r = LOSS_SHAPES[0]
    fine = B * ((h - 1) * r + 1) * ((w - 1) * r + 1) * C
    report["upsampled_nll_fwd"].update(
        _bound((logits, labels), (U.upsampled_nll_fwd(logits, labels),), 5 * fine, torch.float32))
    report["upsampled_nll_bwd"].update(
        _bound((logits, labels, g), (U.upsampled_nll_bwd(logits, labels, g),), 10 * fine,
               torch.float32))
    for name in ("upsampled_nll_fwd", "upsampled_nll_bwd"):
        report[name]["library_ms"] = None  # F.interpolate + F.cross_entropy: two calls
        log(f"[loss] {name} at {LOSS_SHAPES[0]}: kernel {report[name]['ms']:.4f} ms, "
            f"plain (materialised F.interpolate + log_softmax) {report[name]['plain_ms']:.4f} ms "
            f"(median of {TIMING_REPS}), bound {report[name]['bound_ms']:.4f} ms by "
            f"{report[name]['bound_by']}; no one library call computes it")
    return report


# the probes: wrapper -> (the script's shape, the model's shape, input dtype);
# P1, P2, P3 at the model's widths: one image's columns of q (H, W, 64) and
# of v (H, W, 512), and a scale over K1's f32 o_col (8·97·97, 512)
PROBES = {
    "mid_batch_dot": ((96, 16, 64), (97, 97, 64), torch.bfloat16),
    "swap_leading": ((96, 16, 128), (97, 97, 512), torch.bfloat16),
    "scale_ragged": ((97, 256), (8 * 97 * 97, 512), torch.float32),
    "mid_batch_dot_4d": ((2, 96, 33, 64), (8, 97, 97, 64), torch.bfloat16),
    "store_transposed": ((2, 96, 33, 512), (8, 97, 97, 512), torch.bfloat16),
}
PROBE_DOT_TOL = 1e-4  # x scale: the same bf16 products, f32 sums in another order


def phase_probes() -> dict:
    """P1–P5 against their plain versions at the script's and the model's
    shapes (the copies and the scale bit-exact); at the model's shapes
    times of kernel, plain version and one library call, and the bound."""
    from ccnet_tpu_torch.ops import probes as P

    torch.backends.cuda.matmul.allow_tf32 = False
    report = {}
    for name, (small, big, dtype) in PROBES.items():
        kernel, plain = getattr(P, name), getattr(P, f"{name}_plain")
        dot = "dot" in name
        for shape in (small, big):
            rng = np.random.RandomState(sum(shape))
            xs = [torch.from_numpy(rng.randn(*shape).astype(np.float32)).to("cuda", dtype)
                  for _ in range(2 if dot else 1)]
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
        # the model's shape: times and the bound. Operations: a multiply-add
        # per channel of each logit; one multiply per scaled value; the copies
        # do no arithmetic. The one library call of the dots is a bf16 einsum
        # (bf16 output), of the copies and the scale the plain version itself
        flops = 2 * got.numel() * shape[-1] if dot else got.numel() * (name == "scale_ragged")
        entry = {"max_abs_err": err, **_bound(xs, (got,), flops, dtype),
                 "ms": _time_ms(kernel, *xs), "plain_ms": _time_ms(plain, *xs)}
        if dot:
            eq = "htc,gtc->thg" if len(shape) == 3 else "bhwc,bgwc->bwhg"
            entry["library_ms"] = _time_ms(lambda *a: torch.einsum(eq, *a), *xs)
        else:
            entry["library_ms"] = entry["plain_ms"]
        report[name] = entry
        log(f"[probes] {name}: ok at {small} and {shape} {str(dtype)[6:]} "
            f"({'<= %g x scale, err %.2e' % (PROBE_DOT_TOL, err) if dot else 'bit-exact'}); at "
            f"{shape}: kernel {entry['ms']:.4f} ms, plain {entry['plain_ms']:.4f} ms, library "
            f"{entry['library_ms']:.4f} ms, bound {entry['bound_ms']:.4f} ms by "
            f"{entry['bound_by']} (median of {TIMING_REPS})")
        del xs, got, want
    torch.cuda.empty_cache()
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


def phase_model(pth: str) -> None:
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    torch.backends.cudnn.allow_tf32 = True  # the bf16 model's default setting
    model = build_model("ccnet", num_classes=19, recurrence=2, depth=101,
                        dtype=torch.bfloat16, device="cuda")
    randomize_(model, seed=0)
    torch.save(model.state_dict(), pth)
    rng = np.random.RandomState(2)
    x = torch.from_numpy((rng.rand(8, 3, 769, 769) * 255.0 - 120.0).astype(np.float32)).cuda()
    with torch.inference_mode():
        before = K.LAUNCHES["cca_fwd_col"]
        model.set_cca_impl("kernel")
        main_k = model(x)["main"]
        if K.LAUNCHES["cca_fwd_col"] != before + 2:
            raise RuntimeError("impl='kernel' did not launch the kernels")
        model.set_cca_impl("torch")
        main_t = model(x)["main"]
        model.set_cca_impl("auto")
    torch.cuda.synchronize()
    if tuple(main_k.shape) != (8, 19, 97, 97) or not torch.isfinite(main_k).all():
        raise AssertionError(f"kernel-route logits malformed: {tuple(main_k.shape)}")
    err, scale = _err(main_k, main_t)
    agree = (main_k.argmax(1) == main_t.argmax(1)).float().mean().item()
    log(f"[model] R101 R=2 bf16 (8,3,769,769), gamma=0.5: kernel vs plain main logits "
        f"max abs err {err:.3e} (scale {scale:.3g}, tol {MODEL_TOL:g} x scale), "
        f"argmax agreement {agree:.6f} (>= {MODEL_ARGMAX})")
    if not err <= MODEL_TOL * scale or agree < MODEL_ARGMAX:
        raise AssertionError("full-model kernel route disagrees with the plain route")
    del model, main_k, main_t, x
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


def _want(hw, fwd: int, bwd: int = 0, loss: int = 0) -> dict:
    """The launch counts of ``fwd`` forward and ``bwd`` backward CCA calls on
    the OS-8 features of an ``hw`` input (one launch of each of K1–K4 per
    call, or one of K7a/K7b per path and call on the line route) and
    ``loss`` calls of each of K5/K6."""
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    want = {n: 0 for n in _counts()}
    if K.uses_line_route(*((n - 1) // 8 + 1 for n in hw)):
        want.update(cca_line_fwd=2 * fwd, cca_line_bwd=2 * bwd)
    else:
        want.update(cca_fwd_col=fwd, cca_fwd_row=fwd, cca_bwd_col=bwd, cca_bwd_row=bwd)
    want.update(upsampled_nll_fwd=loss, upsampled_nll_bwd=loss)
    return want


def _train_batch(seed: int, batch: int, hw):
    rng = np.random.RandomState(seed)
    x = (rng.rand(batch, 3, *hw) * 255.0 - 120.0).astype(np.float32)
    y = rng.randint(0, 19, (batch, *hw)).astype(np.int32)
    y[rng.rand(batch, *hw) < 0.1] = 255
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def _top_kernels(fn, top: int = 6) -> str:
    """One ``fn()`` under ``torch.profiler``: its device kernel time, and the
    ``top`` kernels by summed device time (read from the exported chrome
    trace, whose kernel events carry device time alone)."""
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
    return f"kernels {total:.1f} ms; top: " + "; ".join(
        f"{ms:.1f} ms {name[:90]}" for name, ms in ranked)


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
    classifiers'). ``profile``: also one kernel-route step under
    :func:`_top_kernels`."""
    from ccnet_tpu_torch.losses import build_criterion
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.train import create_train_state, make_train_step
    from ccnet_tpu_torch.utils import load_pth

    torch.backends.cudnn.allow_tf32 = True
    x, y = _train_batch(3, batch, hw)
    ccnet = model_name == "ccnet"
    grads = CCA_GRADS if ccnet else HEAD_GRADS
    runs = {}
    for impl in ("kernel", "torch"):
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
                      "peak": torch.cuda.max_memory_allocated(),
                      "grads": {n: p.grad.float().clone() for n, p in model.named_parameters()
                                if n in grads}}
        # the time of a second step (the first one paid for cuDNN's set-up)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, x, y)
        end.record()
        end.synchronize()
        runs[impl]["s"] = start.elapsed_time(end) / 1000.0
        if impl == "kernel" and profile:  # where the step's time goes
            log(f"[train-step] {model_name} kernel route, one step under torch.profiler: "
                + _top_kernels(lambda: step(state, x, y)))
        del model, state
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
        f"route {t['peak'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); second step "
        f"kernel route {k['s']:.4f} s ({batch / k['s']:.2f} crops/s), plain route "
        f"{t['s']:.4f} s (CUDA events)")
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
        f"augment + step), {batch / np.mean(dev):.2f} crops/s; host wall "
        f"{np.mean(wall):.4f} s/step with the synthetic loader, "
        f"{batch / np.mean(wall):.2f} crops/s; first step {result['step_seconds'][0]:.3f} s "
        f"on the card; peak memory {peak / 2**30:.2f} GiB; {out} loads with strict=True")
    return launches, out


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
    secs = result["batch_seconds"]
    log(f"[{mode}] {model_name} R{DEPTH}{' R=2' if model_name == 'ccnet' else ''} bf16 "
        f"{EVAL_HW[0]}x{EVAL_HW[1]} synthetic, 2 images {' '.join(flags)}: meanIU "
        f"{result['meanIU']:.6f}, launches {launches}, s/img {secs[1]:.4f} (second image; "
        f"first {secs[0]:.4f}); peak memory {peak / 2**30:.2f} GiB{pngs}")
    return launches


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also run one kernel-route train step of PSPNet and DeepLabv3 "
                             "under torch.profiler and print its top kernels by device time")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one H100")
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
        phase_train_step(pth, TRAIN_BATCH, (CROP, CROP))
        launches, trained = phase_train_main_path(pth, os.path.join(tmp, "snapshots"),
                                                  TRAIN_BATCH, (CROP, CROP), TRAIN_STEPS)
        phase_train_step(pth, FULL_FRAME_BATCH, FULL_FRAME)
        full_frame, _ = phase_train_main_path(pth, os.path.join(tmp, "snapshots_full"),
                                              FULL_FRAME_BATCH, FULL_FRAME, FULL_FRAME_STEPS)
        phase_main_path(trained, "sliding")
        phase_main_path(trained, "whole")
        msflip = phase_main_path(trained, "msflip")
        for name in ("pspnet", "deeplabv3"):  # the heads without attention: K5/K6
            pth = os.path.join(tmp, f"{name}_r101_random.pth")
            random_pth(name, pth)
            phase_train_step(pth, TRAIN_BATCH, (CROP, CROP), name, profile=args.profile)
            _, trained = phase_train_main_path(pth, os.path.join(tmp, f"snapshots_{name}"),
                                               TRAIN_BATCH, (CROP, CROP), HEAD_TRAIN_STEPS, name)
            phase_main_path(trained, "sliding-png", name)
    # each kernel's launches in the main path that runs it: K1–K6 in the 769²
    # cli.train run, K7a in the MS+flip evaluation, K7b in full-frame
    # cli.train, P1–P5 in cli.probe
    launches.update(cca_line_fwd=msflip["cca_line_fwd"], cca_line_bwd=full_frame["cca_line_bwd"],
                    **probe_launches)
    kernels = [{"name": name, "route": "cuda", "source": f"ccnet_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                **{key: report[name][key] for key in ("max_abs_err", "ms", "plain_ms",
                                                      "bound_ms", "bound_by", "library_ms")}}
               for name, source, replaces in KERNELS]
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
