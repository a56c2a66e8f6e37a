#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ccnet_tpu_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card of compute
capability 9.0 and ``nvcc``. It imports nothing of JAX. Phases, in order; any
failure raises and exits non-zero:

1. card: the ``nvidia-smi`` name and power limit; capability (9, 0) required;
2. build: the three CUDA libraries of ``ccnet_tpu_torch/csrc`` (``cca_fwd``,
   ``cca_bwd``, ``upsampled_ce``), one ``nvcc`` each, started together;
3. kernels vs plain: K1 ``cca_fwd_col`` and K2 ``cca_fwd_row`` against their
   plain-torch versions, and the chained op against the joint-softmax
   oracle, at the sliding-tile, whole-image and edge shapes, in f32 (TF32
   off) and bf16; CUDA-event times of kernel vs plain at the sliding shape;
4. backward kernels vs plain: K3 ``cca_bwd_col`` and K4 ``cca_bwd_row``
   against their plain versions, and the autograd Function's grads against
   torch.autograd of the plain op, at the same shapes and dtypes; times;
5. loss kernels vs plain: K5 ``upsampled_nll_fwd`` and K6
   ``upsampled_nll_bwd`` against the materialised upsample + NLL and its
   autograd, int32 and uint8 labels; times at (8, 97, 97, 19) → 769²;
6. full model: CCNet-R101 R=2 bf16 with seeded random weights (``gamma`` =
   0.5, so the attention moves the logits), kernel route vs plain route on
   one (8, 3, 769, 769) batch; the weights go to a ``.pth``;
7. train step: one OHEM+DSN ``train_step`` from that ``.pth`` with the
   kernels (CCA and loss) and one with the plain versions: loss, CCA grads,
   launch counts, peak memory;
8. train main path: ``ccnet_tpu_torch.cli.train.main`` with ``--synthetic``,
   batch 8 of 769², OHEM, 4 steps from that ``.pth``; launch counts of all
   six kernels; the exported ``CS_scenes_4.pth`` loads strictly;
9. evaluation main path: ``ccnet_tpu_torch.cli.evaluate.main`` on the
   synthetic 1024×2048 set with the trained ``.pth``, sliding 769²
   windows; the forward kernels' launch counts must show that it went
   through them;
10. whole image: the same with ``--whole 1`` (kernels at 129×257).

It prints one JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

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
]


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


LIBRARIES = ("cca_fwd", "cca_bwd", "upsampled_ce")


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


def _time_ms(fn) -> float:
    """Median CUDA-event time of ``fn()`` over TIMING_REPS calls, after warm-up."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(TIMING_REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


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
                if (K.LAUNCHES["cca_fwd_col"] != before["cca_fwd_col"] + 2
                        or K.LAUNCHES["cca_fwd_row"] != before["cca_fwd_row"] + 2):
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
        q, k, v = _inputs(SLIDING, torch.bfloat16, seed=1)
        col = K.cca_fwd_col(q, k, v)
        report["cca_fwd_col"]["ms"] = _time_ms(lambda: K.cca_fwd_col(q, k, v))
        report["cca_fwd_col"]["plain_ms"] = _time_ms(lambda: K.cca_fwd_col_plain(q, k, v))
        report["cca_fwd_row"]["ms"] = _time_ms(lambda: K.cca_fwd_row(q, k, v, *col))
        report["cca_fwd_row"]["plain_ms"] = _time_ms(lambda: K.cca_fwd_row_plain(q, k, v, *col))
        op_ms = _time_ms(lambda: K.criss_cross_attention_cuda(q, k, v))
        plain_op_ms = _time_ms(lambda: plain.criss_cross_attention(q, k, v))
    for name in ("cca_fwd_col", "cca_fwd_row"):
        log(f"[kernels] {name} at {SLIDING} bf16: kernel {report[name]['ms']:.4f} ms, "
            f"plain {report[name]['plain_ms']:.4f} ms (median of {TIMING_REPS})")
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

    # times at the training shape, bf16
    q, k, v = _inputs(SLIDING, torch.bfloat16, seed=1)
    g = _inputs(SLIDING, torch.bfloat16, seed=2)[2]
    with torch.no_grad():
        out, m, L = K.criss_cross_attention_cuda(q, k, v)
        delta = (g.float() * out.float()).sum(dim=-1)
        col = K.cca_bwd_col(q, k, v, g, m, L, delta)
        report["cca_bwd_col"]["ms"] = _time_ms(lambda: K.cca_bwd_col(q, k, v, g, m, L, delta))
        report["cca_bwd_col"]["plain_ms"] = _time_ms(
            lambda: K.cca_bwd_col_plain(q, k, v, g, m, L, delta))
        report["cca_bwd_row"]["ms"] = _time_ms(
            lambda: K.cca_bwd_row(q, k, v, g, m, L, delta, *col))
        report["cca_bwd_row"]["plain_ms"] = _time_ms(
            lambda: K.cca_bwd_row_plain(q, k, v, g, m, L, delta, *col))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]

    def fwd_bwd(fn):
        return lambda: torch.autograd.grad(fn(*leaves), leaves, g)

    op_ms = _time_ms(fwd_bwd(lambda *a: K.criss_cross_attention_cuda(*a)[0]))
    plain_op_ms = _time_ms(fwd_bwd(plain.criss_cross_attention))
    for name in ("cca_bwd_col", "cca_bwd_row"):
        log(f"[bwd] {name} at {SLIDING} bf16: kernel {report[name]['ms']:.4f} ms, "
            f"plain {report[name]['plain_ms']:.4f} ms (median of {TIMING_REPS})")
    log(f"[bwd] CCA forward+backward at {SLIDING} bf16: kernels {op_ms:.4f} ms, plain "
        f"criss_cross_attention + autograd {plain_op_ms:.4f} ms (median of {TIMING_REPS})")
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
    report["upsampled_nll_fwd"]["ms"] = _time_ms(lambda: U.upsampled_nll_fwd(logits, labels))
    report["upsampled_nll_fwd"]["plain_ms"] = _time_ms(
        lambda: U.upsampled_nll_reference(logits, labels))
    report["upsampled_nll_bwd"]["ms"] = _time_ms(lambda: U.upsampled_nll_bwd(logits, labels, g))
    x = logits.clone().requires_grad_(True)
    nll_p = U.upsampled_nll_reference(x, labels)  # one graph, backward timed alone
    report["upsampled_nll_bwd"]["plain_ms"] = _time_ms(
        lambda: torch.autograd.grad(nll_p, x, g, retain_graph=True))
    for name in ("upsampled_nll_fwd", "upsampled_nll_bwd"):
        log(f"[loss] {name} at {LOSS_SHAPES[0]}: kernel {report[name]['ms']:.4f} ms, "
            f"plain (materialised F.interpolate + log_softmax) {report[name]['plain_ms']:.4f} ms "
            f"(median of {TIMING_REPS})")
    return report


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


def _reset_counts() -> None:
    from ccnet_tpu_torch.ops import cc_attention_cuda as K
    from ccnet_tpu_torch.ops import upsampled_ce as U

    for counts in (K.LAUNCHES, U.LAUNCHES):
        for key in counts:
            counts[key] = 0


def _counts() -> dict:
    from ccnet_tpu_torch.ops import cc_attention_cuda as K
    from ccnet_tpu_torch.ops import upsampled_ce as U

    return {**K.LAUNCHES, **U.LAUNCHES}


def _train_batch(seed: int):
    rng = np.random.RandomState(seed)
    x = (rng.rand(TRAIN_BATCH, 3, CROP, CROP) * 255.0 - 120.0).astype(np.float32)
    y = rng.randint(0, 19, (TRAIN_BATCH, CROP, CROP)).astype(np.int32)
    y[rng.rand(TRAIN_BATCH, CROP, CROP) < 0.1] = 255
    return torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()


def phase_train_step(pth: str) -> None:
    """One train step from the same state through the kernels and through
    the plain versions: the loss and the CCA grads agree."""
    from ccnet_tpu_torch.losses import build_criterion
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.train import create_train_state, make_train_step
    from ccnet_tpu_torch.utils import load_pth

    torch.backends.cudnn.allow_tf32 = True
    x, y = _train_batch(seed=3)
    runs = {}
    for impl in ("kernel", "torch"):
        model = build_model("ccnet", num_classes=19, recurrence=2, depth=DEPTH,
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
                                if n in CCA_GRADS}}
        # the time of a second step (the first one paid for cuDNN's set-up)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, x, y)
        end.record()
        end.synchronize()
        runs[impl]["s"] = start.elapsed_time(end) / 1000.0
        del model, state
        torch.cuda.empty_cache()
    k, t = runs["kernel"], runs["torch"]
    # each CCA kernel once per recurrence (R=2), each loss kernel once per head
    want = {n: 2 for n in k["launches"]}
    if k["launches"] != want or any(t["launches"].values()):
        raise AssertionError(f"launches: kernel route {k['launches']}, plain {t['launches']}")
    rel_loss = abs(k["loss"] - t["loss"]) / abs(t["loss"])
    rel = {n: (k["grads"][n] - t["grads"][n]).norm().item() / t["grads"][n].norm().item()
           for n in CCA_GRADS}
    log(f"[train-step] R{DEPTH} R=2 bf16 ({TRAIN_BATCH},3,{CROP},{CROP}) OHEM, gamma=0.5: loss "
        f"kernel {k['loss']:.6f} vs plain {t['loss']:.6f} (rel {rel_loss:.2e}, tol "
        f"{TRAIN_LOSS_RTOL:g}); CCA grads rel err "
        + " ".join(f"{n.split('.')[-2] if n.endswith('weight') else 'gamma'}={e:.2e}"
                   for n, e in rel.items())
        + f" (tol {TRAIN_GRAD_RTOL:g}); launches {k['launches']}")
    log(f"[train-step] peak memory: kernel route {k['peak'] / 2**30:.2f} GiB, plain route "
        f"{t['peak'] / 2**30:.2f} GiB (torch.cuda.max_memory_allocated); second step "
        f"kernel route {k['s']:.4f} s, plain route {t['s']:.4f} s (CUDA events)")
    if not rel_loss <= TRAIN_LOSS_RTOL or not all(e <= TRAIN_GRAD_RTOL for e in rel.values()):
        raise AssertionError("train step: kernel route disagrees with the plain route")
    if not all(t["grads"][n].abs().max().item() > 0 for n in CCA_GRADS):
        raise AssertionError("a CCA grad is zero: the backward kernels were not exercised")


def phase_train_main_path(pth: str, snap_dir: str) -> tuple:
    """``cli.train.main`` at the recipe's shapes; returns (launches, .pth)."""
    from ccnet_tpu_torch.cli.train import main
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.utils import load_pth

    _reset_counts()
    torch.cuda.reset_peak_memory_stats()
    result = main(["--synthetic", "--synthetic-size", "1024,2048", "--device", "cuda",
                   "--batch-size", str(TRAIN_BATCH), "--input-size", f"{CROP},{CROP}",
                   "--depth", str(DEPTH), "--ohem", "1", "--num-steps", str(TRAIN_STEPS),
                   "--save-pred-every", str(TRAIN_STEPS), "--restore-from", pth,
                   "--snapshot-dir", snap_dir])
    launches = _counts()
    peak = torch.cuda.max_memory_allocated()
    losses = result["losses"]
    if len(losses) != TRAIN_STEPS or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"train losses {losses}")
    want = TRAIN_STEPS * 2  # R=2 recurrences; main + aux heads
    if launches != {n: want for n in launches}:
        raise AssertionError(f"expected {want} launches of each kernel, got {launches}")
    out = os.path.join(snap_dir, f"CS_scenes_{TRAIN_STEPS}.pth")
    model = build_model("ccnet", num_classes=19, recurrence=2, depth=DEPTH,
                        dtype=torch.bfloat16, device="cuda")
    load_pth(out, model, strict=True)
    del model
    torch.cuda.empty_cache()
    dev = result["step_seconds"][1:]
    wall = result["wall_seconds"][1:]
    log(f"[train] cli.train R{DEPTH} R=2 bf16 OHEM bs {TRAIN_BATCH} {CROP}^2, {TRAIN_STEPS} steps: "
        f"losses {' '.join(f'{v:.4f}' for v in losses)}; launches {launches}")
    log(f"[train] steps 2-{TRAIN_STEPS}: {np.mean(dev):.4f} s/step on the card (CUDA events, "
        f"augment + step), {TRAIN_BATCH / np.mean(dev):.2f} crops/s; host wall "
        f"{np.mean(wall):.4f} s/step with the synthetic loader, "
        f"{TRAIN_BATCH / np.mean(wall):.2f} crops/s; first step {result['step_seconds'][0]:.3f} s "
        f"on the card; peak memory {peak / 2**30:.2f} GiB; {out} loads with strict=True")
    return launches, out


def _run_cli(pth: str, out_dir: str, whole: bool) -> tuple:
    from ccnet_tpu_torch.cli.evaluate import main
    from ccnet_tpu_torch.data import SyntheticDataset
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    _reset_counts()
    result = main(["--synthetic", "--synthetic-size", "1024,2048", "--restore-from", pth,
                   "--device", "cuda", "--save-preds", "0", "--output-dir", out_dir,
                   "--whole", "1" if whole else "0"])
    launches = dict(K.LAUNCHES)
    if not 0.0 <= result["meanIU"] <= 1.0:
        raise AssertionError(f"meanIU {result['meanIU']} outside [0, 1]")
    if not os.path.isfile(os.path.join(out_dir, "result.txt")):
        raise AssertionError("result.txt was not written")
    ds = SyntheticDataset(n=2, hw=(1024, 2048), num_classes=19)
    valid = sum(int((ds[i][1] != 255).sum()) for i in range(len(ds)))
    total = int(np.asarray(result["confusion"]).sum())
    if total != valid:
        raise AssertionError(f"confusion matrix sums to {total}, {valid} pixels are not ignored")
    # 2 images x 1 chunk (8 tiles, or the whole image) x R=2 recurrences,
    # and no backward
    if launches != {"cca_fwd_col": 4, "cca_fwd_row": 4, "cca_bwd_col": 0, "cca_bwd_row": 0}:
        raise AssertionError(f"expected 4 launches of each forward kernel, got {launches}")
    return result, launches


def phase_main_path(pth: str, whole: bool) -> dict:
    tag = "whole" if whole else "sliding"
    with tempfile.TemporaryDirectory() as out_dir:
        result, launches = _run_cli(pth, out_dir, whole)
    secs = result["batch_seconds"]
    log(f"[{tag}] R101 R=2 bf16 1024x2048 synthetic, 2 images: meanIU {result['meanIU']:.6f}, "
        f"launches {launches}, s/img {secs[1]:.4f} (second image; first {secs[0]:.4f})")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; needs one H100")
    smi = phase_card()
    phase_build()
    report = phase_kernels()
    report.update(phase_bwd_kernels())
    report.update(phase_loss_kernels())
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "ccnet_r101_random.pth")
        phase_model(pth)
        phase_train_step(pth)
        launches, trained = phase_train_main_path(pth, os.path.join(tmp, "snapshots"))
        phase_main_path(trained, whole=False)
        phase_main_path(trained, whole=True)
    kernels = [{"name": name, "route": "cuda", "source": f"ccnet_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"], "ms": report[name]["ms"],
                "plain_ms": report[name]["plain_ms"]} for name, source, replaces in KERNELS]
    log(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
