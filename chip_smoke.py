#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``ccnet_tpu_torch``) on one H100.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card of compute
capability 9.0 and ``nvcc``. It imports nothing of JAX. Phases, in order; any
failure raises and exits non-zero:

1. card: the ``nvidia-smi`` name and power limit; capability (9, 0) required;
2. build: the CUDA kernels from ``ccnet_tpu_torch/csrc`` with ``nvcc``;
3. kernels vs plain: K1 ``cca_fwd_col`` and K2 ``cca_fwd_row`` against their
   plain-torch versions, and the chained op against the joint-softmax
   oracle, at the sliding-tile, whole-image and edge shapes, in f32 (TF32
   off) and bf16; CUDA-event times of kernel vs plain at the sliding shape;
4. full model: CCNet-R101 R=2 bf16 with seeded random weights (``gamma`` =
   0.5, so the attention moves the logits), kernel route vs plain route on
   one (8, 3, 769, 769) batch;
5. main path: ``ccnet_tpu_torch.cli.evaluate.main`` on the synthetic
   1024×2048 set with those weights, sliding 769² windows; the kernels'
   launch counts must show that it went through them;
6. whole image: the same with ``--whole 1`` (kernels at 129×257).

It prints one JSON line of per-kernel results, then, as the last line,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
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


def phase_build() -> None:
    from ccnet_tpu_torch.ops import _build, cc_attention_cuda

    t0 = time.perf_counter()
    cc_attention_cuda.build()
    log(f"[build] cca_fwd built in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_SECONDS['cca_fwd']:.2f} s)")
    for line in _build.PTXAS_REPORT.get("cca_fwd", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] {line.strip()}")


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
                        err, scale = _err(got, want)
                        errs[f"{kern}.{name}"] = err
                        if not err <= tol * scale:
                            raise AssertionError(
                                f"{kern} {name} at {shape} {dtype}: max abs err {err:.3e} > "
                                f"{tol:g} x scale {scale:.3g}")
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


def _run_cli(pth: str, out_dir: str, whole: bool) -> tuple:
    from ccnet_tpu_torch.cli.evaluate import main
    from ccnet_tpu_torch.data import SyntheticDataset
    from ccnet_tpu_torch.ops import cc_attention_cuda as K

    for key in K.LAUNCHES:
        K.LAUNCHES[key] = 0
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
    # 2 images x 1 chunk (8 tiles, or the whole image) x R=2 recurrences
    if launches != {"cca_fwd_col": 4, "cca_fwd_row": 4}:
        raise AssertionError(f"expected 4 launches of each kernel, got {launches}")
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
    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "ccnet_r101_random.pth")
        phase_model(pth)
        launches = phase_main_path(pth, whole=False)
        phase_main_path(pth, whole=True)
    replaces = {"cca_fwd_col": "ccnet_tpu/ops/cc_attention_pallas.py:123",
                "cca_fwd_row": "ccnet_tpu/ops/cc_attention_pallas.py:159"}
    kernels = [{"name": name, "route": "cuda", "source": "ccnet_tpu_torch/csrc/cca_fwd.cu",
                "replaces": replaces[name], "launches": launches[name],
                "max_abs_err": report[name]["max_abs_err"], "ms": report[name]["ms"],
                "plain_ms": report[name]["plain_ms"]} for name in ("cca_fwd_col", "cca_fwd_row")]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
