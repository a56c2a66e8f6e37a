"""Where the time of one evaluated image goes, for the PyTorch/CUDA port.

    python scripts/profile_eval_torch.py [--whole] [--images 2] [--trace DIR]

Builds CCNet-R101 R=2 bf16 on the CUDA card (seeded initial weights; speed
does not depend on their values), warms up on one synthetic 1024×2048
image, then runs ``Evaluator.predict_batch`` on ``--images`` more under
``torch.profiler`` and prints:

* the wall seconds per image (host clock around work that ends in a copy of
  the predictions to the host);
* the card's busy time per image (the union of its kernel, memcpy and
  memset intervals in the profiler's trace) and its idle share,
  ``1 - busy / wall``;
* the busy time by kind (convolution and matrix-product kernels, the
  criss-cross attention kernels, copies and elementwise kernels, the rest)
  and the 15 most expensive kernels;
* one JSON line with those numbers.

Needs a CUDA card; it does not fall back to the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

KINDS = (  # (kind, substrings of the kernel name), first match wins
    ("cca_kernels", ("cca_line_kernel",)),
    ("conv_gemm", ("conv", "xmma", "gemm", "cutlass", "sm90_", "implicit", "wgrad", "dgrad")),
    ("copy_elementwise", ("elementwise", "copy", "memcpy", "memset", "cat", "permute",
                          "transpose", "fill")),
)


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy_us(events) -> float:
    """Length of the union of the events' [ts, ts + dur) intervals."""
    busy, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if start > end:
            busy += stop - start
            end = stop
        elif stop > end:
            busy += stop - end
            end = stop
    return busy


def kind_of(name: str) -> str:
    low = name.lower()
    for kind, keys in KINDS:
        if any(k in low for k in keys):
            return kind
    return "other"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--whole", action="store_true", help="whole-image inference")
    p.add_argument("--images", type=int, default=2)
    p.add_argument("--trace", type=str, default=None,
                   help="directory to keep the chrome trace in (default: a temporary one)")
    args = p.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ccnet_tpu_torch.data import SyntheticDataset
    from ccnet_tpu_torch.evaluation import Evaluator
    from ccnet_tpu_torch.models import build_model
    from ccnet_tpu_torch.utils import resolve_device

    device = resolve_device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    model = build_model("ccnet", dtype=torch.bfloat16, device=device)
    evaluator = Evaluator(lambda x: model(x)["main"], num_classes=19, whole=args.whole,
                          device=device)
    images = SyntheticDataset(n=1, hw=(1024, 2048))[0][0][None]
    evaluator.predict_batch(images)  # warm-up: cuDNN algorithm search, allocator
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.images):
            evaluator.predict_batch(images)
        wall = (time.perf_counter() - t0) / args.images
    mode = "whole" if args.whole else "sliding"
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = args.trace or tmp
        os.makedirs(trace_dir, exist_ok=True)
        trace = os.path.join(trace_dir, f"eval_{mode}.json")
        prof.export_chrome_trace(trace)
        with open(trace) as f:
            events = [e for e in json.load(f)["traceEvents"]
                      if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    if not events:
        raise RuntimeError("the profiler recorded no device activity")
    per_img = 1e3 * args.images  # trace times are microseconds
    busy = device_busy_us(events) / per_img / 1e3
    by_kind: dict = {}
    by_name: dict = {}
    for e in events:
        by_kind[kind_of(e["name"])] = by_kind.get(kind_of(e["name"]), 0.0) + e["dur"]
        tot, n = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (tot + e["dur"], n + 1)
    print(smi)
    print(f"[{mode}] wall {wall:.4f} s/img, device busy {busy:.4f} s/img, "
          f"idle share {1 - busy / wall:.3f}")
    for kind, us in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {kind:18s} {us / per_img:9.3f} ms/img")
    for name, (us, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us / per_img:9.3f} ms/img  x{n // args.images:<4d} {name[:110]}")
    print(json.dumps({"mode": mode, "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
                      "wall_s_per_img": wall, "busy_s_per_img": busy,
                      "idle_share": 1 - busy / wall,
                      "ms_per_img_by_kind": {k: v / per_img for k, v in by_kind.items()}}))
    return wall


if __name__ == "__main__":
    main()
