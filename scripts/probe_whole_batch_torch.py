"""Probe: does batching whole 1024x2048 images win per-image time on the
card? The port of ``scripts/probe_whole_batch.py``.

The whole-image path (``--whole``) accepts an image batch; on one card the
question is whether a B > 1 whole-image forward amortises the host's work
per call (launches, the line route's reshapes) enough to beat B = 1 per
image, and whether it fits. Measures the flagship R101 R=2 bf16 eval-mode
forward, ``predict_whole`` (logits upsampled to the image) and the argmax
at B = 1, 2 and 4 over the same four 1024×2048 images drawn from
``RandomState(4)`` (×30): ms per batch and per image by CUDA events after
a warm call, and, per B > 1, the share of pixels whose argmax equals B =
1's, image by image. The weights are seeded and randomised
(``randomize_``: ``gamma`` = 0.5, so the attention moves the logits).

    python scripts/probe_whole_batch_torch.py [--device cuda]

A B that runs out of memory prints its OOM (only
``torch.cuda.OutOfMemoryError`` is caught). Runs on the CUDA card (it
raises when there is none) unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ccnet_tpu_torch.evaluation import predict_whole  # noqa: E402
from ccnet_tpu_torch.evaluation.evaluator import _elapsed, _mark  # noqa: E402
from ccnet_tpu_torch.models import build_model, randomize_  # noqa: E402
from ccnet_tpu_torch.ops import launch_counts  # noqa: E402
from ccnet_tpu_torch.utils import resolve_device  # noqa: E402

BATCHES, HW, REPS = (1, 2, 4), (1024, 2048), 3


def probe(device: str = "cuda", depth: int = 101, hw=HW, batches=BATCHES,
          reps: int = REPS) -> dict:
    """``{B: {"ms_per_batch", "ms_per_img", "forwards", "agreement"}}`` (or
    ``{"oom": message}``) and the kernels' launches over the whole probe:
    each B runs one warm call, then ``reps`` passes over the images in
    batches of B; ``agreement`` lists, per image, the share of its pixels
    whose argmax equals B = 1's."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    model = build_model("ccnet", num_classes=19, recurrence=2, depth=depth,
                        dtype=torch.bfloat16, impl="auto", device=dev)
    randomize_(model, seed=0)
    rng = np.random.RandomState(4)
    n = max(batches)
    x = torch.from_numpy(np.ascontiguousarray(
        (rng.randn(n, *hw, 3).astype(np.float32) * 30.0).transpose(0, 3, 1, 2))).to(dev)

    def eval_img(img):
        return predict_whole(lambda t: model(t)["main"], img, 19).argmax(1).to(torch.uint8)

    before = launch_counts()
    out, first = {}, None
    with torch.inference_mode():
        for B in batches:
            chunks = [x[i:i + B] for i in range(0, n, B)]
            try:
                eval_img(chunks[0])  # cuDNN's set-up for this batch
                start = _mark(dev)
                for _ in range(reps):
                    preds = [eval_img(c) for c in chunks]
                dt = _elapsed(start, _mark(dev)) / reps
                preds = torch.cat(preds).cpu().numpy()
            except torch.cuda.OutOfMemoryError as e:
                out[B] = {"oom": str(e).splitlines()[0][:200]}
                if cuda:
                    torch.cuda.empty_cache()
                continue
            first = preds if first is None else first
            out[B] = {"ms_per_batch": 1e3 * dt / len(chunks), "ms_per_img": 1e3 * dt / n,
                      "forwards": 1 + reps * len(chunks),
                      "agreement": [float((p == q).mean()) for p, q in zip(preds, first)]}
    after = launch_counts()
    return {"device": torch.cuda.get_device_name(dev) if cuda else "cpu", "hw": list(hw),
            "depth": depth, "timed_by": "CUDA events" if cuda else "host clock",
            "batches": out,
            "launches": {k: after[k] - before[k] for k in after if after[k] != before[k]}}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = p.parse_args(argv)
    r = probe(args.device)
    for B, b in r["batches"].items():
        if "oom" in b:
            print(f"B={B}: out of memory — {b['oom']}", flush=True)
        else:
            print(f"B={B}: {b['ms_per_batch']:8.1f} ms/batch  {b['ms_per_img']:7.1f} ms/img  "
                  f"argmax agreement with B=1 "
                  + " ".join(f"{a:.6f}" for a in b["agreement"]), flush=True)
    print(json.dumps(r), flush=True)
    return r


if __name__ == "__main__":
    main()
