"""Readings that set the limits of a cell's comparison (PERF.md §2).

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--program] [--control]

``--program`` runs the cell's driver once a seed in this one process, with
a short window, and prints the numbers it compares: the program's readings,
the lower end of each limit. ``--control`` prints, for each seed, the same
numbers for the reference in the program's place computed with its
products' operands rounded to float8 (the control, which must fail), and
for each fault the cell can have, planted in the reference in the
program's place: a training step on half of each batch, crops mirrored the
wrong way; for serving, one block of an answer's trainIds changed. Each
line is one JSON object. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != _HERE]
sys.path.insert(0, os.path.dirname(_HERE))

import torch  # noqa: E402

from benchmark import harness, inputs  # noqa: E402
from benchmark.reference import models as ref_models  # noqa: E402
from benchmark.reference import serve as ref_serve  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402


def _train_variants(cell, seed, dev, driver) -> dict:
    cfg, tr = cell.config, cell.traffic
    pool, labels = inputs.frames(seed, tr["pool"], tr["frame_hw"], cfg["num_classes"],
                                 cfg["ignore_label"], tr["block"], tr["border"], tr["noise"],
                                 dev)
    ctx = harness.Context(cell=cell, seed=seed, seconds=0, trace=False, device=dev)
    order = driver._order(ctx)
    batches = [order[s % len(order)] for s in range(tr["check_steps"])]
    net = ref_models.build(cfg, device="meta")
    shapes = ref_models.state_names(net)
    out = {}

    def steps(prec="f32", fault=None):
        net = ref_models.build(cfg, device=dev)
        ref_models.load(net, inputs.weights(shapes, seed, dev))
        got = ref_train.train_steps(net, pool, labels, batches, cfg, tr, seed,
                                    tr["check_steps"], prec, fault)
        got["crops"] = [(i.cpu(), lb.cpu()) for i, lb in got["crops"]]
        return got

    base = steps()
    for name, prec, fault in (("control_fp8", "fp8", None), ("half_batch", "f32", "half_batch"),
                              ("mirror", "f32", "mirror")):
        v = steps(prec, fault)
        got = driver._compare(v["losses"], v["grad"], v["change"], v["crops"], base,
                              tr["batch"])
        got.pop("left_out")
        out[name] = got
    return out


def _serve_variants(cell, seed, dev, driver) -> dict:
    cfg, tr = cell.config, cell.traffic
    frames, _ = inputs.frames(seed, tr["pool"], tr["frame_hw"], cfg["num_classes"],
                              cfg["ignore_label"], tr["block"], tr["border"], tr["noise"], dev)
    ctx = harness.Context(cell=cell, seed=seed, seconds=0, trace=False, device=dev)
    shapes = ref_models.state_names(ref_models.build(cfg, device="meta"))
    weights = driver._weights(ctx, shapes, frames[0])
    net = ref_models.build(cfg, device=dev)
    ref_models.load(net, {k: v.to(dev) for k, v in weights.items()})
    out = {"control_fp8": 0.0, "altered_block": 0.0}
    for f in range(tr["check_requests"]):
        args = (net, frames[f], cfg["mean_bgr"], tr["tile"], tr["overlap"], cfg["num_classes"])
        base = ref_serve.predict_sliding(*args)
        low = ref_serve.predict_sliding(*args, prec="fp8")
        out["control_fp8"] = max(out["control_fp8"], driver.id_gap(base, low.argmax(0))[0])
        ids = base.argmax(0)
        ids[:64, :64] = (ids[:64, :64] + 1) % cfg["num_classes"]
        out["altered_block"] = max(out["altered_block"], driver.id_gap(base, ids)[0])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--control", action="store_true")
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda:0")
    driver = cell.driver()
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.program:
            ctx = harness.Context(cell=cell, seed=seed, seconds=args.seconds, trace=False,
                                  device=dev)
            got = driver.run(ctx)
            print(json.dumps({"seed": seed, "program": got.compared, "notes": got.notes,
                              "seconds": time.perf_counter() - t}), flush=True)
            torch.cuda.empty_cache()
        if args.control:
            kind = cell.traffic["driver"]
            got = (_train_variants if kind == "train" else _serve_variants)(cell, seed, dev,
                                                                            driver)
            print(json.dumps({"seed": seed, "variants": got,
                              "seconds": time.perf_counter() - t}), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
