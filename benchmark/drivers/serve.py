"""The serving driver: one client, closed loop, through ``Evaluator.predict_batch``.

Set-up builds the port's model (``build_model``, eval mode) and an
:class:`ccnet_tpu_torch.evaluation.Evaluator` as ``cli.predict`` does,
draws the frame pool (held on the host, uint8 BGR) and the weights from the
seed, sets the weights' BN statistics by one batch through the reference
(:func:`benchmark.reference.serve.calibrate`), loads them, and serves
``warmup_requests`` requests. In the window one client sends a frame of the
pool (in a seeded order) as soon as the last answer is back: a request is
timed from the moment the image is handed to the port until its trainIds
are a host array.

The sample that is judged is drawn from the seed as the answers come
(a reservoir of ``check_requests``, uniform over every answered request),
so the driver holds only those answers: keeping each 2 MiB answer alive
grew the host's memory by 2 GiB a window and slowed the later requests
(the port's own allocation of each answer still counts). Python's
collector is off in the window. After the window, with the peak memory
read and the model freed, the sample is judged against the reference's
sliding prediction of the same frame: at each pixel, how far the
reference's logit of the class the port answered lies below the
reference's best, over the image's class spread (``id_gap``, the widest
over the sample).
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from benchmark import inputs
from benchmark.harness import Outcome
from benchmark.reference import models as ref_models
from benchmark.reference import serve as ref_serve
from benchmark.trace import reduce
from benchmark.work.flops import forward_flops
from benchmark.work.peaks import FLOPS


def _weights(ctx, shapes, frame: torch.Tensor) -> dict:
    """The seeded weights with BN statistics of one batch of tiles of
    ``frame`` through the reference, as host tensors."""
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    net = ref_models.build(cfg, device=ctx.device)
    ref_models.load(net, inputs.weights(shapes, ctx.seed, ctx.device))
    x = (frame.double() - torch.tensor(cfg["mean_bgr"], dtype=torch.float64,
                                       device=frame.device)).float().permute(2, 0, 1)
    boxes = ref_serve.tiles(frame.shape[:2], tr["tile"], tr["overlap"])
    batch = torch.stack([x[:, y1:y2, x1:x2]
                         for y1, x1, y2, x2 in boxes[:tr["calibration_tiles"]]])
    ref_serve.calibrate(net, batch)
    state = net.state_dict()
    return {n: state[n].detach().cpu() for n, _ in shapes}


def run(ctx) -> Outcome:
    from ccnet_tpu_torch.evaluation import Evaluator
    from ccnet_tpu_torch.models import build_model

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, seed = ctx.device, ctx.seed
    cuda = dev.type == "cuda"
    frames, _ = inputs.frames(seed, tr["pool"], tr["frame_hw"], cfg["num_classes"],
                              cfg["ignore_label"], tr["block"], tr["border"], tr["noise"], dev)
    model = build_model(cfg["model"], num_classes=cfg["num_classes"],
                        recurrence=cfg.get("recurrence", 2), depth=cfg["depth"],
                        dtype=getattr(torch, cfg["dtype"]), impl="auto", seed=0, device=dev)
    shapes = [(n, tuple(t.shape)) for n, t in model.state_dict().items()]
    weights = _weights(ctx, shapes, frames[0])
    model.load_state_dict(weights)
    host_frames = frames.cpu().numpy()
    del frames
    order = list(range(tr["pool"]))
    random.Random(inputs.sub_seed(seed, "order")).shuffle(order)

    def apply_fn(x):
        return model(x)["main"]

    evaluator = Evaluator(apply_fn, num_classes=cfg["num_classes"], tile_hw=tuple(tr["tile"]),
                          mean=tuple(cfg["mean_bgr"]), device=dev)
    for i in range(tr["warmup_requests"]):
        evaluator.predict_batch(host_frames[order[i % len(order)]][None])

    profiler = box = None
    if ctx.trace:
        profiler, box = _profiler(ctx, dev)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = ctx.setup_clock()
    latencies, answers = [], []
    draw = random.Random(inputs.sub_seed(seed, "sample"))
    keep = tr["check_requests"]
    traced = tr["trace_skip"] + 1 + tr["trace_steps"]
    gc.collect()
    gc.disable()
    t0 = time.perf_counter()
    end = t0 + ctx.seconds
    while time.perf_counter() < end or (profiler is not None and len(latencies) < traced):
        i = len(latencies)
        frame = order[i % len(order)]
        sent = time.perf_counter()
        ids = evaluator.predict_batch(host_frames[frame][None])
        latencies.append(time.perf_counter() - sent)
        if i < keep:
            answers.append((frame, ids[0]))
        else:
            j = draw.randrange(i + 1)
            if j < keep:
                answers[j] = (frame, ids[0])
        if profiler is not None and len(latencies) <= traced:
            profiler.step()
    window = time.perf_counter() - t0
    gc.enable()
    if profiler is not None:
        profiler.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    n = len(latencies)
    metrics = {"serve_img_per_s": n / window, "serve_p95_ms": p95_ms(latencies),
               "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    del evaluator, model, apply_fn
    if cuda:
        torch.cuda.empty_cache()

    # the sample, judged against the reference
    t_ref = time.perf_counter()
    net = ref_models.build(cfg, device=dev)
    ref_models.load(net, {k: v.to(dev) for k, v in weights.items()})
    worst, flips = 0.0, []
    for frame, ids in answers:
        image = torch.from_numpy(host_frames[frame]).to(dev)
        logits = ref_serve.predict_sliding(net, image, cfg["mean_bgr"], tr["tile"],
                                           tr["overlap"], cfg["num_classes"])
        gap, flip = id_gap(logits, torch.from_numpy(ids).to(dev))
        worst = max(worst, gap)
        flips.append(flip)
    notes = [f"window {window!r} s, {n} requests (p95 over all {n}); setup {setup_s!r} s; "
             f"reference {time.perf_counter() - t_ref!r} s over {len(answers)} requests",
             f"share of pixels answered other than the reference's best: {flips!r}"]
    stretch = box[0] if box else None
    if stretch is not None:
        notes.append(f"traced {stretch.steps} requests in {stretch.window_s!r} s, "
                     f"device busy {stretch.busy_s!r} s")
    return Outcome(metrics=metrics, attempted=n, failed=0, memory_peak_bytes=int(peak),
                   compared={"id_gap": worst}, stretch=stretch, notes=notes)


def p95_ms(latencies) -> float:
    """The 95th percentile of every request's latency (seconds), in ms,
    interpolated linearly between the two nearest ranks."""
    return 1e3 * float(np.percentile(np.asarray(latencies, dtype=np.float64), 95))


def id_gap(logits: torch.Tensor, ids: torch.Tensor) -> tuple:
    """``(widest gap, share of pixels not at the best)`` of answered class
    ids (H, W) against reference logits (C, H, W): the reference's best
    logit less its logit of the answered class, over the standard deviation
    of the logits about each pixel's mean over classes."""
    best = logits.max(dim=0).values
    got = logits.gather(0, ids.long()[None])[0]
    spread = (logits - logits.mean(dim=0, keepdim=True)).std()
    return float((best - got).max() / spread), float((got < best).float().mean())


def _profiler(ctx, dev):
    """A started ``torch.profiler`` recording ``trace_steps`` requests after
    ``trace_skip`` and a warm-up request, reduced in memory when they end."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    tile = tuple(tr["tile"])
    boxes = len(ref_serve.tiles(tr["frame_hw"], tile, tr["overlap"]))
    flops, shape = forward_flops(cfg, boxes, tile)
    box = []
    info = {"kind": "serve", "batch": boxes, "crop": tile, "classes": cfg["num_classes"],
            "dtype": cfg["dtype"], "ranks": 1,
            "recurrence": cfg.get("recurrence", 0),
            "qk": cfg.get("qk_channels"), "v": cfg.get("inter_channels"),
            "feature_hw": tuple(shape[2:]), "flops_per_step": flops,
            "peak_flops": FLOPS[cfg["dtype"]]}

    def ready(prof):
        box.append(reduce(prof.profiler.kineto_results.events(), tr["trace_steps"], info))

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities, on_trace_ready=ready,
                   schedule=schedule(wait=tr["trace_skip"], warmup=1,
                                     active=tr["trace_steps"], repeat=1))
    prof.__enter__()
    return prof, box
