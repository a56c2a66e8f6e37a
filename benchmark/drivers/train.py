"""The training driver: the recipe's closed loop through the port's trainer.

Set-up builds one :class:`ccnet_tpu_torch.train.Trainer` from
``TrainConfig``, draws the frame pool and the weights from the seed on the
card, loads the weights, and drives the trainer through its first
``check_steps`` steps with the two calls its own loop makes per step
(``_augment`` on the raw frames, then ``train_step``), keeping what the
comparison needs: each step's crops and loss, the first gradient as SGD got
it (the momentum buffer after one step) and the weights' change after the
last. Those steps warm up every shape the window uses. The same trainer
then runs the window: a step starts when the last one is queued, on the
frames of the pool in a seeded order; over N ranks each rank takes its
share of each global batch and rank 0's clock ends the window for all.

After the window, with the peak memory read and the trainer freed, the
reference (``benchmark/reference``) trains a fresh f32 network from the
same weights through the same steps, and the numbers in the cell's limits
file are compared: per-step loss, per-leaf gradient and change norms, the
crops and their labels.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark import inputs
from benchmark.harness import Outcome
from benchmark.reference import models as ref_models
from benchmark.reference import train as ref_train
from benchmark.trace import reduce
from benchmark.work.flops import train_step_flops
from benchmark.work.peaks import FLOPS


def _trainer(ctx):
    from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    sgd, ohem = cfg["sgd"], cfg["ohem"]
    tc = TrainConfig(
        model=cfg["model"], num_classes=cfg["num_classes"],
        recurrence=cfg.get("recurrence", 2), depth=cfg["depth"],
        input_size=tuple(tr["crop"]), batch_size=tr["batch"],
        learning_rate=sgd["lr"], momentum=sgd["momentum"],
        weight_decay=sgd["weight_decay"], power=sgd["power"], num_steps=sgd["max_steps"],
        ohem=True, ohem_thres=ohem["thresh"], ohem_keep=ohem["min_kept"],
        ignore_label=cfg["ignore_label"], seed=ctx.seed,
        bf16=cfg["dtype"] == "bfloat16", impl="auto", export_pth=False,
        mean=tuple(cfg["mean_bgr"]), augment_backend="device",
        scale_min=tr["scale_min"], scale_steps=tr["scale_steps"],
        random_mirror=tr["mirror"], device=ctx.device.type)
    return Trainer(tc)


def _order(ctx) -> list:
    """The frame indices of each global batch, cycling through the pool in a
    seeded order: a list of ``period`` batches, step ``s`` takes
    ``[s % period]``."""
    tr = ctx.cell.traffic
    P, B = tr["pool"], tr["batch"]
    gen = torch.Generator().manual_seed(inputs.sub_seed(ctx.seed, "order"))
    perm = torch.randperm(P, generator=gen).tolist()
    period = P // math.gcd(P, B)
    return [[perm[(s * B + i) % P] for i in range(B)] for s in range(period)]


class _Stop:
    """Whether the window is over, decided on rank 0's clock and shared with
    the other ranks over a host-side group each step (no device sync)."""

    def __init__(self, ctx, end: float):
        self.end = end
        self.group = None
        if ctx.ranks > 1:
            self.group = torch.distributed.new_group(backend="gloo")

    def __call__(self, busy: bool = False) -> bool:
        """True once rank 0's clock has passed the end and ``busy`` (rank 0
        still tracing) is False."""
        over = time.perf_counter() >= self.end and not busy
        if self.group is None:
            return over
        flag = torch.tensor([1 if over else 0])
        torch.distributed.broadcast(flag, 0, group=self.group)
        return bool(flag.item())

    def max(self, value: float) -> float:
        if self.group is None:
            return value
        t = torch.tensor([value], dtype=torch.float64)
        torch.distributed.all_reduce(t, op=torch.distributed.ReduceOp.MAX, group=self.group)
        return float(t.item())

    def barrier(self):
        if self.group is not None:
            torch.distributed.barrier(group=self.group)


def run(ctx) -> Outcome | None:
    cfg, tr = ctx.cell.config, ctx.cell.traffic
    dev, seed = ctx.device, ctx.seed
    cuda = dev.type == "cuda"
    B, ranks, rank = tr["batch"], ctx.ranks, ctx.rank
    b = B // ranks
    pool, pool_labels = inputs.frames(seed, tr["pool"], tr["frame_hw"], cfg["num_classes"],
                                      cfg["ignore_label"], tr["block"], tr["border"],
                                      tr["noise"], dev)
    order = _order(ctx)
    cycle = torch.tensor([o[rank * b:(rank + 1) * b] for o in order], device=dev)
    trainer = _trainer(ctx)
    model, state = trainer.state.model, trainer.state
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    shapes = [(n, tuple(t.shape)) for n, t in model.state_dict().items()]
    model.load_state_dict(inputs.weights(shapes, seed, dev))
    start = [p.detach().clone() for p in params]

    def step(s: int):
        idx = cycle[s % len(order)]
        imgs, lbls = trainer._augment(pool[idx], pool_labels[idx], state.step)
        return imgs, lbls, trainer.train_step(state, imgs, lbls)

    check = tr["check_steps"]
    crops, losses = [], []
    for s in range(check):
        imgs, lbls, m = step(s)
        crops.append((imgs.cpu(), lbls.cpu()))
        losses.append(m["loss"])
        if s == 0:  # what SGD got: its momentum buffer after one step (none: nothing)
            bufs = [state.optimizer.state.get(p, {}).get("momentum_buffer") for p in params]
            bufs = [p.new_zeros(()) if t is None else t for t, p in zip(bufs, params)]
            grad = ref_train.norms(names, bufs)
    change = ref_train.norms(names, [p - p0 for p, p0 in zip(params, start)])
    losses = [float(v) for v in losses]
    del start, bufs, imgs, lbls, m
    stop = _Stop(ctx, 0.0)

    # the window
    profiler = stretch_box = None
    if ctx.trace:
        profiler, stretch_box = _profiler(ctx, dev, b)
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    stop.barrier()
    setup_s = ctx.setup_clock()
    t0 = time.perf_counter()
    stop.end = t0 + ctx.seconds
    n = 0
    traced = tr["trace_skip"] + 1 + tr["trace_steps"]
    while not stop(profiler is not None and n < traced):
        step(check + n)
        n += 1
        if profiler is not None and n <= traced:
            if n == traced and cuda:
                torch.cuda.synchronize(dev)
            profiler.step()
    if cuda:
        torch.cuda.synchronize(dev)
    window = time.perf_counter() - t0
    if profiler is not None:
        profiler.__exit__(None, None, None)
    peak = stop.max(float(torch.cuda.max_memory_allocated(dev))) if cuda else 0.0
    # a traffic mix may name its rate apart (the 4-card cell's spreads too widely to share a bound)
    metrics = {tr.get("rate_metric", "train_crops_per_s"): n * B / window, "setup_s": setup_s,
               "peak_mem_gib": peak / 2 ** 30}
    del step, trainer, model, state, params, cycle
    if cuda:
        torch.cuda.empty_cache()
    stop.barrier()
    if rank != 0:
        stop.barrier()
        return None

    # the reference, then the comparison
    t_ref = time.perf_counter()
    net = ref_models.build(cfg, device=dev)
    ref_models.load(net, inputs.weights(shapes, seed, dev))
    ref = ref_train.train_steps(net, pool, pool_labels, [order[s % len(order)]
                                                         for s in range(check)],
                                cfg, tr, seed, check)
    stop.barrier()
    compared = _compare(losses, grad, change, crops, ref, b)
    notes = [f"change compared over all leaves but {compared.pop('left_out')} whose "
             "reference loss gradient is under 1e-3 of the median leaf's",
             f"worst leaves: gradient {compared.pop('grad_worst')!r}, "
             f"change {compared.pop('change_worst')!r}",
             f"window {window!r} s, {n} steps of {B} crops over {ranks} rank(s); "
             f"setup {setup_s!r} s; reference {time.perf_counter() - t_ref!r} s",
             f"losses {losses!r}; reference {ref['losses']!r}"]
    stretch = stretch_box[0] if stretch_box else None
    if stretch is not None:
        notes.append(f"traced {stretch.steps} steps in {stretch.window_s!r} s, "
                     f"device busy {stretch.busy_s!r} s")
    return Outcome(metrics=metrics, attempted=n, failed=0, memory_peak_bytes=int(peak),
                   compared=compared, stretch=stretch, notes=notes)


def _profiler(ctx, dev, per_rank_batch: int):
    """A started ``torch.profiler`` whose schedule records ``trace_steps``
    steps after ``trace_skip`` and a warm-up step, reduced in memory when
    they end; rank 0 only (None elsewhere)."""
    if ctx.rank != 0:
        return None, None
    from torch.profiler import ProfilerActivity, profile, schedule

    cfg, tr = ctx.cell.config, ctx.cell.traffic
    crop = tuple(tr["crop"])
    box = []
    info = {"kind": "train", "batch": per_rank_batch, "crop": crop,
            "classes": cfg["num_classes"], "dtype": cfg["dtype"], "ranks": ctx.ranks,
            "recurrence": cfg.get("recurrence", 0),
            "qk": cfg.get("qk_channels"), "v": cfg.get("inter_channels"),
            "feature_hw": (ref_train.os8(crop[0]), ref_train.os8(crop[1])),
            "flops_per_step": train_step_flops(cfg, per_rank_batch, crop),
            "peak_flops": FLOPS[cfg["dtype"]], "nll_calls": 2}  # DSN: main and aux

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


def _gap(a: float, b: float, floor: float) -> float:
    return abs(a - b) / max(abs(b), floor)


def _compare(losses, grad, change, crops, ref, b: int) -> dict:
    """The numbers the cell's limits name (see PERF.md for why each), and the
    worst leaves' gaps beside them (``*_worst``, reported, not compared)."""
    out = {}
    out["loss_gap"] = max(_gap(p, r, 0.0) for p, r in zip(losses, ref["losses"]))
    med = statistics.median(ref["grad"].values())
    gaps = {k: _gap(grad[k], v, med) for k, v in ref["grad"].items()}
    out["grad_gap"] = statistics.median(gaps.values())
    out["grad_worst"] = max(gaps.items(), key=lambda kv: kv[1])
    # leaves whose loss gradient is nought to rounding in the reference move
    # by round-off alone: they are left out of the change
    loss_med = statistics.median(ref["loss_grad"].values())
    moved = [k for k, v in ref["loss_grad"].items() if v >= 1e-3 * loss_med]
    med = statistics.median(ref["change"][k] for k in moved)
    gaps = {k: _gap(change[k], ref["change"][k], med) for k in moved}
    out["change_gap"] = statistics.median(gaps.values())
    out["change_worst"] = max(gaps.items(), key=lambda kv: kv[1])
    out["left_out"] = len(ref["loss_grad"]) - len(moved)
    crop_gap, miss = 0.0, 0.0
    for (pi, pl), (ri, rl) in zip(crops, ref["crops"]):
        ri, rl = ri[:b].cpu(), rl[:b].cpu()
        crop_gap = max(crop_gap, float((pi.float() - ri).abs().max()))
        miss = max(miss, float((pl.long() != rl).float().mean()))
    out["crop_gap"] = crop_gap
    out["label_miss"] = miss
    return out
