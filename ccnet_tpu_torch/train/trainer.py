"""Training loop: the reference's ``train.py`` recipe as a library class.

Counterpart of :mod:`ccnet_tpu.train.trainer`: poly-LR SGD,
the DSN(+OHEM) criterion, epoch-seeded shuffling, a full-state checkpoint
(and a reference-named ``CS_scenes_{step}.pth``) every ``save_every`` steps
and at the end, and an emergency save when a run is interrupted.

On a CUDA device the criss-cross attention (forward and backward) and the
upsample+NLL loss (forward and backward) go through the hand-written
kernels; ``impl="torch"`` takes the plain versions of both. ``model`` is
``ccnet``, ``pspnet`` or ``deeplabv3``; the last two have no attention, so
``impl`` routes only their loss. The loader's batches reach the device
through :func:`~ccnet_tpu_torch.data.loader.device_prefetch`: batch i+1 is
copied (pinned buffers, a side stream) while step i runs, on every
``augment_backend``; the augmentation runs on the device in the step, but
for ``"native"``, which augments on the prefetch thread with the C++/OpenMP
library (draws seeded per step as in the JAX package) and copies the crops.

``remat`` recomputes backbone blocks in the backward
(:func:`~ccnet_tpu_torch.models.backbone.remat_plan`). ``profile_steps=
(start, stop)`` traces steps [start, stop) with ``torch.profiler`` into a
chrome trace under ``snapshot_dir/profile``, where the spans of
:mod:`~ccnet_tpu_torch.utils.trace` name the loop's phases
(``ccnet.train.loader_wait``, ``.augment``, ``.forward``, ``.loss``,
``.backward``, ``.optimizer``); ``tensorboard`` writes
``train/loss``, ``train/lr`` and ``train/img_per_s`` every ``log_every``
steps to ``snapshot_dir/tb``. Each of these two warns and goes on where it
is unavailable. ``space`` folds into data parallelism, as the JAX package's
``batch_sharding`` puts the batch over ``(data, space)``: over N ranks it
must divide N (else ValueError, as ``make_mesh`` raises) and the batch is
sharded over all N; in one process it is ignored, as JAX's one-device mesh
is ``None``.

Over N ranks (one process per card under torchrun, the group initialised by
:func:`~ccnet_tpu_torch.parallel.maybe_initialize_distributed`)
``batch_size`` is the global batch, of which each rank's loader yields an
equal share, in rank order; the model lives on
:func:`~ccnet_tpu_torch.parallel.rank_device` and trains through its
``DistributedDataParallel`` replica, with BN moments, dropout masks, the
OHEM threshold and the loss means taken over the global batch, so a step
equals the one-process step on the global batch. The ``device`` augmenter
draws for the global batch and takes the rank's share; the ``native``
augmenter's seed adds the rank, as the JAX trainer's adds the process
index. Checkpoints, the ``.pth``, the profiler trace and TensorBoard are
written by rank 0 only; ``resume`` loads on every rank.
"""

from __future__ import annotations

import functools
import itertools
import os
import os.path as osp
import time
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ccnet_tpu_torch.data.loader import HostToDevice, device_prefetch
from ccnet_tpu_torch.data.preprocess import (
    CITYSCAPES_MEAN_BGR,
    device_augment_batch,
    finish_u8_crops,
)
from ccnet_tpu_torch.losses import build_criterion
from ccnet_tpu_torch.models import build_model
from ccnet_tpu_torch.parallel import data_parallel, grid, is_primary_host, rank_device, world
from ccnet_tpu_torch.train.state import create_train_state
from ccnet_tpu_torch.train.step import make_train_step
from ccnet_tpu_torch.utils import (
    get_logger,
    latest_checkpoint_step,
    load_pth,
    restore_checkpoint,
    save_checkpoint,
    save_pth,
)
from ccnet_tpu_torch.utils.trace import span, sync


@dataclass
class TrainConfig:
    model: str = "ccnet"
    num_classes: int = 19
    recurrence: int = 2
    depth: int = 101
    input_size: Tuple[int, int] = (769, 769)
    batch_size: int = 8
    learning_rate: float = 1e-2
    momentum: float = 0.9
    weight_decay: float = 1e-4  # the published table recipe; run_local.sh used 5e-4
    power: float = 0.9
    num_steps: int = 60000
    ohem: bool = False
    ohem_thres: float = 0.7
    ohem_keep: int = 100000
    ignore_label: int = 255
    save_every: int = 10000
    snapshot_dir: str = "snapshots"
    restore_from: Optional[str] = None  # .pth weights (pretrained init)
    restore_last: bool = True  # False = skip the classifier layers (fine-tune)
    resume: bool = False  # resume the full state from snapshot_dir
    start_step: int = 0
    seed: int = 0
    bf16: bool = True
    remat: Any = False  # False | True (layers 3-4) | 'conv12' | 'convs' | tuple of layers
    impl: str = "auto"  # criss-cross attention and NLL: torch | kernel | auto
    export_pth: bool = True
    log_every: int = 10
    space: int = 1
    mean: Tuple[float, float, float] = CITYSCAPES_MEAN_BGR
    # 'device': the torch gather sampler on the device, raw images in;
    # 'native': the C++/OpenMP host kernel (ccnet_tpu_torch/native), f32
    # crops copied; 'host_u8': the loader yields uint8 crops (U8CropDataset),
    # the device widens and subtracts the mean; 'precropped': the loader
    # yields final crops
    augment_backend: str = "device"
    random_scale: bool = True
    random_mirror: bool = True
    scale_min: float = 0.7
    scale_steps: int = 15
    tensorboard: bool = False
    profile_steps: Optional[Tuple[int, int]] = None
    device: str = "cuda"


class Trainer:
    def __init__(self, config: TrainConfig):
        self.cfg = c = config
        self.rank, self.ranks = world()
        if self.ranks > 1:  # space folds into data parallelism (JAX's batch_sharding)
            grid(c.space)
        if c.batch_size % self.ranks:
            raise ValueError(f"global batch {c.batch_size} must divide over {self.ranks} ranks")
        if c.augment_backend == "native":
            from ccnet_tpu_torch import native

            native.load()  # raises here, not in the first step, if it does not build
        self.logger = get_logger("ccnet_tpu_torch.train")
        self.device = rank_device(c.device)
        model = build_model(c.model, num_classes=c.num_classes, recurrence=c.recurrence,
                            depth=c.depth, dtype=torch.bfloat16 if c.bf16 else torch.float32,
                            impl=c.impl, seed=c.seed, device=self.device, remat=c.remat)
        self.criterion = build_criterion(ohem=c.ohem, ignore_label=c.ignore_label,
                                         thresh=c.ohem_thres, min_kept=c.ohem_keep,
                                         impl=c.impl)
        self.state = create_train_state(model, c.learning_rate, c.num_steps, c.power,
                                        c.momentum, c.weight_decay)
        self.start_step = c.start_step
        if c.resume and latest_checkpoint_step(c.snapshot_dir) is not None:
            restore_checkpoint(c.snapshot_dir, self.state)
            self.start_step = self.state.step
            self.logger.info(f"resumed full state at step {self.start_step}")
        elif c.restore_from:
            load_pth(c.restore_from, model, skip_mismatch=not c.restore_last,
                     restore_last=c.restore_last)
            self.logger.info(f"initialised weights from {c.restore_from}")
        # as in the JAX package, --start-iters moves the step count, not the
        # schedule's own count
        self.state.step = self.start_step
        # over N ranks: broadcasts rank 0's parameters now (after any restore)
        self.train_step = make_train_step(self.criterion, seed=c.seed + 2,
                                          forward=data_parallel(model))
        self._copier = HostToDevice(self.device)
        self.tb_writer = None
        if c.tensorboard and is_primary_host():
            try:
                from torch.utils.tensorboard import SummaryWriter

                self.tb_writer = SummaryWriter(osp.join(c.snapshot_dir, "tb"))
            except Exception as e:  # noqa: BLE001 - an optional extra, as in the JAX package
                self.logger.warning(f"tensorboard unavailable: {e}")

    def _place(self, images, labels) -> tuple:
        """The loader batch's one host→device copy, on the prefetch thread:
        ``(Transfer,)`` of the raw ``(images, labels)``."""
        return (self._copier(images, labels),)

    def _native_crops(self, images, labels, steps) -> tuple:
        """``augment_backend="native"``: the batch of the step ``next(steps)``
        augmented on the host by the native library, with the JAX package's
        draws (the rank added to the seed as the JAX trainer adds the process
        index), then copied; ``(Transfer,)`` of the f32 crops and int32
        labels. Runs on the prefetch thread, which places the batches in
        their steps' order."""
        from ccnet_tpu_torch import native

        c = self.cfg
        step = next(steps)
        rng = np.random.RandomState((c.seed + step * 1009 + self.rank) % (2 ** 31))
        images, labels = np.asarray(images), np.asarray(labels)
        scales, offs, flips = native.draw_augment_params(
            rng, images.shape[0], images.shape[1:3], tuple(c.input_size),
            scale_min=c.scale_min if c.random_scale else 1.0,
            scale_steps=c.scale_steps if c.random_scale else 1, mirror=c.random_mirror)
        lut = np.arange(256, dtype=np.uint8)  # the labels arrive trainId-mapped
        crops = native.augment_batch(images.astype(np.uint8), labels.astype(np.uint8), lut,
                                     scales, offs, flips, tuple(c.input_size), c.mean,
                                     c.ignore_label)
        return (self._copier(*crops),)

    def _augment(self, images: torch.Tensor, labels: torch.Tensor, step: int):
        """Placed raw batch (NHWC) → ``(images (B, 3, H, W) f32, labels
        (B, H, W) int32)``, on the device, in the step. Over N ranks the
        ``device`` augmenter's draws are the global batch's, sliced."""
        c = self.cfg
        with span("train.augment"):
            if c.augment_backend == "device":
                imgs, lbls = device_augment_batch(
                    images, labels, seed=c.seed + 1, step=step, crop_hw=tuple(c.input_size),
                    mean=tuple(c.mean), ignore_label=c.ignore_label, scale_min=c.scale_min,
                    scale_steps=c.scale_steps, scale=c.random_scale, mirror=c.random_mirror,
                    rank=self.rank, ranks=self.ranks)
            elif c.augment_backend == "host_u8":
                imgs, lbls = finish_u8_crops(images, labels, mean=tuple(c.mean))
            elif c.augment_backend in ("precropped", "native"):
                imgs, lbls = images.float(), labels.to(torch.int32)
            else:
                raise ValueError(f"unknown augment_backend {c.augment_backend!r}")
            return imgs.permute(0, 3, 1, 2).contiguous(), lbls

    def _start_profiler(self):
        """A started ``torch.profiler`` over the host and, on a card, CUDA
        activity; None, with a warning, where it cannot start."""
        try:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            profiler = profile(activities=activities)
            profiler.__enter__()
        except Exception as e:  # noqa: BLE001 - an optional extra, as in the JAX package
            self.logger.warning(f"profiler unavailable: {e}")
            return None
        self.logger.info("profiler trace started")
        return profiler

    def _stop_profiler(self, profiler) -> None:
        """Stop ``profiler`` and write its chrome trace to
        ``snapshot_dir/profile/trace_<start>_<stop>.json``."""
        c = self.cfg
        try:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            profiler.__exit__(None, None, None)
            out = osp.join(c.snapshot_dir, "profile")
            os.makedirs(out, exist_ok=True)
            path = osp.join(out, f"trace_{c.profile_steps[0]}_{c.profile_steps[1]}.json")
            profiler.export_chrome_trace(path)
            self.logger.info(f"profiler trace written to {path}")
        except Exception as e:  # noqa: BLE001 - an optional extra, as in the JAX package
            self.logger.warning(f"profiler trace not written: {e}")

    def _save(self, step: int):
        if not is_primary_host():  # rank 0 writes for all ranks
            return
        c = self.cfg
        os.makedirs(c.snapshot_dir, exist_ok=True)
        save_checkpoint(c.snapshot_dir, self.state, step)
        if c.export_pth:
            save_pth(self.state.model, osp.join(c.snapshot_dir, f"CS_scenes_{step}.pth"))

    def run(self, loader) -> dict:
        """Train to ``num_steps``. On an exception or Ctrl-C a full-state
        checkpoint is written first, then the exception propagates."""
        try:
            return self._run(loader)
        except (KeyboardInterrupt, Exception):
            step = self.state.step
            if step > self.start_step:
                self.logger.warning(f"interrupted at step {step}; saving emergency checkpoint")
                self._save(step)
            raise

    def _run(self, loader) -> dict:
        """Returns ``{"final_step", "final_loss", "losses", "step_seconds",
        "wall_seconds"}``: the loss of every step of this run (read from
        the device at the end), each step's time from the augmentation to
        the end of the update (CUDA events on a CUDA device, the host clock
        on the CPU; the batch was copied to the device by the prefetch
        thread while the previous step ran), and each step's host time
        including the wait on the loader."""
        c = self.cfg
        cuda = self.device.type == "cuda"
        step = self.state.step
        epoch = 0
        it = None
        last_loss = float("nan")
        events, wall, losses = [], [], []
        profiler = None
        last_t = time.perf_counter()
        try:
            while step < c.num_steps:
                if it is None:
                    loader.set_epoch(epoch)
                    # batch i+1 is copied to the device while step i runs
                    place = self._place
                    if c.augment_backend == "native":  # and augmented first, for its step
                        place = functools.partial(self._native_crops, steps=itertools.count(step))
                    it = device_prefetch(iter(loader), place)
                t0 = time.perf_counter()
                with span("train.loader_wait"):
                    try:
                        transfer, _ = next(it)
                    except StopIteration:
                        epoch += 1
                        it = None
                        continue
                    images, labels = transfer.wait()
                if c.profile_steps and step == c.profile_steps[0] and is_primary_host():
                    profiler = self._start_profiler()
                if cuda:
                    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                    start.record()
                else:
                    t_dev = time.perf_counter()
                imgs, lbls = self._augment(images, labels, step)
                metrics = self.train_step(self.state, imgs, lbls)
                if cuda:
                    end.record()
                    events.append((start, end))
                else:
                    events.append(time.perf_counter() - t_dev)
                losses.append(metrics["loss"])
                step = self.state.step
                if profiler is not None and step == c.profile_steps[1]:
                    self._stop_profiler(profiler)
                    profiler = None
                if step % c.log_every == 0 or step == c.num_steps:
                    last_loss = float(metrics["loss"])  # the one host sync of the loop
                    sync("train.log_loss", self.device)
                    dt = (time.perf_counter() - last_t) / c.log_every
                    last_t = time.perf_counter()
                    lr = self.state.optimizer.param_groups[0]["lr"]
                    self.logger.info(f"step {step}/{c.num_steps} epoch {epoch} loss "
                                     f"{last_loss:.4f} lr {lr:.3e} {dt:.3f} s/step "
                                     f"{c.batch_size / dt:.2f} crops/s")
                    if self.tb_writer is not None:
                        self.tb_writer.add_scalar("train/loss", last_loss, step)
                        self.tb_writer.add_scalar("train/lr", lr, step)
                        self.tb_writer.add_scalar("train/img_per_s", c.batch_size / dt, step)
                if step % c.save_every == 0 or step == c.num_steps:
                    self._save(step)
                wall.append(time.perf_counter() - t0)
        finally:
            if it is not None:  # stop the prefetch and loader threads of a cut epoch
                it.close()
            if profiler is not None:  # a run that ended inside the profiled range
                self._stop_profiler(profiler)
            if self.tb_writer is not None:
                self.tb_writer.flush()
        if cuda:
            torch.cuda.synchronize(self.device)
            step_seconds = [a.elapsed_time(b) / 1000.0 for a, b in events]
        else:
            step_seconds = events
        return {"final_step": step, "final_loss": last_loss,
                "losses": [float(v) for v in losses], "step_seconds": step_seconds,
                "wall_seconds": wall}
