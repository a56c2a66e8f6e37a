"""Training loop: the reference's ``train.py`` recipe as a library class.

Counterpart of :mod:`ccnet_tpu.train.trainer`, on one device: poly-LR SGD,
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
``augment_backend``; the augmentation runs on the device in the step.

Not ported yet (they raise): ``augment_backend="native"``, ``remat`` other
than off, ``tensorboard`` and ``profile_steps``; ``space`` > 1.
"""

from __future__ import annotations

import os
import os.path as osp
import time
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from ccnet_tpu_torch.data.loader import HostToDevice, device_prefetch
from ccnet_tpu_torch.data.preprocess import (
    CITYSCAPES_MEAN_BGR,
    device_augment_batch,
    finish_u8_crops,
)
from ccnet_tpu_torch.losses import build_criterion
from ccnet_tpu_torch.models import build_model
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
    remat: Any = False  # not ported yet: only False
    impl: str = "auto"  # criss-cross attention and NLL: torch | kernel | auto
    export_pth: bool = True
    log_every: int = 10
    space: int = 1
    mean: Tuple[float, float, float] = CITYSCAPES_MEAN_BGR
    # 'device': the torch gather sampler on the device, raw images in;
    # 'host_u8': the loader yields uint8 crops (U8CropDataset), the device
    # widens and subtracts the mean; 'precropped': the loader yields final
    # crops; 'native' is not ported yet
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
        for name, off in (("augment_backend='native'", c.augment_backend == "native"),
                          ("remat", bool(c.remat)), ("tensorboard", c.tensorboard),
                          ("profile_steps", c.profile_steps is not None),
                          ("space > 1", c.space > 1)):
            if off:
                raise NotImplementedError(f"TrainConfig {name} is not ported yet")
        self.logger = get_logger("ccnet_tpu_torch.train")
        self.device = torch.device(c.device)
        model = build_model(c.model, num_classes=c.num_classes, recurrence=c.recurrence,
                            depth=c.depth, dtype=torch.bfloat16 if c.bf16 else torch.float32,
                            impl=c.impl, seed=c.seed, device=self.device)
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
        self.train_step = make_train_step(self.criterion, seed=c.seed + 2)
        self._copier = HostToDevice(self.device)

    def _place(self, images, labels) -> tuple:
        """The loader batch's one host→device copy, on the prefetch thread:
        ``(Transfer,)`` of the raw ``(images, labels)``."""
        return (self._copier(images, labels),)

    def _augment(self, images: torch.Tensor, labels: torch.Tensor, step: int):
        """Placed raw batch (NHWC) → ``(images (B, 3, H, W) f32, labels
        (B, H, W) int32)``, on the device, in the step."""
        c = self.cfg
        if c.augment_backend == "device":
            imgs, lbls = device_augment_batch(
                images, labels, seed=c.seed + 1, step=step, crop_hw=tuple(c.input_size),
                mean=tuple(c.mean), ignore_label=c.ignore_label, scale_min=c.scale_min,
                scale_steps=c.scale_steps, scale=c.random_scale, mirror=c.random_mirror)
        elif c.augment_backend == "host_u8":
            imgs, lbls = finish_u8_crops(images, labels, mean=tuple(c.mean))
        elif c.augment_backend == "precropped":
            imgs, lbls = images.float(), labels.to(torch.int32)
        else:
            raise ValueError(f"unknown augment_backend {c.augment_backend!r}")
        return imgs.permute(0, 3, 1, 2).contiguous(), lbls

    def _save(self, step: int):
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
        last_t = time.perf_counter()
        try:
            while step < c.num_steps:
                if it is None:
                    loader.set_epoch(epoch)
                    # batch i+1 is copied to the device while step i runs
                    it = device_prefetch(iter(loader), self._place)
                t0 = time.perf_counter()
                try:
                    transfer, _ = next(it)
                except StopIteration:
                    epoch += 1
                    it = None
                    continue
                images, labels = transfer.wait()
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
                if step % c.log_every == 0 or step == c.num_steps:
                    last_loss = float(metrics["loss"])  # the one host sync of the loop
                    dt = (time.perf_counter() - last_t) / c.log_every
                    last_t = time.perf_counter()
                    lr = self.state.optimizer.param_groups[0]["lr"]
                    self.logger.info(f"step {step}/{c.num_steps} epoch {epoch} loss "
                                     f"{last_loss:.4f} lr {lr:.3e} {dt:.3f} s/step "
                                     f"{c.batch_size / dt:.2f} crops/s")
                if step % c.save_every == 0 or step == c.num_steps:
                    self._save(step)
                wall.append(time.perf_counter() - t0)
        finally:
            if it is not None:  # stop the prefetch and loader threads of a cut epoch
                it.close()
        if cuda:
            torch.cuda.synchronize(self.device)
            step_seconds = [a.elapsed_time(b) / 1000.0 for a, b in events]
        else:
            step_seconds = events
        return {"final_step": step, "final_loss": last_loss,
                "losses": [float(v) for v in losses], "step_seconds": step_seconds,
                "wall_seconds": wall}
