"""Training CLI — the flag surface of :mod:`ccnet_tpu.cli.train`, plus ``--device``.

    python -m ccnet_tpu_torch.cli.train --synthetic --ohem 1 --num-steps 4

The default run is the reference recipe: CCNet-R101, R=2, 19 classes, bf16
compute over f32 master weights, batch 8 of 769² crops, poly-LR SGD with
momentum 0.9 and weight decay 1e-4 (``--ohem 1`` for the OHEM+DSN
criterion). ``--model pspnet``, ``--model deeplabv3`` and ``--model danet``
train the PSP, ASPP and dual-attention heads on the same trunk
(``--recurrence`` does not apply to them). On a
CUDA device the criss-cross attention and the upsample+NLL loss, forward
and backward, go through the hand-written kernels. ``--device`` defaults
to ``cuda`` and raises without CUDA; ``--fp32 1`` computes in f32 with TF32
off. ``--synthetic`` trains on generated 1024×2048 images with the
on-device augmentation.

Over N cards, one process per card under torchrun (NCCL when every rank
has a card of its own, gloo when ranks share one or run on the CPU)::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m ccnet_tpu_torch.cli.train --synthetic --ohem 1

``--batch-size`` is the global batch and must divide over the ranks (else
``SystemExit``); each rank loads its strided share, and a step equals the
one-process step on the global batch (:mod:`ccnet_tpu_torch.parallel`).
Rank 0 writes the checkpoints and the ``.pth``.

``--dataset voc`` reads ``JPEGImages``/``SegmentationClassAug`` with an id
list (``--data-list``) and augments on the host (:func:`voc_dataset`:
``CachedDataset`` → ``AugmentingDataset`` with the VOC mean and scales,
numpy resizes of cv2's semantics), as the JAX CLI does; pass
``--num-classes 21``. ``main(argv, dataset=...)`` trains on a raw dataset
given in memory in place of the files. ``--augment-backend native`` augments
on the host with the C++/OpenMP library (:mod:`ccnet_tpu_torch.native`,
built with ``g++`` at first use; it raises if that fails). ``--remat``
recomputes layer 3-4 blocks in the backward, ``--tensorboard 1`` writes
scalars under ``snapshot-dir/tb``, ``--profile-steps a,b`` a
``torch.profiler`` chrome trace of steps [a, b) under
``snapshot-dir/profile``. ``--num-workers`` threads decode the samples, and
``--cache-decoded`` keeps the decoded raw samples in host memory
(``CachedDataset``, before the augmentation), as in the JAX CLI; batches
reach the card through ``device_prefetch``.
"""

from __future__ import annotations

import argparse

from ccnet_tpu_torch.cli.common import note_unused_cards, str2bool
from ccnet_tpu_torch.data import (
    AugmentingDataset,
    CachedDataset,
    CityscapesDataset,
    DataLoader,
    SyntheticDataset,
    U8CropDataset,
    VOCDataset,
)
from ccnet_tpu_torch.data.voc import VOC_MEAN, VOC_SCALE_MIN, VOC_SCALE_STEPS
from ccnet_tpu_torch.models import MODELS
from ccnet_tpu_torch.parallel import maybe_initialize_distributed, rank_device, world
from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer
from ccnet_tpu_torch.utils import get_logger


def get_parser():
    p = argparse.ArgumentParser(description="ccnet_tpu_torch training")
    p.add_argument("--dataset", type=str, default="cityscapes", choices=["cityscapes", "voc"])
    p.add_argument("--data-dir", type=str, default="cityscapes")
    p.add_argument("--data-list", type=str, default=None,
                   help=".lst file (image label per line); default: discover layout")
    p.add_argument("--model", type=str, default="ccnet", choices=list(MODELS))
    p.add_argument("--recurrence", type=int, default=2)
    p.add_argument("--depth", type=int, default=101, choices=[50, 101, 152])
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--input-size", type=str, default="769,769")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--learning-rate", type=float, default=1e-2)
    p.add_argument("--momentum", type=float, default=0.9)
    p.add_argument("--weight-decay", type=float, default=1e-4,
                   help="published table recipe (README); run_local.sh used 5e-4")
    p.add_argument("--power", type=float, default=0.9)
    p.add_argument("--num-steps", type=int, default=60000)
    p.add_argument("--start-iters", type=int, default=0)
    p.add_argument("--ohem", type=str2bool, default=False)
    p.add_argument("--ohem-thres", type=float, default=0.7)
    p.add_argument("--ohem-keep", type=int, default=100000)
    p.add_argument("--ignore-label", type=int, default=255)
    p.add_argument("--save-pred-every", type=int, default=10000)
    p.add_argument("--snapshot-dir", type=str, default="snapshots")
    p.add_argument("--restore-from", type=str, default=None,
                   help=".pth weights for init (ImageNet or CCNet)")
    p.add_argument("--not-restore-last", action="store_true",
                   help="skip classifier layers when restoring (fine-tune to a "
                        "different class count, reference train.py:80-81)")
    p.add_argument("--random-scale", type=str2bool, default=True)
    p.add_argument("--random-mirror", type=str2bool, default=True)
    p.add_argument("--resume", type=str2bool, default=False,
                   help="resume full train state from snapshot-dir")
    p.add_argument("--random-seed", type=int, default=304)
    p.add_argument("--num-workers", type=int, default=8, help="sample decode threads")
    p.add_argument("--fp32", type=str2bool, default=False,
                   help="f32 compute with TF32 off (default: bf16)")
    p.add_argument("--remat", type=str, default="none",
                   choices=["none", "blocks", "conv12", "convs"],
                   help="activation remat: none, blocks (recompute layer 3-4 blocks), "
                        "conv12/convs (keep those conv outputs, recompute the rest)")
    p.add_argument("--export-pth", type=str2bool, default=True)
    p.add_argument("--augment-backend", type=str, default="host_u8",
                   choices=["device", "native", "host_u8", "precropped"],
                   help="host_u8: host augmentation to uint8 crops (engine auto: the "
                        "C++/OpenMP library when it builds, else cv2), widened on the "
                        "device; device: the torch gather sampler on raw images; native: "
                        "the C++/OpenMP host kernel, f32 crops; precropped: the loader "
                        "yields final crops")
    p.add_argument("--tensorboard", type=str2bool, default=False)
    p.add_argument("--profile-steps", type=str, default=None,
                   help="start,stop step range for a torch.profiler trace")
    p.add_argument("--cache-decoded", type=str2bool, default=True,
                   help="keep decoded raw samples in host RAM (CCNET_TPU_CACHE_GB budget)")
    p.add_argument("--synthetic", action="store_true", help="synthetic data smoke run")
    p.add_argument("--synthetic-size", type=str, default="1024,2048")
    p.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    return p


def voc_dataset(raw, crop_hw, ignore_label: int = 255, scale: bool = True,
                mirror: bool = True, seed: int = 304, cache_decoded: bool = True):
    """The VOC training set of the JAX CLI's wiring: the raw samples (cached
    in RAM with ``cache_decoded``) augmented on the host to ``crop_hw`` crops
    with the VOC mean and scales 0.5–1.6."""
    if cache_decoded:
        raw = CachedDataset(raw)  # raw samples, not augmented crops
    return AugmentingDataset(raw, crop_hw=crop_hw, mean=VOC_MEAN, ignore_label=ignore_label,
                             scale=scale, mirror=mirror, scale_min=VOC_SCALE_MIN,
                             scale_steps=VOC_SCALE_STEPS, seed=seed)


def main(argv=None, dataset=None):
    """Train; ``dataset``: raw ``(image, label, name)`` samples to use in place
    of the files under ``--data-dir`` (VOC: f32/int32, Cityscapes: uint8)."""
    args = get_parser().parse_args(argv)
    logger = get_logger("ccnet_tpu_torch.cli.train")
    maybe_initialize_distributed(logger, device=args.device)
    device = rank_device(args.device)
    ranks = world()[1]
    if args.batch_size % ranks:
        raise SystemExit(f"--batch-size {args.batch_size} must divide over {ranks} processes")
    note_unused_cards(logger, device, "ccnet_tpu_torch.cli.train")
    h, w = (int(x) for x in args.input_size.split(","))
    cfg = TrainConfig(
        model=args.model, num_classes=args.num_classes, recurrence=args.recurrence,
        depth=args.depth, input_size=(h, w), batch_size=args.batch_size,
        learning_rate=args.learning_rate, momentum=args.momentum,
        weight_decay=args.weight_decay, power=args.power, num_steps=args.num_steps,
        ohem=args.ohem, ohem_thres=args.ohem_thres, ohem_keep=args.ohem_keep,
        ignore_label=args.ignore_label, save_every=args.save_pred_every,
        snapshot_dir=args.snapshot_dir, restore_from=args.restore_from,
        restore_last=not args.not_restore_last, random_scale=args.random_scale,
        random_mirror=args.random_mirror, resume=args.resume, start_step=args.start_iters,
        seed=args.random_seed, bf16=not args.fp32,
        remat={"none": False, "blocks": True}.get(args.remat, args.remat),
        export_pth=args.export_pth, augment_backend=args.augment_backend,
        tensorboard=args.tensorboard,
        profile_steps=(tuple(int(x) for x in args.profile_steps.split(","))
                       if args.profile_steps else None),
        device=str(device),
    )
    if args.synthetic:
        sh, sw = (int(x) for x in args.synthetic_size.split(","))
        dataset = SyntheticDataset(n=max(args.batch_size * 4, 16), hw=(sh, sw),
                                   num_classes=args.num_classes)
        if cfg.augment_backend == "host_u8":
            cfg.augment_backend = "device"  # synthetic yields f32 full images
    elif args.dataset == "voc":
        # variable-size images: host augmentation, the crops arrive made
        raw = dataset if dataset is not None else VOCDataset(args.data_dir, args.data_list)
        dataset = voc_dataset(raw, (h, w), ignore_label=args.ignore_label,
                              scale=args.random_scale, mirror=args.random_mirror,
                              seed=args.random_seed, cache_decoded=args.cache_decoded)
        cfg.augment_backend = "precropped"
        cfg.mean = VOC_MEAN
    else:
        if dataset is None:
            dataset = CityscapesDataset(args.data_dir, args.data_list, split="train",
                                        raw_dtype="uint8")
        if args.cache_decoded:
            dataset = CachedDataset(dataset)  # raw samples, before the augmentation
        if cfg.augment_backend == "host_u8":
            dataset = U8CropDataset(
                dataset, crop_hw=(h, w), mean=tuple(cfg.mean), ignore_label=args.ignore_label,
                scale=args.random_scale, mirror=args.random_mirror, scale_min=cfg.scale_min,
                scale_steps=cfg.scale_steps, seed=args.random_seed)
    # --batch-size is the global batch: each rank loads its 1/ranks share
    loader = DataLoader(dataset, args.batch_size // ranks, shuffle=True, seed=args.random_seed,
                        num_workers=args.num_workers)
    trainer = Trainer(cfg)
    result = trainer.run(loader)
    logger.info(f"training done: final step {result['final_step']}, "
                f"loss {result['final_loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
