"""Training CLI — the flag surface of :mod:`ccnet_tpu.cli.train`, plus ``--device``.

    python -m ccnet_tpu_torch.cli.train --synthetic --ohem 1 --num-steps 4

The default run is the reference recipe: CCNet-R101, R=2, 19 classes, bf16
compute over f32 master weights, batch 8 of 769² crops, poly-LR SGD with
momentum 0.9 and weight decay 1e-4 (``--ohem 1`` for the OHEM+DSN
criterion). ``--model pspnet`` and ``--model deeplabv3`` train the PSP and
ASPP heads on the same trunk (``--recurrence`` does not apply to them). On a
CUDA device the criss-cross attention and the upsample+NLL loss, forward
and backward, go through the hand-written kernels. ``--device`` defaults
to ``cuda`` and raises without CUDA; ``--fp32 1`` computes in f32 with TF32
off. ``--batch-size`` is the batch
of the one process. ``--synthetic`` trains on generated 1024×2048 images
with the on-device augmentation.

Not ported yet (they raise): ``--dataset voc``, ``--augment-backend
native``, ``--remat`` other than ``none``, ``--tensorboard`` and
``--profile-steps``. ``--num-workers`` threads decode the samples, and
``--cache-decoded`` keeps the decoded Cityscapes samples in host memory
(``CachedDataset``, raw samples before the augmentation), as in the JAX CLI;
batches reach the card through ``device_prefetch``.
"""

from __future__ import annotations

import argparse

import torch

from ccnet_tpu_torch.cli.common import str2bool
from ccnet_tpu_torch.data import (
    CachedDataset,
    CityscapesDataset,
    DataLoader,
    SyntheticDataset,
    U8CropDataset,
)
from ccnet_tpu_torch.train.trainer import TrainConfig, Trainer
from ccnet_tpu_torch.utils import get_logger, resolve_device


def get_parser():
    p = argparse.ArgumentParser(description="ccnet_tpu_torch training")
    p.add_argument("--dataset", type=str, default="cityscapes", choices=["cityscapes", "voc"])
    p.add_argument("--data-dir", type=str, default="cityscapes")
    p.add_argument("--data-list", type=str, default=None,
                   help=".lst file (image label per line); default: discover layout")
    p.add_argument("--model", type=str, default="ccnet", choices=["ccnet", "pspnet", "deeplabv3"])
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
                   help="activation remat (only none is ported)")
    p.add_argument("--export-pth", type=str2bool, default=True)
    p.add_argument("--augment-backend", type=str, default="host_u8",
                   choices=["device", "native", "host_u8", "precropped"],
                   help="host_u8: host cv2 augmentation to uint8 crops, widened on "
                        "the device; device: the torch gather sampler on raw images; "
                        "precropped: the loader yields final crops; native: not ported")
    p.add_argument("--tensorboard", type=str2bool, default=False)
    p.add_argument("--profile-steps", type=str, default=None,
                   help="start,stop step range (not ported yet)")
    p.add_argument("--cache-decoded", type=str2bool, default=True,
                   help="keep decoded raw samples in host RAM (CCNET_TPU_CACHE_GB budget)")
    p.add_argument("--synthetic", action="store_true", help="synthetic data smoke run")
    p.add_argument("--synthetic-size", type=str, default="1024,2048")
    p.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    logger = get_logger("ccnet_tpu_torch.cli.train")
    if args.dataset == "voc":
        raise NotImplementedError("--dataset voc is not ported yet")
    if args.augment_backend == "native":
        raise NotImplementedError("--augment-backend native is not ported yet")
    device = resolve_device(args.device)
    if args.fp32:
        # strict numerics: full-f32 matmuls and convolutions, no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
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
    else:
        dataset = CityscapesDataset(args.data_dir, args.data_list, split="train",
                                    raw_dtype="uint8")
        if args.cache_decoded:
            dataset = CachedDataset(dataset)  # raw samples, before the augmentation
        if cfg.augment_backend == "host_u8":
            dataset = U8CropDataset(
                dataset, crop_hw=(h, w), mean=tuple(cfg.mean), ignore_label=args.ignore_label,
                scale=args.random_scale, mirror=args.random_mirror, scale_min=cfg.scale_min,
                scale_steps=cfg.scale_steps, seed=args.random_seed)
    loader = DataLoader(dataset, args.batch_size, shuffle=True, seed=args.random_seed,
                        num_workers=args.num_workers)
    trainer = Trainer(cfg)
    result = trainer.run(loader)
    logger.info(f"training done: final step {result['final_step']}, "
                f"loss {result['final_loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
