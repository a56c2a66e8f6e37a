"""Evaluation CLI — val mIoU with sliding-window / multi-scale / flip.

Counterpart of :mod:`ccnet_tpu.cli.evaluate`, with the same flags plus
``--device`` (default ``cuda``; asking for CUDA where there is none raises).
The default run is CCNet-R101, R=2, bf16, 769² sliding windows; on a CUDA
device the criss-cross attention goes through the hand-written kernels.
``--model pspnet``, ``--model deeplabv3`` and ``--model danet`` score those
heads' ``.pth``.

    python -m ccnet_tpu_torch.cli.evaluate --synthetic --restore-from ccnet.pth

``--dataset voc`` scores VOC val (``--data-list`` of ids): 21 classes when
19 is given, batch 1 (the images vary in size), each image padded with the
VOC mean to a multiple of ``--bucket`` (default 128), the VOC colormap and
class names. ``--restore-dir`` loads the latest full-state snapshot
(``step_*.pt``) that ``cli.train`` writes, in place of a ``.pth``.
``main(argv, dataset=...)`` scores raw ``(image, label, name)`` samples given
in memory in place of the files under ``--data-dir``.

Over N cards, one process per card under torchrun::

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m ccnet_tpu_torch.cli.evaluate --restore-from ccnet.pth

``--data-parallel 1`` (the default) shards the images over the ranks; the
confusion matrices are summed once at the end, every rank returns the
global result, rank 0 writes ``result.txt``. ``--data-parallel 0`` asks for
one process and exits under torchrun (unless ``--space`` takes every rank).
A single process that sees several cards uses one and logs the torchrun
line. ``--whole 1 --space N`` splits each image's height over N ranks
(:mod:`ccnet_tpu_torch.parallel.spatial`; N must divide the ranks, and it
exits without ``--whole``), each rank scoring its own rows::

    python -m torch.distributed.run --standalone --nproc_per_node 2 \
        -m ccnet_tpu_torch.cli.evaluate --whole 1 --space 2 --restore-from ccnet.pth
"""

from __future__ import annotations

import argparse

import torch

from ccnet_tpu_torch.cli.common import (
    check_data_parallel,
    note_unused_cards,
    resolve_space,
    str2bool,
)
from ccnet_tpu_torch.data import (
    CITYSCAPES_CLASS_NAMES,
    CITYSCAPES_MEAN_BGR,
    CityscapesDataset,
    DataLoader,
    SyntheticDataset,
    VOC_CLASS_NAMES,
    VOC_MEAN,
    VOCDataset,
)
from ccnet_tpu_torch.data.palette import voc_colormap
from ccnet_tpu_torch.evaluation import Evaluator
from ccnet_tpu_torch.models import MODELS, build_model
from ccnet_tpu_torch.parallel import maybe_initialize_distributed, rank_device
from ccnet_tpu_torch.train import create_train_state
from ccnet_tpu_torch.utils import get_logger, load_pth, restore_checkpoint


def get_parser():
    p = argparse.ArgumentParser(description="ccnet_tpu_torch evaluation")
    p.add_argument("--data-dir", type=str, default="cityscapes")
    p.add_argument("--data-list", type=str, default=None)
    p.add_argument("--dataset", type=str, default="cityscapes",
                   choices=["cityscapes", "voc"])
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--bucket", type=int, default=None,
                   help="pad variable-size inputs up to multiples of this (default 128 "
                        "for voc)")
    p.add_argument("--model", type=str, default="ccnet",
                   choices=list(MODELS))
    p.add_argument("--recurrence", type=int, default=2)
    p.add_argument("--depth", type=int, default=101, choices=[50, 101, 152])
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--input-size", type=str, default="769,769")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--restore-from", type=str, default=None, help=".pth checkpoint")
    p.add_argument("--restore-dir", type=str, default=None,
                   help="full-state snapshot dir (step_*.pt of cli.train)")
    p.add_argument("--whole", type=str2bool, default=False)
    p.add_argument("--flip", type=str2bool, default=False)
    p.add_argument("--scales", type=str, default="1.0",
                   help="comma list, e.g. 0.75,1.0,1.25")
    p.add_argument("--output-dir", type=str, default="outputs")
    p.add_argument("--save-preds", type=str2bool, default=True)
    p.add_argument("--fp32", type=str2bool, default=False,
                   help="f32 compute with TF32 off (default: bf16)")
    p.add_argument("--num-workers", type=int, default=4, help="sample decode threads")
    p.add_argument("--data-parallel", type=str2bool, default=True,
                   help="under torchrun, shard the images over the ranks (no-op in one "
                        "process)")
    p.add_argument("--space", type=int, default=1,
                   help="under torchrun, split each image's height over this many ranks "
                        "(--whole only; must divide the ranks)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", type=str, default="1024,2048")
    p.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    return p


def main(argv=None, dataset=None):
    """Score; ``dataset``: raw ``(image, label, name)`` samples to use in
    place of ``--synthetic`` or the files under ``--data-dir``."""
    args = get_parser().parse_args(argv)
    logger = get_logger("ccnet_tpu_torch.cli.evaluate")
    maybe_initialize_distributed(logger, device=args.device)
    space, data, groups = resolve_space(args, logger)
    device = rank_device(args.device)
    check_data_parallel(args.data_parallel, groups)
    note_unused_cards(logger, device, "ccnet_tpu_torch.cli.evaluate")
    h, w = (int(x) for x in args.input_size.split(","))
    if args.fp32:
        # strict numerics: full-f32 matmuls and convolutions, no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    is_voc = args.dataset == "voc"
    if is_voc and args.num_classes == 19:
        args.num_classes = 21  # VOC: 20 classes + background
    if is_voc and args.batch_size != 1:
        # VOC val images vary in size and cannot be stacked into one batch
        logger.warning("--dataset voc evaluates variable-size images; "
                       f"forcing --batch-size {args.batch_size} -> 1")
        args.batch_size = 1

    model = build_model(args.model, num_classes=args.num_classes,
                        recurrence=args.recurrence, depth=args.depth,
                        dtype=torch.float32 if args.fp32 else torch.bfloat16,
                        impl="auto", device=device)
    if args.restore_from:
        load_pth(args.restore_from, model)
        logger.info(f"loaded weights from {args.restore_from}")
    elif args.restore_dir:
        restore_checkpoint(args.restore_dir, create_train_state(model, max_steps=1))
        model.eval()
        logger.info(f"loaded snapshot from {args.restore_dir}")
    else:
        logger.warning("no checkpoint given — evaluating RANDOM weights")

    def apply_fn(x):
        return model(x)["main"]

    if dataset is None and args.synthetic:
        sh, sw = (int(x) for x in args.synthetic_size.split(","))
        dataset = SyntheticDataset(n=2, hw=(sh, sw), num_classes=args.num_classes)
    elif dataset is None and is_voc:
        if not args.data_list:
            raise SystemExit("--data-list (VOC id list) is required for --dataset voc")
        dataset = VOCDataset(args.data_dir, args.data_list, raw_dtype="uint8")
    elif dataset is None:
        dataset = CityscapesDataset(args.data_dir, args.data_list, split=args.split,
                                    raw_dtype="uint8")
    loader = DataLoader(dataset, args.batch_size, shuffle=False, num_workers=args.num_workers,
                        drop_last=False, process_index=data, process_count=groups)

    if is_voc:
        mean = VOC_MEAN
        class_names = VOC_CLASS_NAMES if args.num_classes == 21 else None
        palette = voc_colormap(256).ravel().tolist()
        bucket = args.bucket if args.bucket is not None else 128
    else:
        mean = CITYSCAPES_MEAN_BGR
        class_names = CITYSCAPES_CLASS_NAMES if args.num_classes == 19 else None
        palette, bucket = None, args.bucket
    evaluator = Evaluator(
        apply_fn, num_classes=args.num_classes, tile_hw=(h, w),
        scales=[float(s) for s in args.scales.split(",")],
        flip=args.flip, whole=args.whole, mean=mean, class_names=class_names,
        bucket=bucket, palette=palette, device=device, space=space,
    )
    result = evaluator.run(loader, output_dir=args.output_dir,
                           save_preds=args.save_preds, logger=logger)
    logger.info(f"meanIU: {result['meanIU']:.4f}")
    if "per_class" in result:
        for name, iu in result["per_class"].items():
            logger.info(f"  {name:16s} {iu:.4f}")
    return result


if __name__ == "__main__":
    main()
