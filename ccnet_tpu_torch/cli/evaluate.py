"""Evaluation CLI — val mIoU with sliding-window / multi-scale / flip.

Counterpart of :mod:`ccnet_tpu.cli.evaluate`, with the same flags plus
``--device`` (default ``cuda``; asking for CUDA where there is none raises).
The default run is CCNet-R101, R=2, bf16, 769² sliding windows; on a CUDA
device the criss-cross attention goes through the hand-written kernels.
``--model pspnet`` and ``--model deeplabv3`` score those heads' ``.pth``.

    python -m ccnet_tpu_torch.cli.evaluate --synthetic --restore-from ccnet.pth

Not ported yet (they raise): ``--dataset voc``, ``--restore-dir`` (native
snapshots), ``--space`` > 1 and ``--data-parallel`` over more than one
device.
"""

from __future__ import annotations

import argparse

import torch

from ccnet_tpu_torch.cli.common import str2bool
from ccnet_tpu_torch.data import (
    CITYSCAPES_CLASS_NAMES,
    CITYSCAPES_MEAN_BGR,
    CityscapesDataset,
    DataLoader,
    SyntheticDataset,
)
from ccnet_tpu_torch.evaluation import Evaluator
from ccnet_tpu_torch.models import build_model
from ccnet_tpu_torch.utils import get_logger, load_pth, resolve_device


def get_parser():
    p = argparse.ArgumentParser(description="ccnet_tpu_torch evaluation")
    p.add_argument("--data-dir", type=str, default="cityscapes")
    p.add_argument("--data-list", type=str, default=None)
    p.add_argument("--dataset", type=str, default="cityscapes",
                   choices=["cityscapes", "voc"])
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--bucket", type=int, default=None,
                   help="pad variable-size inputs up to multiples of this")
    p.add_argument("--model", type=str, default="ccnet",
                   choices=["ccnet", "pspnet", "deeplabv3"])
    p.add_argument("--recurrence", type=int, default=2)
    p.add_argument("--depth", type=int, default=101, choices=[50, 101, 152])
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--input-size", type=str, default="769,769")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--restore-from", type=str, default=None, help=".pth checkpoint")
    p.add_argument("--restore-dir", type=str, default=None,
                   help="native snapshot dir (not ported yet)")
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
                   help="no-op on one device; multi-GPU is not ported yet")
    p.add_argument("--space", type=int, default=1,
                   help="height sharding of --whole inference (not ported yet)")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic-size", type=str, default="1024,2048")
    p.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    return p


def main(argv=None):
    args = get_parser().parse_args(argv)
    logger = get_logger("ccnet_tpu_torch.cli.evaluate")
    if args.dataset == "voc":
        raise NotImplementedError("--dataset voc is not ported yet")
    if args.restore_dir:
        raise NotImplementedError("--restore-dir (native snapshots) is not ported yet")
    if args.space > 1:
        raise NotImplementedError("--space (height-sharded whole-image inference) "
                                  "is not ported yet")
    device = resolve_device(args.device)
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        raise NotImplementedError("--data-parallel over more than one GPU is not ported yet; "
                                  "pass --data-parallel 0 or expose one device")
    h, w = (int(x) for x in args.input_size.split(","))
    if args.fp32:
        # strict numerics: full-f32 matmuls and convolutions, no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    model = build_model(args.model, num_classes=args.num_classes,
                        recurrence=args.recurrence, depth=args.depth,
                        dtype=torch.float32 if args.fp32 else torch.bfloat16,
                        impl="auto", device=device)
    if args.restore_from:
        load_pth(args.restore_from, model)
        logger.info(f"loaded weights from {args.restore_from}")
    else:
        logger.warning("no checkpoint given — evaluating RANDOM weights")

    def apply_fn(x):
        return model(x)["main"]

    if args.synthetic:
        sh, sw = (int(x) for x in args.synthetic_size.split(","))
        dataset = SyntheticDataset(n=2, hw=(sh, sw), num_classes=args.num_classes)
    else:
        dataset = CityscapesDataset(args.data_dir, args.data_list, split=args.split,
                                    raw_dtype="uint8")
    loader = DataLoader(dataset, args.batch_size, shuffle=False, num_workers=args.num_workers,
                        drop_last=False)

    evaluator = Evaluator(
        apply_fn, num_classes=args.num_classes, tile_hw=(h, w),
        scales=[float(s) for s in args.scales.split(",")],
        flip=args.flip, whole=args.whole, mean=CITYSCAPES_MEAN_BGR,
        class_names=CITYSCAPES_CLASS_NAMES if args.num_classes == 19 else None,
        bucket=args.bucket, device=device,
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
