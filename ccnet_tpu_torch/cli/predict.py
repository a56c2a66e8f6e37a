"""Test-set prediction CLI → Cityscapes-server submission PNGs.

Counterpart of :mod:`ccnet_tpu.cli.predict` (the reference's ``test.py``,
``:151-204``), with the same flags plus ``--device`` (default ``cuda``;
asking for CUDA where there is none raises): sliding-window (or
``--whole 1``) prediction through the port's ``Evaluator``, optionally
multi-scale (``--scales``) and flipped (``--flip 1``), the argmax mapped
back from trainIds to labelIds and written as 8-bit greyscale PNGs, or with
``--labelid 0`` the trainIds as palette PNGs. Both are written with the
standard library (no PIL). Inputs are mean-subtracted as in training.

    python -m ccnet_tpu_torch.cli.predict --data-dir cityscapes --restore-from ccnet.pth

``main(argv, dataset=...)`` predicts a set of raw ``(image, label, name)``
samples given in memory in place of the ``--split`` images under
``--data-dir``. Under torchrun (one process per card) ``--data-parallel 1``,
the default, shards the images over the ranks, each writing its own PNGs;
``--data-parallel 0`` exits there. ``--whole 1 --space N`` splits each
image's height over N ranks (as ``cli.evaluate`` does); the group's first
rank writes the PNGs.
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import time

import torch

from ccnet_tpu_torch.cli.common import (
    check_data_parallel,
    note_unused_cards,
    resolve_space,
    str2bool,
)
from ccnet_tpu_torch.data import CityscapesDataset, DataLoader, trainid_to_labelid
from ccnet_tpu_torch.data.palette import cityscapes_palette, save_grey_png, save_indexed_png
from ccnet_tpu_torch.evaluation import Evaluator
from ccnet_tpu_torch.models import MODELS, build_model
from ccnet_tpu_torch.parallel import maybe_initialize_distributed, rank_device
from ccnet_tpu_torch.utils import get_logger, load_pth


def get_parser():
    p = argparse.ArgumentParser(description="ccnet_tpu_torch test-set prediction")
    p.add_argument("--data-dir", type=str, default="cityscapes")
    p.add_argument("--data-list", type=str, default=None)
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--model", type=str, default="ccnet",
                   choices=list(MODELS))
    p.add_argument("--recurrence", type=int, default=2)
    p.add_argument("--depth", type=int, default=101)
    p.add_argument("--num-classes", type=int, default=19)
    p.add_argument("--input-size", type=str, default="769,769")
    p.add_argument("--restore-from", type=str, required=True)
    p.add_argument("--whole", type=str2bool, default=False)
    p.add_argument("--flip", type=str2bool, default=False)
    p.add_argument("--scales", type=str, default="1.0",
                   help="comma list, e.g. 0.75,1.0,1.25 (multi-scale average)")
    p.add_argument("--output-dir", type=str, default="outputs")
    p.add_argument("--labelid", type=str2bool, default=True,
                   help="write labelId PNGs (server format); False = trainId palette PNGs")
    p.add_argument("--fp32", type=str2bool, default=False,
                   help="f32 compute with TF32 off (default: bf16)")
    p.add_argument("--data-parallel", type=str2bool, default=True,
                   help="under torchrun, shard the images over the ranks (no-op in one "
                        "process)")
    p.add_argument("--space", type=int, default=1,
                   help="under torchrun, split each image's height over this many ranks "
                        "(--whole only; must divide the ranks)")
    p.add_argument("--device", type=str, default="cuda", help="cuda, cuda:N or cpu")
    return p


def main(argv=None, dataset=None) -> dict:
    """Write one PNG per image; returns ``{"paths", "seconds"}``: the PNGs in
    order (over N ranks, this rank's; none on a space group's other ranks)
    and each image's host seconds from its prediction to its PNG."""
    args = get_parser().parse_args(argv)
    logger = get_logger("ccnet_tpu_torch.cli.predict")
    maybe_initialize_distributed(logger, device=args.device)
    space, data, groups = resolve_space(args, logger)
    device = rank_device(args.device)
    check_data_parallel(args.data_parallel, groups)
    note_unused_cards(logger, device, "ccnet_tpu_torch.cli.predict")
    h, w = (int(x) for x in args.input_size.split(","))
    if args.fp32:
        # strict numerics: full-f32 matmuls and convolutions, no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    model = build_model(args.model, num_classes=args.num_classes, recurrence=args.recurrence,
                        depth=args.depth, dtype=torch.float32 if args.fp32 else torch.bfloat16,
                        impl="auto", device=device)
    load_pth(args.restore_from, model)

    def apply_fn(x):
        return model(x)["main"]

    evaluator = Evaluator(apply_fn, num_classes=args.num_classes, tile_hw=(h, w),
                          scales=[float(s) for s in args.scales.split(",")],
                          flip=args.flip, whole=args.whole, device=device, space=space)
    if dataset is None:
        dataset = CityscapesDataset(args.data_dir, args.data_list, split=args.split,
                                    raw_dtype="uint8")
    loader = DataLoader(dataset, 1, shuffle=False, num_workers=4, drop_last=False,
                        process_index=data, process_count=groups)

    os.makedirs(args.output_dir, exist_ok=True)
    palette = cityscapes_palette()
    paths, seconds = [], []
    for images, _, names in loader:
        t0 = time.perf_counter()
        preds = evaluator.predict_batch(images)
        if space is not None and space.index:
            preds = preds[:0]  # the space group's first rank writes the PNGs
        for pred, name in zip(preds, names):
            path = osp.join(args.output_dir, f"{name}.png")
            if args.labelid:
                save_grey_png(path, trainid_to_labelid(pred))
            else:
                save_indexed_png(path, pred, palette)
            paths.append(path)
        seconds.append(time.perf_counter() - t0)
        logger.info(f"predicted {len(paths)} images")
    logger.info(f"wrote {len(paths)} PNGs to {args.output_dir}")
    return {"paths": paths, "seconds": seconds}


if __name__ == "__main__":
    main()
