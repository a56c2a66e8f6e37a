"""Dataset manifest (.lst) generation.

A copy of :mod:`ccnet_tpu.data.lists` (standard library only), which
cannot be imported without jax.

The reference ships manifest files (``dataset/list/cityscapes/*.lst``,
``dataset/list/voc/*``; consumed at ``dataset/datasets.py:129``) whose
recipes are otherwise unreproducible — notably the coarse-data ``train+``
(train ∪ train_extra, 22973 lines) and ``train++`` (train ∪ train_extra ∪
val, 23473) mixes. Instead of shipping copies, every manifest is
regenerated deterministically from the standard Cityscapes/VOC directory
layouts; on a real tree the output reproduces the reference lists
line-for-line (each section lexicographically sorted, sections
concatenated train → train_extra → val).

Formats (one sample per line):

* cityscapes train/val/trainval: ``leftImg8bit/<split>/<city>/<stem>_leftImg8bit.png<TAB>gtFine/<split>/<city>/<stem>_gtFine_labelIds.png``
* cityscapes train+/train++: same, with ``gtCoarse`` label paths for the
  ``train_extra`` section
* cityscapes test: image path only
* voc: bare image ids (``2007_000032``)
"""

from __future__ import annotations

import glob
import os
import os.path as osp
from typing import Dict, List, Optional

__all__ = ["generate_cityscapes_lists", "generate_voc_lists"]


def _scan_split(root: str, split: str) -> List[str]:
    """Sorted relative image paths under leftImg8bit/<split> (posix seps)."""
    pattern = osp.join(root, "leftImg8bit", split, "*", "*_leftImg8bit.png")
    rels = [osp.relpath(p, root).replace(os.sep, "/") for p in glob.glob(pattern)]
    return sorted(rels)


def _with_labels(images: List[str], gt: str) -> List[str]:
    """`img<TAB>label` lines for a list of relative image paths."""
    lines = []
    for img in images:
        lbl = img.replace("leftImg8bit/", f"{gt}/", 1)
        lbl = lbl.replace("_leftImg8bit.png", f"_{gt}_labelIds.png")
        lines.append(f"{img}\t{lbl}")
    return lines


def _write(path: str, lines: List[str]) -> int:
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return len(lines)


def generate_cityscapes_lists(root: str, out_dir: str) -> Dict[str, int]:
    """Emit train/val/test/trainval[.lst] (+ train+/train++ when gtCoarse
    train_extra exists) into ``out_dir``. Returns {filename: line count}.

    On the official dataset the counts are 2975/500/1525/3475 and, with the
    coarse pack installed, 22973/23473.
    """
    os.makedirs(out_dir, exist_ok=True)
    train = _scan_split(root, "train")
    val = _scan_split(root, "val")
    test = _scan_split(root, "test")
    extra = _scan_split(root, "train_extra")
    if not (train or val or test):
        raise FileNotFoundError(f"no Cityscapes layout under {root}")

    counts = {}
    if train:
        counts["train.lst"] = _write(osp.join(out_dir, "train.lst"),
                                     _with_labels(train, "gtFine"))
    if val:
        counts["val.lst"] = _write(osp.join(out_dir, "val.lst"),
                                   _with_labels(val, "gtFine"))
    if train and val:
        counts["trainval.lst"] = _write(osp.join(out_dir, "trainval.lst"),
                                        _with_labels(train + val, "gtFine"))
    if test:
        counts["test.lst"] = _write(osp.join(out_dir, "test.lst"), test)
    if extra:
        plus = _with_labels(train, "gtFine") + _with_labels(extra, "gtCoarse")
        counts["train+.lst"] = _write(osp.join(out_dir, "train+.lst"), plus)
        counts["train++.lst"] = _write(osp.join(out_dir, "train++.lst"),
                                       plus + _with_labels(val, "gtFine"))
    return counts


def generate_voc_lists(root: str, out_dir: str,
                       val_list: Optional[str] = None) -> Dict[str, int]:
    """Emit VOC ``train_aug.txt``/``val.txt`` id lists into ``out_dir``.

    Ids come from the augmented label directory (``SegmentationClassAug``,
    the VOC+SBD union — 12031 labels on the official data); val ids from
    ``ImageSets/Segmentation/val.txt`` (1449), train_aug = the rest (10582).
    """
    os.makedirs(out_dir, exist_ok=True)
    labels = glob.glob(osp.join(root, "SegmentationClassAug", "*.png"))
    ids = sorted(osp.splitext(osp.basename(p))[0] for p in labels)
    if not ids:
        raise FileNotFoundError(f"no SegmentationClassAug labels under {root}")
    val_list = val_list or osp.join(root, "ImageSets", "Segmentation", "val.txt")
    val_ids = sorted(l.strip() for l in open(val_list) if l.strip())
    val_set = set(val_ids)
    counts = {
        "val.txt": _write(osp.join(out_dir, "val.txt"), val_ids),
        "train_aug.txt": _write(osp.join(out_dir, "train_aug.txt"),
                                [i for i in ids if i not in val_set]),
    }
    return counts
