"""Regenerate dataset manifest (.lst) files from a standard layout, with
the PyTorch port's generators. The port of ``scripts/make_lists.py``.

    python scripts/make_lists_torch.py cityscapes /data/cityscapes lists/cityscapes
    python scripts/make_lists_torch.py voc /data/VOCdevkit/VOC2012 lists/voc

On the official Cityscapes tree this reproduces the reference's shipped
train/val/test/trainval (2975/500/1525/3475) lists — and, with the coarse
pack installed, the train+ (22973) / train++ (23473) recipes. It writes the
same files as the JAX package's script and imports no JAX, so it also runs
where only the port is installed.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ccnet_tpu_torch.data import generate_cityscapes_lists, generate_voc_lists  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("dataset", choices=["cityscapes", "voc"])
    p.add_argument("root", help="dataset root directory")
    p.add_argument("out_dir", help="directory to write list files into")
    args = p.parse_args(argv)
    gen = generate_cityscapes_lists if args.dataset == "cityscapes" else generate_voc_lists
    for name, count in sorted(gen(args.root, args.out_dir).items()):
        print(f"{name}: {count}")


if __name__ == "__main__":
    main()
