"""The port's manifest generators (``ccnet_tpu_torch.data.lists``) against
the JAX package's: on one fake Cityscapes tree (with ``train_extra`` and
gtCoarse) and one fake VOC tree, both write byte-equal files."""

import os
import os.path as osp

import pytest

from ccnet_tpu.data.lists import generate_cityscapes_lists as jax_cityscapes_lists
from ccnet_tpu.data.lists import generate_voc_lists as jax_voc_lists
from ccnet_tpu_torch.data import generate_cityscapes_lists, generate_voc_lists
from test_lists import _touch, make_fake_cityscapes


def _files(out):
    return {name: open(osp.join(out, name), "rb").read() for name in sorted(os.listdir(out))}


@pytest.mark.parametrize("with_coarse", [True, False])
def test_cityscapes_lists_equal_jax(tmp_path, with_coarse):
    root = str(tmp_path / "cs")
    make_fake_cityscapes(root, with_coarse=with_coarse)
    got = generate_cityscapes_lists(root, str(tmp_path / "port"))
    want = jax_cityscapes_lists(root, str(tmp_path / "jax"))
    assert got == want
    assert ("train+.lst" in got) == with_coarse
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_voc_lists_equal_jax(tmp_path):
    root = str(tmp_path / "voc")
    ids = [f"2007_{i:06d}" for i in (3, 0, 7, 1, 5, 2, 6, 4)]
    for i in ids:
        _touch(osp.join(root, "SegmentationClassAug", f"{i}.png"))
    os.makedirs(osp.join(root, "ImageSets", "Segmentation"))
    with open(osp.join(root, "ImageSets", "Segmentation", "val.txt"), "w") as f:
        f.write("\n".join(ids[5:]) + "\n\n")
    got = generate_voc_lists(root, str(tmp_path / "port"))
    want = jax_voc_lists(root, str(tmp_path / "jax"))
    assert got == want == {"val.txt": 3, "train_aug.txt": 5}
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")


def test_empty_trees_raise_as_jax(tmp_path):
    for fn in (generate_cityscapes_lists, generate_voc_lists):
        with pytest.raises(FileNotFoundError):
            fn(str(tmp_path / "nothing"), str(tmp_path / "out"))
