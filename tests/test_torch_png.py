"""The port's prediction PNG writer (standard library only) vs the JAX
package's PIL writer: PIL reads both back with equal pixels and palettes."""

import numpy as np
import pytest
from PIL import Image

from ccnet_tpu.data.palette import save_indexed_png as jax_save_indexed_png

from ccnet_tpu_torch.data.palette import cityscapes_palette, save_indexed_png


@pytest.mark.parametrize("hw,high", [((1, 1), 19), ((3, 5), 19), ((17, 33), 19),
                                     ((64, 129), 19), ((40, 31), 256)])
def test_png_reads_back_like_the_pil_writer(tmp_path, hw, high):
    pred = np.random.RandomState(sum(hw)).randint(0, high, hw).astype(np.uint8)
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    save_indexed_png(ours, pred)
    jax_save_indexed_png(theirs, pred)
    a, b = Image.open(ours), Image.open(theirs)
    assert a.mode == b.mode == "P" and a.size == b.size == (hw[1], hw[0])
    np.testing.assert_array_equal(np.asarray(a), pred)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert a.getpalette() == b.getpalette()
    assert a.getpalette()[:57] == cityscapes_palette()[:57]


def test_png_custom_palette_and_int_input(tmp_path):
    """A short custom palette and int64 predictions (cast to uint8)."""
    pred = np.arange(12, dtype=np.int64).reshape(3, 4) % 4
    palette = [255, 0, 0, 0, 255, 0, 0, 0, 255, 9, 9, 9]
    ours, theirs = str(tmp_path / "ours.png"), str(tmp_path / "theirs.png")
    save_indexed_png(ours, pred, palette)
    jax_save_indexed_png(theirs, pred, palette)
    a, b = Image.open(ours), Image.open(theirs)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert a.getpalette()[:12] == b.getpalette()[:12] == palette
    with pytest.raises(ValueError):
        save_indexed_png(ours, pred[None])
