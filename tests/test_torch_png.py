"""The port's PNG codec (glenet_tpu_torch/utils/png.py; the machine with
the card has no Pillow) against Pillow: every colour type and bit depth
KITTI and Pillow write, each of the five row filters, and Pillow's own
adaptive filtering; the samples must be equal."""
import io

import numpy as np
import pytest

Image = pytest.importorskip('PIL.Image')

from glenet_tpu_torch.utils import png  # noqa: E402


def _frame(seed=0, h=37, w=53):
    rng = np.random.RandomState(seed)
    img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
    img[5:20, 10:40] = [10, 200, 30]          # flat runs as well as noise
    depth = (rng.rand(h, w) * 20000).astype(np.uint16)
    depth[:10] = 0
    return img, depth


def _pillow_bytes(im, **kw):
    buf = io.BytesIO()
    im.save(buf, 'PNG', **kw)
    return buf.getvalue()


@pytest.mark.parametrize('mode', ['RGB', 'L', 'RGBA', 'LA'])
@pytest.mark.parametrize('opts', [{}, {'optimize': True},
                                  {'compress_level': 0}])
def test_decode_pillow_8bit(mode, opts):
    img, _ = _frame()
    arr = {'RGB': img, 'L': img[..., 0], 'LA': img[..., :2],
           'RGBA': np.dstack([img, img[..., :1]])}[mode]
    got = png.decode_png(_pillow_bytes(Image.fromarray(arr, mode), **opts))
    np.testing.assert_array_equal(got, arr)


def test_decode_pillow_16bit_depth():
    """KITTI's depth_2 maps: 16-bit grey, metres x 256."""
    _, depth = _frame()
    im = Image.fromarray(depth.astype(np.int32), 'I').convert('I;16')
    got = png.decode_png(_pillow_bytes(im))
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, depth)


@pytest.mark.parametrize('kind', ['palette', '1bit'])
def test_decode_pillow_palette_and_low_depth(kind):
    img, _ = _frame()
    if kind == 'palette':
        im = Image.fromarray(img).convert('P', palette=Image.ADAPTIVE,
                                          colors=16)
        ref = np.asarray(im.convert('RGB'))
        got = png.decode_png(_pillow_bytes(im))
    else:
        im = Image.fromarray((img[..., 0] > 128).astype(np.uint8)
                             * 255).convert('1')
        ref = np.asarray(im.convert('L'))
        got = png.decode_png(_pillow_bytes(im)) * 255
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize('filter_type', [0, 1, 2, 3, 4])
@pytest.mark.parametrize('which', ['rgb', 'grey', 'depth16'])
def test_encode_each_filter(filter_type, which):
    """Every row with one filter type: Pillow reads the port's file, and
    the port reads it back."""
    img, depth = _frame(1)
    arr = {'rgb': img, 'grey': img[..., 1], 'depth16': depth}[which]
    data = png.encode_png(arr, filter_type)
    ref = np.asarray(Image.open(io.BytesIO(data)))
    np.testing.assert_array_equal(ref.astype(np.int64), arr)
    np.testing.assert_array_equal(png.decode_png(data), arr)


def test_kitti_sized_frame_and_header(tmp_path):
    """A 375 x 1242 RGB frame through Pillow's adaptive filters (Paeth
    rows among them), and png_size from the header."""
    rng = np.random.RandomState(2)
    img = (rng.rand(375, 1242, 3) * 255).astype(np.uint8)
    path = tmp_path / 'frame.png'
    Image.fromarray(img).save(path)
    np.testing.assert_array_equal(png.read_png(path), img)
    assert png.png_size(path) == (375, 1242)
