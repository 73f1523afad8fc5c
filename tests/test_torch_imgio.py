"""The port's image codecs (utils/imgio.py) and colour helpers
(utils/color.py) against the JAX package's and the libraries it reads
images with, on seeded images, bit for bit:
  - rgb_to_srgb_scalar, rgb_to_srgb, byte_to_float and float_to_byte equal
    the JAX package's numpy results;
  - the port's save_png, decoded by PIL, equals the JAX package's
    save_png (PIL's encoder) decoded by PIL, for linear and non-linear
    input with NaN, infinities and out-of-range values;
  - load_png_rgba equals PIL's Image.open(...).convert("RGBA") on gray,
    gray + alpha, RGB, RGBA and palette PNGs written by PIL (with and
    without a tRNS chunk) and on PNGs written here with each row filter
    (0-4, and all five mixed);
  - load_hdr_rgba equals cv2.imread(..., IMREAD_UNCHANGED) (BGR reversed)
    on flat and run-length .hdr files written by cv2.
"""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from julia_raytracer_tpu.utils import color as jcolor
from julia_raytracer_tpu.utils.imgio import save_png as jax_save_png
from julia_raytracer_tpu_torch.utils import color, imgio

CHANNELS = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}
COLOUR_TYPE = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6, "P": 3}


def _floats(g, shape):
    x = g.uniform(-0.5, 1.5, shape).astype(np.float32)
    flat = x.reshape(-1)
    flat[:12] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0, 0.0031308,
                 0.04045, 1e-30, 255.0 / 256.0, 0.5, 2.0]
    return x


def test_color_helpers_match_jax():
    g = np.random.default_rng(0)
    x = _floats(g, (64, 3))
    x = x[np.isfinite(x).all(axis=1)]
    rgba = np.concatenate([x, g.uniform(0, 1, (len(x), 1)).astype(np.float32)], 1)
    for got, want in (
            (color.rgb_to_srgb_scalar(x), jcolor.rgb_to_srgb_scalar(x)),
            (color.rgb_to_srgb(rgba), jcolor.rgb_to_srgb(rgba)),
            (color.float_to_byte(rgba), jcolor.float_to_byte(rgba))):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    b = g.integers(0, 256, (5, 7, 4), dtype=np.uint8)
    np.testing.assert_array_equal(color.byte_to_float(b), jcolor.byte_to_float(b))


@pytest.mark.parametrize("linear", [True, False])
def test_save_png_matches_jax(tmp_path, linear):
    img = _floats(np.random.default_rng(1), (19, 23, 4))
    imgio.save_png(str(tmp_path / "port.png"), img, linear=linear)
    jax_save_png(str(tmp_path / "jax.png"), img, linear=linear)
    got = np.asarray(Image.open(tmp_path / "port.png"))
    want = np.asarray(Image.open(tmp_path / "jax.png"))
    assert got.shape == (19, 23, 4) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(imgio.load_png_rgba(str(tmp_path / "port.png")), want)


def _pil_image(g, mode):
    """A smooth-plus-noise image (so PIL's encoder picks varied filters)."""
    yy, xx = np.mgrid[:37, :53]
    base = ((xx * 3 + yy * 5) % 256).astype(np.uint8)
    if mode == "P":
        return Image.fromarray(base, "L").convert("RGB").quantize(40)
    noise = g.integers(0, 24, (37, 53, CHANNELS[mode]), dtype=np.uint8)
    arr = (base[..., None] + noise).astype(np.uint8)
    return Image.fromarray(arr[..., 0] if mode == "L" else arr, mode)


@pytest.mark.parametrize("transparency", [False, True])
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
def test_png_decoder_matches_pil(tmp_path, mode, transparency):
    g = np.random.default_rng(2)
    im = _pil_image(g, mode)
    kw = {}
    if transparency and mode == "P":
        kw["transparency"] = bytes(range(0, 200, 7))
    elif transparency and mode in ("L", "RGB"):
        px = im.getpixel((4, 3))
        kw["transparency"] = px
    path = str(tmp_path / "pil.png")
    im.save(path, optimize=transparency, **kw)
    with open(path, "rb") as f:
        assert f.read()[25] == COLOUR_TYPE[mode]  # IHDR colour type
    want = np.asarray(Image.open(path).convert("RGBA"))
    np.testing.assert_array_equal(imgio.load_png_rgba(path), want)
    if transparency and mode != "LA" and mode != "RGBA":
        assert (want[..., 3] < 255).any()


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(pix, filters):
    """PNG bytes of uint8 pix [h, w, ch] (ch 1-4 -> colour type 0, 4, 2,
    6), row r filtered with filters[r] (the encoder's forward filters)."""
    h, w, ch = pix.shape
    x = pix.astype(np.int32)
    left = np.zeros_like(x)
    left[:, 1:] = x[:, :-1]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    ul = np.zeros_like(x)
    ul[1:, 1:] = x[:-1, :-1]
    preds = [np.zeros_like(x), left, up, (left + up) >> 1, _paeth(left, up, ul)]
    rows = np.zeros((h, w * ch + 1), np.uint8)
    rows[:, 0] = filters
    for r in range(h):
        rows[r, 1:] = ((x[r] - preds[filters[r]][r]) & 0xFF).reshape(-1)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("filt", [0, 1, 2, 3, 4, "mixed"])
@pytest.mark.parametrize("channels", [1, 2, 3, 4])
def test_png_decoder_each_filter(tmp_path, channels, filt):
    g = np.random.default_rng(3 + channels)
    h, w = 11, 17
    pix = g.integers(0, 256, (h, w, channels), dtype=np.uint8)
    pix[3:6] = 250  # runs that wrap around 255 under the sub/avg filters
    filters = (np.full(h, filt) if filt != "mixed"
               else g.integers(0, 5, h)).astype(np.uint8)
    path = tmp_path / "f.png"
    path.write_bytes(_filtered_png(pix, filters))
    want = np.asarray(Image.open(path).convert("RGBA"))
    got = imgio.load_png_rgba(str(path))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[..., :channels if channels > 2 else 1],
                                  pix[..., :channels if channels > 2 else 1])


@pytest.mark.parametrize("rle", [True, False])
@pytest.mark.parametrize("size", [(9, 13), (4, 5), (3, 200)])
def test_hdr_reader_matches_cv2(tmp_path, rle, size):
    g = np.random.default_rng(4)
    img = (g.uniform(0.0, 3.0, size + (3,)) ** 4).astype(np.float32)
    img[0, 0] = 0.0
    img[0, 1] = 1e-30
    img[1, :] = 0.25  # a run
    img[-1, -1] = [6e4, 1.0, 1e-3]
    params = [] if rle else [cv2.IMWRITE_HDR_COMPRESSION,
                             cv2.IMWRITE_HDR_COMPRESSION_NONE]
    path = str(tmp_path / "t.hdr")
    assert cv2.imwrite(path, img, params)
    want = cv2.imread(path, cv2.IMREAD_UNCHANGED)[..., ::-1]
    got = imgio.load_hdr_rgba(path)
    assert got.dtype == np.float32 and got.shape == size + (4,)
    np.testing.assert_array_equal(got[..., :3], want)
    np.testing.assert_array_equal(got[..., 3], 1.0)
