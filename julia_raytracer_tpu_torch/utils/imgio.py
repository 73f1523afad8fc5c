"""Host-side image IO: PNG (LDR, sRGB) and Radiance HDR (linear), the port
of julia_raytracer_tpu/utils/imgio.py.

The codecs are written here in numpy and the standard library's `zlib`
and `struct`, with no image library: the JAX package reads PNG through
PIL and HDR through OpenCV, and the machine with the card has neither.
They give what those libraries give, bit for bit:
  - `load_png_rgba` decodes non-interlaced 8-bit PNGs of every colour
    type (gray, gray + alpha, RGB, RGBA, palette; a tRNS chunk's
    transparency included) and all five row filters, as PIL's
    `Image.open(path).convert("RGBA")` does;
  - `load_hdr_rgba` reads Radiance RGBE files (`-Y h +X w`; flat and
    new-style run-length scanlines) as `cv2.imread(path,
    IMREAD_UNCHANGED)` does: a pixel (r, g, b, e) with e > 0 is
    (r, g, b) * 2^(e - 136), without Ward's +0.5;
  - `save_png` writes an 8-bit RGBA PNG with filter type 0.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from julia_raytracer_tpu_torch.utils.color import float_to_byte, rgb_to_srgb

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples a pixel


def _png_chunks(data: bytes, path: str):
    """(type, payload) of each chunk, CRCs checked."""
    if data[:8] != _PNG_SIGNATURE:
        raise IOError(f"{path}: not a PNG file")
    pos = 8
    while pos + 12 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if zlib.crc32(kind + payload) != crc:
            raise IOError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, payload
        if kind == b"IEND":
            return
        pos += 12 + length
    raise IOError(f"{path}: truncated PNG (no IEND chunk)")


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of raw [h, w, bpp] (uint8 filtered bytes;
    one filter type a row). Each pixel depends on its left, upper and
    upper-left neighbours, so the pixels are reconstructed one
    anti-diagonal (row + column = d) at a time, all filter types at once."""
    if filters.max(initial=0) > 4:
        raise IOError(f"unknown PNG filter type {int(filters.max())}")
    if not filters.any():
        return raw
    h, w, _ = raw.shape
    out = np.zeros((h + 1, w + 1, raw.shape[2]), np.int32)  # zero row/col 0
    raw = raw.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(d, h - 1) + 1)
        c = d - r
        a, b, ul = out[r + 1, c], out[r, c + 1], out[r, c]
        ft = filters[r][:, None]
        pred = np.where(ft == 1, a, np.where(ft == 2, b, np.where(
            ft == 3, (a + b) >> 1, np.where(ft == 4, _paeth(a, b, ul), 0))))
        out[r + 1, c + 1] = (raw[r, c] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


def load_png_rgba(path: str) -> np.ndarray:
    """PNG -> uint8 [H, W, 4] (RGBA): non-interlaced, 8 bits a sample."""
    with open(path, "rb") as f:
        data = f.read()
    header, palette, trns, idat = None, None, None, []
    for kind, payload in _png_chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload)
        elif kind == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = payload
        elif kind == b"IDAT":
            idat.append(payload)
    if header is None:
        raise IOError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or interlace != 0 or ctype not in _PNG_CHANNELS:
        raise IOError(f"{path}: only non-interlaced 8-bit PNGs are read "
                      f"(bit depth {depth}, colour type {ctype}, interlace "
                      f"{interlace})")
    ch = _PNG_CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows[: h * (w * ch + 1)].reshape(h, w * ch + 1)
    pix = _unfilter(rows[:, 1:].reshape(h, w, ch), rows[:, 0])
    out = np.empty((h, w, 4), np.uint8)
    out[..., 3] = 255
    if ctype == 3:  # palette: missing entries are black; tRNS holds alphas
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[: len(palette), :3] = palette
        if trns is not None:
            pal[: len(trns), 3] = np.frombuffer(trns, np.uint8)
        return pal[pix[..., 0]]
    if ctype in (0, 4):
        out[..., :3] = pix[..., :1]
        if ctype == 4:
            out[..., 3] = pix[..., 1]
    else:
        out[..., :ch] = pix
    if trns is not None and ctype in (0, 2):  # one colour is transparent
        key = np.array(struct.unpack(f">{len(trns) // 2}H", trns))
        out[(pix.astype(np.int32) == key).all(axis=-1), 3] = 0
    return out


def _rgbe_header(data: bytes, path: str) -> tuple[int, int, int]:
    """(height, width, offset of the pixels) of a Radiance file: header
    lines up to the first blank one, then the size line."""
    end = data.find(b"\n\n")
    if end < 0:
        raise IOError(f"{path}: truncated Radiance header")
    if b"FORMAT=32-bit_rle_rgbe" not in data[:end].split(b"\n"):
        raise IOError(f"{path}: no FORMAT=32-bit_rle_rgbe line")
    pos = end + 2
    end = data.find(b"\n", pos)
    size = data[pos:end].split()
    if len(size) != 4 or size[0] != b"-Y" or size[2] != b"+X":
        raise IOError(f"{path}: only -Y h +X w images are read")
    return int(size[1]), int(size[3]), end + 1


def _rgbe_pixels(data: bytes, pos: int, h: int, w: int, path: str) -> np.ndarray:
    """uint8 [h * w, 4] (r, g, b, e). New-style run-length scanlines start
    with (2, 2, w >> 8, w & 255); from the first scanline that does not,
    the rest of the file is flat pixels (OpenCV's reader does the same)."""
    def flat(start, count):
        px = np.frombuffer(data, np.uint8, count=4 * count, offset=start)
        return px.reshape(count, 4)

    if w < 8 or w > 0x7FFF:
        return flat(pos, h * w)
    lines = []
    for y in range(h):
        if (data[pos] != 2 or data[pos + 1] != 2 or data[pos + 2] & 0x80):
            lines.append(flat(pos, (h - y) * w))
            break
        if (data[pos + 2] << 8 | data[pos + 3]) != w:
            raise IOError(f"{path}: wrong scanline width")
        pos += 4
        line = np.empty((4, w), np.uint8)
        for c in range(4):
            x = 0
            while x < w:
                count = data[pos]
                if count > 128:  # a run of one value
                    count -= 128
                    if count > w - x:
                        raise IOError(f"{path}: bad scanline data")
                    line[c, x:x + count] = data[pos + 1]
                    pos += 2
                else:
                    if count == 0 or count > w - x:
                        raise IOError(f"{path}: bad scanline data")
                    line[c, x:x + count] = np.frombuffer(
                        data, np.uint8, count=count, offset=pos + 1)
                    pos += 1 + count
                x += count
        lines.append(line.T)
    return np.concatenate(lines)


def load_hdr_rgba(path: str) -> np.ndarray:
    """Radiance .hdr -> float32 [H, W, 4] (linear, alpha=1)."""
    with open(path, "rb") as f:
        data = f.read()
    h, w, pos = _rgbe_header(data, path)
    px = _rgbe_pixels(data, pos, h, w, path)
    e = px[:, 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0).astype(np.float32)
    rgb = px[:, :3].astype(np.float32) * scale[:, None]
    alpha = np.ones((h * w, 1), np.float32)
    return np.concatenate([rgb, alpha], axis=-1).reshape(h, w, 4)


def _png_chunk(kind: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + kind + payload
            + struct.pack(">I", zlib.crc32(kind + payload)))


def encode_png(rgba: np.ndarray) -> bytes:
    """uint8 [H, W, 4] -> the bytes of a non-interlaced 8-bit RGBA PNG,
    every row with filter type 0."""
    h, w, _ = rgba.shape
    rows = np.zeros((h, 4 * w + 1), np.uint8)
    rows[:, 1:] = np.ascontiguousarray(rgba, np.uint8).reshape(h, 4 * w)
    return (_PNG_SIGNATURE
            + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def save_png(path: str, pixels: np.ndarray, linear: bool = True) -> None:
    """Save float [H, W, 4] to PNG. NaN and infinities become 0; linear
    data is sRGB-encoded, clamped to [0, 1] and rounded to bytes; other
    data is trunc(f * 256) clamped to [0, 255]."""
    pix = np.asarray(pixels, dtype=np.float32)
    pix = np.where(np.isfinite(pix), pix, 0.0)
    if linear:
        pix = rgb_to_srgb(pix)
        pix = np.clip(pix, 0.0, 1.0)
        data = np.clip(np.rint(pix * 255.0), 0, 255).astype(np.uint8)
    else:
        data = np.asarray(float_to_byte(pix))
    png = encode_png(data)
    with open(path, "wb") as f:
        f.write(png)
