"""Image decode and CLIP preprocessing with the standard library and numpy.

The reference decodes and resizes through Pillow, which the GPU machine
does not have. This module is the same function without it:

- ``decode_png``: a PNG decoder (zlib, the five scanline filters, bit
  depths 1, 2, 4, 8 and 16, grey, grey + alpha, RGB, RGBA, palette, tRNS
  and Adam7 interlacing) that returns what Pillow's ``convert("RGB")``
  gives: alpha and tRNS dropped, 16-bit samples cut to their high byte
  (a 16-bit grey image saturates at 255, as Pillow's ``I;16`` to ``RGB``
  conversion does). Rows of the None, Sub and Up filters are undone one
  vector operation per row; an image with Average or Paeth rows is undone
  along anti-diagonals, one vector step per diagonal. Past Pillow's
  decompression-bomb limit an image is refused unread, with Pillow's text,
  and no more than the image's own bytes are ever inflated;
- ``resize_bicubic``: Pillow's ``resize(..., BICUBIC)`` on an RGB image, bit
  for bit: the cubic with a = -0.5, its support widened by the scale when
  reducing, each output's coefficients normalized and then converted to
  fixed point with 22 precision bits, a horizontal pass over the rows the
  vertical pass needs, then the vertical pass, each rounded and clipped to
  uint8;
- ``preprocess_image``: the shortest edge resized to the tower's size, the
  center crop and the CLIP mean/std, as the reference's.

Other formats (JPEG, GIF, WebP, ...) raise ValueError naming the ROADMAP
item that would port them.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = [
    "CLIP_MEAN", "CLIP_STD", "MAX_IMAGE_PIXELS", "UNSUPPORTED_FORMAT_ITEM",
    "decode_png", "preprocess_image", "resize_bicubic",
]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

UNSUPPORTED_FORMAT_ITEM = "ROADMAP Queue A item 12b"
PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit channels
# Pillow's Image.MAX_IMAGE_PIXELS: past twice this, an image is refused
# unread as a decompression bomb
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3

# (channels, allowed bit depths) per PNG colour type
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
# rows per wavefront band (``_unfilter_diagonals``): bounds its skewed
# arrays to ~(rows + width) x rows
_BAND_ROWS = 1024
# Adam7: (x start, y start, x step, y step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _sniff(data: bytes) -> str | None:
    """The name of a known non-PNG image format, or None."""
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:2] == b"BM":
        return "BMP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    return None


def _unfilter(raw: memoryview, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters of ``height`` rows of ``stride`` bytes
    (each led by its filter-type byte) -> uint8 [height, stride]. ``bpp`` is
    the byte distance to the left neighbour (at least 1); ``stride`` is a
    whole number of such pixels."""
    lines = np.frombuffer(raw, np.uint8, count=height * (stride + 1))
    lines = lines.reshape(height, stride + 1)
    ftypes, data = lines[:, 0], lines[:, 1:]
    bad = ftypes[ftypes > 4]
    if bad.size:
        raise ValueError(f"undecodable image bytes: PNG filter type {bad[0]}")
    if (ftypes >= 3).any():
        out = np.empty((height, stride), np.uint8)
        prior = np.zeros(stride, np.uint8)
        for r0 in range(0, height, _BAND_ROWS):
            band = _unfilter_diagonals(ftypes[r0: r0 + _BAND_ROWS],
                                       data[r0: r0 + _BAND_ROWS], prior, bpp)
            out[r0: r0 + len(band)] = band
            prior = band[-1]
        return out
    # None, Sub and Up only: one vector operation per row
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for r in range(height):
        line = data[r]
        if ftypes[r] == 1:  # Sub: a running sum per byte lane, mod 256
            line = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftypes[r] == 2:  # Up
            line = line + prior
        out[r] = line
        prior = out[r]
    return out


def _unfilter_diagonals(ftypes: np.ndarray, data: np.ndarray, prior: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Rows of any filter types, Average and Paeth among them, undone along
    anti-diagonals: pixel (r, x) reads only (r, x-1), (r-1, x) and
    (r-1, x-1), so every pixel with the same r + x is computed in one vector
    step (rows + width steps for the band, each over its byte lanes).
    ``prior`` is the unfiltered row above the band (zeros for the first)."""
    h, stride = data.shape
    n = stride // bpp
    # skewed layout: pixel (r, x) at [r + x + 2, r + 1]; the row above at
    # [x + 1, 0]; every slot left-of-row or above-the-prior stays 0
    rr, xx = np.indices((h, n))
    diag, col = rr + xx + 2, rr + 1
    raw = np.zeros((h + n + 1, h + 1, bpp), np.int16)
    raw[diag, col] = data.reshape(h, n, bpp)
    out = np.zeros_like(raw)
    out[np.arange(n) + 1, 0] = prior.reshape(n, bpp)
    # each row's 0/1 weight of each predictor, at the lanes' width: a type
    # select by arithmetic (np.where costs several times a product here)
    ft = np.concatenate([[0], ftypes])[:, None]
    w_sub, w_up, w_avg, w_pae = (np.broadcast_to(ft == t, (h + 1, bpp)).astype(np.int16)
                                 for t in (1, 2, 3, 4))
    for p in range(2, h + n + 1):
        lo, hi = max(1, p - n), min(h + 1, p)
        a, b, c = out[p - 1, lo:hi], out[p - 1, lo - 1: hi - 1], out[p - 2, lo - 1: hi - 1]
        da, db = a - c, b - c
        pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
        # Paeth: a when pa is least, else b when pb <= pc, else c
        bc = c + (pb <= pc) * db
        paeth = bc + (pa <= np.minimum(pb, pc)) * (a - bc)
        pred = (w_sub[lo:hi] * a + w_up[lo:hi] * b + w_avg[lo:hi] * ((a + b) >> 1)
                + w_pae[lo:hi] * paeth)
        out[p, lo:hi] = (raw[p, lo:hi] + pred) & 0xFF
    return out[diag, col].astype(np.uint8).reshape(h, stride)


def _samples(rows: np.ndarray, height: int, width: int, channels: int,
             depth: int) -> np.ndarray:
    """Unfiltered scanlines uint8 [height, stride] -> [height, width,
    channels] samples (uint8, or uint16 for depth 16; sub-byte samples
    unpacked MSB first)."""
    if depth == 16:
        a = rows.reshape(-1).view(">u2").reshape(height, width * channels)
        return a.astype(np.uint16).reshape(height, width, channels)
    a = rows
    if depth == 8:
        return a.reshape(height, width, channels)
    bits = np.unpackbits(a, axis=1).reshape(height, -1, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    vals = (bits * weights).sum(axis=2, dtype=np.uint8)
    return vals[:, : width * channels].reshape(height, width, channels)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, 3] uint8, the pixels of Pillow's
    ``Image.open(...).convert("RGB")``. Raises ValueError on anything else."""
    if data[: len(PNG_SIGNATURE)] != PNG_SIGNATURE:
        fmt = _sniff(data)
        if fmt is not None:
            raise ValueError(f"{fmt} images are not decoded by this port (PNG only; "
                             f"other formats are {UNSUPPORTED_FORMAT_ITEM})")
        raise ValueError("undecodable image bytes: not a PNG file (PNG only; other "
                         f"formats are {UNSUPPORTED_FORMAT_ITEM})")
    pos = len(PNG_SIGNATURE)
    header = None
    palette = None
    idat: list[bytes] = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc = data[pos + 8 + length: pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("undecodable image bytes: truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + body):
            raise ValueError(f"undecodable image bytes: bad CRC in PNG chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("undecodable image bytes: PNG without IHDR or IDAT")
    width, height, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise ValueError(f"undecodable image bytes: PNG colour type {ctype} at bit "
                         f"depth {depth}")
    if width == 0 or height == 0:
        raise ValueError("undecodable image bytes: empty PNG")
    pixels = width * height
    if pixels > 2 * MAX_IMAGE_PIXELS:
        # Pillow's decompression-bomb guard, before anything is inflated
        raise ValueError(
            f"undecodable image bytes: Image size ({pixels} pixels) exceeds limit of "
            f"{2 * MAX_IMAGE_PIXELS} pixels, could be decompression bomb DOS attack.")
    channels = _COLOR_TYPES[ctype][0]
    bpp = max(1, channels * depth // 8)

    def stride_of(w: int) -> int:
        return (w * channels * depth + 7) // 8

    # the scanlines of each pass: (x0, y0, dx, dy, width, height)
    passes = [(0, 0, 1, 1, width, height)] if interlace == 0 else [
        (x0, y0, dx, dy, (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy)
        for x0, y0, dx, dy in _ADAM7]
    passes = [q for q in passes if q[4] > 0 and q[5] > 0]
    need = sum(ph * (stride_of(pw) + 1) for *_, pw, ph in passes)
    try:
        # at most the bytes the image has: data past them is not inflated
        raw = memoryview(zlib.decompressobj().decompress(b"".join(idat), need))
    except zlib.error as e:
        raise ValueError(f"undecodable image bytes: {e}") from e
    if len(raw) < need:
        raise ValueError("undecodable image bytes: truncated PNG image data")
    px = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy, pw, ph in passes:
        n = ph * (stride_of(pw) + 1)
        rows = _unfilter(raw[off: off + n], ph, stride_of(pw), bpp)
        px[y0::dy, x0::dx] = _samples(rows, ph, pw, channels, depth)
        off += n
    return _to_rgb(px, ctype, depth, palette)


def _to_rgb(px: np.ndarray, ctype: int, depth: int,
            palette: np.ndarray | None) -> np.ndarray:
    """Samples -> RGB uint8 as Pillow's mode mapping and ``convert("RGB")``
    give them."""
    if ctype == 3:
        if palette is None:
            raise ValueError("undecodable image bytes: palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette[:256]
        return full[px[..., 0]]
    if depth == 16:
        # Pillow opens 16-bit grey as I;16 (converted to RGB saturating at
        # 255) and every other 16-bit type from its samples' high bytes
        if ctype == 0:
            px = np.minimum(px, 255).astype(np.uint8)
        else:
            px = (px >> 8).astype(np.uint8)
    elif depth < 8:  # grey: 1-bit to 0/255, 2-bit x 85, 4-bit x 17
        px = (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


# ------------------------------------------------------------------ resize


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic filter (a = -0.5), in its operation order."""
    x = np.abs(x)
    a = -0.5
    inner = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    outer = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def _coeffs(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` + ``normalize_coeffs_8bpc`` for the
    box (0, in_size): per output position its first input index, its tap
    count and its fixed-point taps [out_size, ksize] (int64)."""
    scale = float(np.float32(in_size) - np.float32(0.0)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = 0.0 + (np.arange(out_size, dtype=np.float64) + 0.5) * scale
    ss = 1.0 / filterscale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize, dtype=np.int64)[None, :]
    w = _bicubic(((taps + xmin[:, None]).astype(np.float64) - center[:, None] + 0.5) * ss)
    w = np.where(taps < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size, np.float64)
    for x in range(ksize):  # a running sum, in the C loop's order
        ww = ww + w[:, x]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * (1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + scaled), np.trunc(0.5 + scaled)).astype(np.int64)
    return xmin, xmax, kk


def _resample_axis0(img: np.ndarray, xmin: np.ndarray, kk: np.ndarray) -> np.ndarray:
    """One pass along axis 0 of ``img [n_in, m, 3]`` uint8 -> [n_out, m, 3]
    uint8: each output is the 2^21-offset fixed-point sum of its taps in
    int32 (Pillow's accumulator), shifted down by 22 bits and clipped to
    [0, 255]. Taps past the tap count are 0, and their (clamped) inputs
    add nothing."""
    src = img.astype(np.int32)
    n_in = src.shape[0]
    acc = np.full((kk.shape[0],) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    kk = kk.astype(np.int32)
    for x in range(kk.shape[1]):
        rows = np.minimum(xmin + x, n_in - 1)
        acc += src[rows] * kk[:, x][:, None, None]
    return np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, width: int, height: int,
                   box: tuple[int, int, int, int] | None = None) -> np.ndarray:
    """[H, W, 3] uint8 -> [height, width, 3] uint8, bit for bit Pillow's
    ``Image.resize((width, height), Image.BICUBIC)`` on an RGB image. With
    ``box = (left, top, right, bottom)`` only that window of the output is
    computed (the resize's ``crop(box)``, at the window's cost: each output
    pixel depends only on its own row's and column's taps)."""
    in_h, in_w = img.shape[:2]
    left, top, right, bottom = box or (0, 0, width, height)
    if (in_w, in_h) == (width, height):
        return img[top:bottom, left:right].copy()
    first, last = top, bottom  # the input rows the output window reads
    if height != in_h:
        ymin, ymax, kv = (c[top:bottom] for c in _coeffs(in_h, height))
        first, last = int(ymin.min()), int((ymin + ymax).max())
    img = img[first:last]
    if width != in_w:
        # the horizontal pass over the rows the vertical one reads
        xmin, _xmax, kh = _coeffs(in_w, width)
        img = _resample_axis0(img.transpose(1, 0, 2), xmin[left:right],
                              kh[left:right]).transpose(1, 0, 2)
    else:
        img = img[:, left:right]
    if height != in_h:
        img = _resample_axis0(img, ymin - first, kv)
    return np.ascontiguousarray(img)


def preprocess_image(data: bytes, image_size: int) -> np.ndarray:
    """Decode + CLIP-preprocess one image -> [3, S, S] f32: the shortest edge
    resized to S (bicubic), the center crop, then the CLIP mean/std, as the
    reference's ``preprocess_image``. PNG only; raises ValueError on other
    or undecodable bytes."""
    try:
        img = decode_png(data)
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 - a malformed file of any kind
        raise ValueError(f"undecodable image bytes: {e}") from e
    h, w = img.shape[:2]
    short = min(w, h)
    w, h = round(w * image_size / short), round(h * image_size / short)
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = resize_bicubic(img, w, h, (left, top, left + image_size, top + image_size))
    arr = img.astype(np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)
