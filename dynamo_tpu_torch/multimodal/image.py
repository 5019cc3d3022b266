"""Image decode, PNG encode and CLIP preprocessing with the standard library
and numpy.

The reference decodes, resizes and re-encodes through Pillow, which the GPU
machine does not have. This module is the same function without it:

- ``decode_image``: PNG, JPEG (jpeg.py) and GIF (gif.py, frame 0) by their
  signature, each as Pillow's ``Image.open(...).convert("RGB")`` gives it:
  the pixels, and the ``transparency`` and ``icc_profile`` Pillow keeps in
  ``info``. An animated PNG decodes as its default image, which is Pillow's
  frame 0 unless its first frame control names a smaller region (refused);
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
- ``encode_png``: the bytes of Pillow 12's ``save(format="PNG")`` of an RGB
  image: IHDR, iCCP, tRNS, IDAT and IEND; each row's filter chosen as
  Pillow's encoder chooses it (the least sum of the bytes' distances from
  zero over None, Up, Sub and Paeth in that order, a later one only when
  strictly less); deflate at level 6, memLevel 9, ``Z_FILTERED``; IDAT
  chunks of 65,536 bytes (4 bytes per column past 16,384 columns);
- ``preprocess_image``: the shortest edge resized to the tower's size, the
  center crop and the CLIP mean/std, as the reference's.

Other formats (WebP, BMP, TIFF, ...) raise ValueError naming the ROADMAP
item that would port them.
"""

from __future__ import annotations

import re
import struct
import zlib

import numpy as np

from dynamo_tpu_torch.multimodal.formats import (
    ITEM_OTHER_FORMATS,
    ITEM_WEBP_APNG_MPO,
    MAX_IMAGE_PIXELS,
    check_size,
    undecodable,
)
from dynamo_tpu_torch.multimodal.gif import GifReader
from dynamo_tpu_torch.multimodal.jpeg import decode_jpeg

__all__ = [
    "CLIP_MEAN", "CLIP_STD", "MAX_IMAGE_PIXELS", "decode_image", "decode_png",
    "encode_png", "frame_count", "preprocess_image", "resize_bicubic",
]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit channels
# Pillow's cap on a decompressed iCCP profile (PngImagePlugin.MAX_TEXT_CHUNK)
_MAX_ICC = 1024 * 1024
# Pillow's encoder buffer: each write is one IDAT chunk
_IDAT_BYTES = 65536

# (channels, allowed bit depths) per PNG colour type
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
# rows per wavefront band (``_unfilter_diagonals``): bounds its skewed
# arrays to ~(rows + width) x rows
_BAND_ROWS = 1024
# Adam7: (x start, y start, x step, y step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


# signatures of formats Pillow opens that this port does not decode, each
# with the ROADMAP item that would port it
_OTHER_FORMATS = (
    (lambda d: d[:4] == b"RIFF" and d[8:12] == b"WEBP", "WebP", ITEM_WEBP_APNG_MPO),
    (lambda d: d[:2] == b"BM", "BMP", ITEM_OTHER_FORMATS),
    (lambda d: d[:4] in (b"II*\x00", b"MM\x00*"), "TIFF", ITEM_OTHER_FORMATS),
    (lambda d: d[:4] in (b"\x00\x00\x01\x00", b"\x00\x00\x02\x00"), "ICO/CUR",
     ITEM_OTHER_FORMATS),
    (lambda d: d[:4] == b"8BPS", "PSD", ITEM_OTHER_FORMATS),
    (lambda d: d[:4] == b"qoif", "QOI", ITEM_OTHER_FORMATS),
    (lambda d: d[4:8] == b"ftyp", "AVIF/HEIF", ITEM_OTHER_FORMATS),
    (lambda d: d[:12] == b"\x00\x00\x00\x0cjP  \r\n\x87\n" or d[:4] == b"\xff\x4f\xff\x51",
     "JPEG 2000", ITEM_OTHER_FORMATS),
    (lambda d: d[:4] == b"DDS ", "DDS", ITEM_OTHER_FORMATS),
    (lambda d: len(d) > 2 and d[:1] == b"P" and d[1:2] in b"123456f" and d[2:3].isspace(),
     "PPM/PGM/PBM", ITEM_OTHER_FORMATS),
)


def _sniff(data: bytes) -> str:
    """"PNG", "JPEG" or "GIF" by the signature; raises ValueError naming
    the ROADMAP item for another format Pillow opens, and Pillow's
    "cannot identify image file" for anything else."""
    if data[: len(PNG_SIGNATURE)] == PNG_SIGNATURE:
        return "PNG"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    for match, name, item in _OTHER_FORMATS:
        if match(data):
            raise ValueError(f"{name} images are not decoded by this port (PNG, JPEG and "
                             f"GIF are; {name} is {item})")
    raise undecodable("cannot identify image file (PNG, JPEG and GIF are decoded; "
                      f"other formats are {ITEM_WEBP_APNG_MPO} and {ITEM_OTHER_FORMATS})")


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
    if _sniff(data) != "PNG":
        raise undecodable("not a PNG file")
    return _read_png(data)[0]


def _png_info(mode: str, trns: bytes | None, palette: np.ndarray | None,
              icc: bytes | None, has_icc: bool) -> dict:
    """What Pillow's ``convert("RGB")`` of the opened PNG keeps in
    ``info``: ``icc_profile`` as read, and ``transparency`` as the plugin
    reads tRNS and the conversion maps it (a palette index to its colour;
    a grey sample, unscaled, to (t, t, t); an alpha table dropped; mode 1
    and I;16 keep the bare int, which Pillow's PNG writer refuses)."""
    info: dict = {}
    if has_icc:
        info["icc_profile"] = icc
    t = None
    if trns is not None:
        if mode == "P":
            if re.fullmatch(b"\xff*\x00\xff*", trns):
                full = np.zeros((256, 3), np.uint8)
                full[: len(palette)] = palette[:256]
                t = tuple(int(v) for v in full[trns.index(b"\x00")])
        elif len(trns) >= 2 and mode in ("1", "L", "I;16"):
            t = struct.unpack(">H", trns[:2])[0]
            if mode == "1":
                t = 255 if t else 0
            elif mode == "L":
                t = (t, t, t)
        elif len(trns) >= 6 and mode == "RGB":
            t = struct.unpack(">HHH", trns[:6])
    if t is not None:
        info["transparency"] = t
    return info


def _read_png(data: bytes, pixels: bool = True) -> tuple[np.ndarray | None, dict, int]:
    """(pixels, info, Pillow's ``n_frames``) of a PNG: an animated PNG's
    default image, refused where Pillow's frame 0 is not that image.
    ``pixels=False`` stops after the chunk walk: (None, {}, n_frames)."""
    pos = len(PNG_SIGNATURE)
    header = None
    palette = None
    trns = icc = None
    has_icc = False
    actl = None  # frames the acTL chunk declares
    fctl = None  # the frame control before the image data
    idat: list[bytes] = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc = data[pos + 8 + length: pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise undecodable("truncated PNG chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(ctype + body):
            raise undecodable(f"bad CRC in PNG chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[: len(body) // 3 * 3].reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        elif idat:
            continue  # Pillow reads the chunks below only before the image data
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"iCCP":
            icc, has_icc = _read_iccp(body), True
        elif ctype == b"acTL":
            if len(body) < 8:
                raise undecodable("APNG contains truncated acTL chunk")
            n = struct.unpack(">I", body[:4])[0]
            # a second acTL, or a frame count of 0, leaves a still image
            actl = None if actl is not None or not 0 < n <= 0x80000000 else n
        elif ctype == b"fcTL":
            if len(body) < 26:
                raise undecodable("APNG contains truncated fcTL chunk")
            seq, fw, fh, fx, fy = struct.unpack(">IIIII", body[:20])
            if seq != 0:
                raise undecodable("APNG contains frame sequence errors")
            fctl = (fx, fy, fx + fw, fy + fh)
    if header is None or not idat:
        raise undecodable("PNG without IHDR or IDAT")
    if fctl is not None and fctl != (0, 0, header[0], header[1]):
        raise ValueError("an animated PNG whose first frame is a region of the image is not "
                         f"decoded by this port ({ITEM_WEBP_APNG_MPO})")
    n_frames = 1 if actl is None else actl + (fctl is None)
    if not pixels:
        return None, {}, n_frames
    width, height, depth, ctype, _comp, _filt, interlace = header
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise undecodable(f"PNG colour type {ctype} at bit depth {depth}")
    if width == 0 or height == 0:
        raise undecodable("empty PNG")
    check_size(width, height)  # before anything is inflated
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
        raise undecodable(str(e)) from e
    if len(raw) < need:
        raise undecodable("truncated PNG image data")
    px = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy, pw, ph in passes:
        n = ph * (stride_of(pw) + 1)
        rows = _unfilter(raw[off: off + n], ph, stride_of(pw), bpp)
        px[y0::dy, x0::dx] = _samples(rows, ph, pw, channels, depth)
        off += n
    # Pillow's mode: grey is 1 at 1 bit and I;16 at 16
    mode = {0: {1: "1", 16: "I;16"}.get(depth, "L"), 2: "RGB", 3: "P", 4: "LA",
            6: "RGBA"}[ctype]
    info = _png_info(mode, trns, palette, icc, has_icc)
    return _to_rgb(px, ctype, depth, palette), info, n_frames


def _read_iccp(body: bytes) -> bytes | None:
    """An iCCP chunk's profile as Pillow reads it: None when it does not
    inflate; refused past Pillow's 1 MiB cap or with another compression."""
    i = body.find(b"\0")
    if i < 0 or i + 1 >= len(body) or body[i + 1] != 0:
        raise undecodable("unknown compression method in iCCP chunk")
    d = zlib.decompressobj()
    try:
        icc = d.decompress(body[i + 2:], _MAX_ICC)
    except zlib.error:
        return None
    if d.unconsumed_tail:
        raise undecodable("Decompressed data too large for PngImagePlugin.MAX_TEXT_CHUNK")
    return icc


def _to_rgb(px: np.ndarray, ctype: int, depth: int,
            palette: np.ndarray | None) -> np.ndarray:
    """Samples -> RGB uint8 as Pillow's mode mapping and ``convert("RGB")``
    give them."""
    if ctype == 3:
        if palette is None:
            raise undecodable("palette PNG without PLTE")
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


# ------------------------------------------------------------- any format


def decode_image(data: bytes) -> tuple[np.ndarray, dict]:
    """Image bytes -> (uint8 [H, W, 3], info): what Pillow's
    ``Image.open(...).convert("RGB")`` gives for a PNG, a JPEG or a GIF's
    frame 0, with the ``transparency`` and ``icc_profile`` its ``info``
    carries. Raises ValueError on other or undecodable bytes."""
    try:
        fmt = _sniff(data)
        if fmt == "PNG":
            rgb, info, _ = _read_png(data)
            return rgb, info
        if fmt == "JPEG":
            return decode_jpeg(data)
        _, rgb, t = next(GifReader(data).frames([0]))
        return rgb, ({} if t is None else {"transparency": t})
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 - a malformed file of any kind
        raise undecodable(str(e)) from e


def frame_count(data: bytes) -> int:
    """Pillow's ``n_frames``: a GIF's frames, an animated PNG's, and 1 for
    any other image this module decodes (nothing is inflated)."""
    fmt = _sniff(data)
    if fmt == "GIF":
        return GifReader(data).n_frames
    return _read_png(data, pixels=False)[2] if fmt == "PNG" else 1


def encode_png(rgb: np.ndarray, transparency=None, icc_profile: bytes | None = None) -> bytes:
    """uint8 [H, W, 3] -> the bytes of Pillow 12's ``save(format="PNG")``
    of that RGB image, whose ``info`` holds ``transparency`` (an RGB tuple
    of 16-bit values, written as tRNS) and ``icc_profile`` (written as
    iCCP). Raises ValueError where Pillow's writer raises."""
    h, w, _ = rgb.shape
    if transparency is not None and not (isinstance(transparency, tuple)
                                         and len(transparency) == 3):
        raise ValueError(f"cannot write transparency {transparency!r} for an RGB PNG")

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    out = [PNG_SIGNATURE, chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))]
    if icc_profile:
        out.append(chunk(b"iCCP", b"ICC Profile\0\0" + zlib.compress(icc_profile)))
    if transparency is not None:
        out.append(chunk(b"tRNS", struct.pack(">HHH", *transparency)))
    z = zlib.compressobj(6, zlib.DEFLATED, 15, 9, zlib.Z_FILTERED)
    idat = z.compress(_filter_rows(rgb)) + z.flush()
    step = max(_IDAT_BYTES, 4 * w)
    out += [chunk(b"IDAT", idat[i: i + step]) for i in range(0, len(idat), step)]
    out.append(chunk(b"IEND", b""))
    return b"".join(out)


def _filter_rows(rgb: np.ndarray) -> bytes:
    """The filtered scanlines Pillow's encoder writes for an RGB image:
    per row, of None, Up, Sub and Paeth (Average only when optimizing,
    which ``save`` does not), the first whose sum of the bytes' distances
    from zero is least, tested in that order, each only while the best sum
    is above zero and taken only when strictly less."""
    h, w, _ = rgb.shape
    cur = rgb.reshape(h, w * 3).astype(np.int16)
    up = np.concatenate([np.zeros((1, w * 3), np.int16), cur[:-1]])
    left = np.concatenate([np.zeros((h, 3), np.int16), cur[:, :-3]], axis=1)
    upleft = np.concatenate([np.zeros((h, 3), np.int16), up[:, :-3]], axis=1)
    pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    cands = ((0, cur & 0xFF), (2, (cur - up) & 0xFF), (1, (cur - left) & 0xFF),
             (4, (cur - paeth) & 0xFF))
    sums = [np.where(v < 128, v, 256 - v).sum(axis=1) for _, v in cands]
    best, best_sum = np.zeros(h, np.int64), sums[0]
    for k in (1, 2, 3):
        take = (best_sum > 0) & (sums[k] < best_sum)
        best, best_sum = np.where(take, k, best), np.where(take, sums[k], best_sum)
    out = np.empty((h, w * 3 + 1), np.uint8)
    for k, (ftype, v) in enumerate(cands):
        rows = best == k
        out[rows, 0] = ftype
        out[rows, 1:] = v[rows]
    return out.tobytes()


def preprocess_image(data: bytes, image_size: int) -> np.ndarray:
    """Decode + CLIP-preprocess one image -> [3, S, S] f32: the shortest edge
    resized to S (bicubic), the center crop, then the CLIP mean/std, as the
    reference's ``preprocess_image``. PNG, JPEG and GIF (frame 0); raises
    ValueError on other or undecodable bytes."""
    img, _ = decode_image(data)
    h, w = img.shape[:2]
    short = min(w, h)
    w, h = round(w * image_size / short), round(h * image_size / short)
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = resize_bicubic(img, w, h, (left, top, left + image_size, top + image_size))
    arr = img.astype(np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)
