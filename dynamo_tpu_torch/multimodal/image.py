"""Image decode, PNG encode and CLIP preprocessing with the standard library
and numpy.

The reference decodes, resizes and re-encodes through Pillow, which the GPU
machine does not have. This module is the same function without it:

- ``decode_image``: PNG, JPEG (jpeg.py; an MPO's first image), GIF (gif.py)
  and WebP (webp.py) by their signature, frame 0 of each as Pillow's
  ``Image.open(...).convert("RGB")`` gives it: the pixels, and the
  ``transparency`` and ``icc_profile`` Pillow keeps in ``info``. An
  animated PNG's frame 0 is its default image, or its first frame's
  region over zeros;
- ``frame_count`` and ``frames``: Pillow's ``n_frames``, and the frames
  ``seek(k)`` reaches, of an animated GIF, WebP or PNG (apng.py) or an MPO
  (mpo.py), decoded forward only as far as the largest index asked for;
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

Other formats (BMP, TIFF, ...) raise ValueError naming the ROADMAP item
that would port them.
"""

from __future__ import annotations

import re
import struct
import zlib
from collections.abc import Iterable, Iterator

import numpy as np

from dynamo_tpu_torch.multimodal.formats import (
    ITEM_OTHER_FORMATS,
    MAX_IMAGE_PIXELS,
    check_size,
    undecodable,
)
from dynamo_tpu_torch.multimodal.gif import GifReader
from dynamo_tpu_torch.multimodal.jpeg import decode_jpeg
from dynamo_tpu_torch.multimodal.mpo import MpoReader, mpo_reader
from dynamo_tpu_torch.multimodal.webp import WebPReader, is_webp

__all__ = [
    "CLIP_MEAN", "CLIP_STD", "DECODED", "MAX_IMAGE_PIXELS", "decode_image", "decode_png",
    "encode_png", "frame_count", "frames", "preprocess_image", "resize_bicubic",
]

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHUNK_TYPE = re.compile(rb"\w{4}")  # PngImagePlugin.is_cid
PRECISION_BITS = 32 - 8 - 2  # Pillow's fixed point for 8-bit channels
# Pillow's cap on a decompressed iCCP profile (PngImagePlugin.MAX_TEXT_CHUNK)
_MAX_ICC = 1024 * 1024
# Pillow's encoder buffer: each write is one IDAT chunk; its decoder reads
# image data in pieces of this size too (ImageFile's decodermaxblock)
_IDAT_BYTES = _READ_BYTES = 65536

# (channels, allowed bit depths) per PNG colour type
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)),
                4: (2, (8, 16)), 6: (4, (8, 16))}
# rows per wavefront band (``_unfilter_diagonals``): bounds its skewed
# arrays to ~(rows + width) x rows
_BAND_ROWS = 1024
# Adam7: (x start, y start, x step, y step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


# the formats this module decodes, as its errors name them
DECODED = "PNG and APNG, JPEG and MPO, GIF, and WebP"
# signatures of formats Pillow opens that this port does not decode, each
# with the ROADMAP item that would port it
_OTHER_FORMATS = (
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
    """"PNG", "JPEG", "GIF" or "WEBP" by the signature; raises ValueError
    naming the ROADMAP item for another format Pillow opens, and Pillow's
    "cannot identify image file" for anything else."""
    if data[: len(PNG_SIGNATURE)] == PNG_SIGNATURE:
        return "PNG"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if is_webp(data):
        return "WEBP"
    for match, name, item in _OTHER_FORMATS:
        if match(data):
            raise ValueError(f"{name} images are not decoded by this port ({DECODED} are; "
                             f"{name} is {item})")
    raise undecodable(f"cannot identify image file ({DECODED} are decoded; other formats "
                      f"are {ITEM_OTHER_FORMATS})")


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


def _png_transparency(mode: str, trns: bytes | None):
    """``tRNS`` as Pillow's ``chunk_tRNS`` stores it in ``info``: a palette
    image's one transparent index (or its alpha table), a grey level (0 or
    255 in mode 1), an RGB tuple of 16-bit values."""
    if trns is None:
        return None
    if mode == "P":
        return trns.index(b"\x00") if re.fullmatch(b"\xff*\x00\xff*", trns) else trns
    if len(trns) >= 2 and mode in ("1", "L", "I;16"):
        t = struct.unpack(">H", trns[:2])[0]
        return (255 if t else 0) if mode == "1" else t
    if len(trns) >= 6 and mode == "RGB":
        return struct.unpack(">HHH", trns[:6])
    return None


def _png_info(mode: str, t, palette: np.ndarray | None, icc: bytes | None,
              has_icc: bool) -> dict:
    """What Pillow's ``convert("RGB")`` of the opened PNG keeps in
    ``info``: ``icc_profile`` as read, and the plugin's ``transparency``
    ``t`` as the conversion maps it (a palette index to its colour; a grey
    level, unscaled, to (t, t, t); an alpha table dropped; mode 1 and I;16
    keep the bare int, which Pillow's PNG writer refuses)."""
    info: dict = {}
    if has_icc:
        info["icc_profile"] = icc
    if mode == "P" and isinstance(t, int):
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette[:256]
        t = tuple(int(v) for v in full[t])
    elif mode == "P":
        t = None
    elif mode == "L" and t is not None:
        t = (t, t, t)
    if t is not None:
        info["transparency"] = t
    return info


class PngHead:
    """What Pillow's open reads of a PNG: the chunks before the first image
    data. ``transparency`` is the ``tRNS`` value as the plugin stores it
    (``info`` holds it as ``convert("RGB")`` maps it), ``first_ctl`` the
    ``fcTL`` before the data (None when the data is a default image or the
    PNG is not animated) and ``data_pos`` the offset of the first data chunk."""

    __slots__ = ("width", "height", "depth", "ctype", "interlace", "palette",
                 "transparency", "info", "actl", "n_frames", "first_ctl", "seq", "data_pos")


class FrameControl:
    """An ``fcTL``: the region (x0, y0, x1, y1), dispose op and blend op."""

    __slots__ = ("bbox", "dispose", "blend")

    def __init__(self, bbox: tuple, dispose: int, blend: int):
        self.bbox, self.dispose, self.blend = bbox, dispose, blend


def read_fctl(body: bytes, seq: int | None, width: int, height: int
              ) -> tuple[FrameControl, int]:
    """Pillow's ``chunk_fcTL``: the sequence number checked against the one
    before (the first must be 0), the region inside the image."""
    if len(body) < 26:
        raise undecodable("APNG contains truncated fcTL chunk")
    s, fw, fh, fx, fy = struct.unpack(">IIIII", body[:20])
    if (seq is None and s != 0) or (seq is not None and seq != s - 1):
        raise undecodable("APNG contains frame sequence errors")
    if fx + fw > width or fy + fh > height:
        raise undecodable("APNG contains invalid frames")
    return FrameControl((fx, fy, fx + fw, fy + fh), body[24], body[25]), s


def read_png_head(data: bytes) -> PngHead:
    """The chunks up to the first ``IDAT`` or ``fdAT``, each checked (length
    and CRC) as Pillow's open checks them."""
    if data[: len(PNG_SIGNATURE)] != PNG_SIGNATURE:
        raise undecodable("not a PNG file")
    hd = PngHead()
    pos = len(PNG_SIGNATURE)
    header = None
    hd.palette = trns = icc = None
    has_icc = False
    hd.actl = None  # frames the acTL chunk declares
    hd.first_ctl, hd.seq = None, None
    while True:
        if pos + 8 > len(data):
            raise undecodable("PNG without IHDR or IDAT")
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        if ctype in (b"IDAT", b"fdAT"):
            hd.data_pos = pos
            if ctype == b"fdAT":
                raise undecodable("APNG frame data before the default image")
            break
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
            hd.palette = np.frombuffer(body, np.uint8)[: len(body) // 3 * 3].reshape(-1, 3)
        elif ctype == b"IEND":
            raise undecodable("PNG without IHDR or IDAT")
        elif ctype == b"tRNS":
            trns = body
        elif ctype == b"iCCP":
            icc, has_icc = _read_iccp(body), True
        elif ctype == b"acTL":
            if len(body) < 8:
                raise undecodable("APNG contains truncated acTL chunk")
            n = struct.unpack(">I", body[:4])[0]
            # a second acTL, or a frame count of 0, leaves a still image
            hd.actl = None if hd.actl is not None or not 0 < n <= 0x80000000 else n
        elif ctype == b"fcTL":
            if header is None:
                raise undecodable("PNG without IHDR or IDAT")
            hd.first_ctl, hd.seq = read_fctl(body, hd.seq, header[0], header[1])
    if header is None:
        raise undecodable("PNG without IHDR or IDAT")
    hd.width, hd.height, hd.depth, hd.ctype, _comp, _filt, hd.interlace = header
    if hd.ctype not in _COLOR_TYPES or hd.depth not in _COLOR_TYPES[hd.ctype][1]:
        raise undecodable(f"PNG colour type {hd.ctype} at bit depth {hd.depth}")
    if hd.width == 0 or hd.height == 0:
        raise undecodable("empty PNG")
    # an IDAT before any fcTL is a default image, outside the animation
    hd.n_frames = 1 if hd.actl is None else hd.actl + (hd.first_ctl is None)
    mode = png_mode(hd.ctype, hd.depth)
    hd.transparency = _png_transparency(mode, trns)
    hd.info = _png_info(mode, hd.transparency, hd.palette, icc, has_icc)
    return hd


def inflate_samples(chunks: Iterable[bytes], width: int, height: int, depth: int,
                    ctype: int, interlace: int) -> tuple[np.ndarray, np.ndarray]:
    """A zlib stream of filtered scanlines, in its data chunks -> (samples
    [height, width, channels] (uint8, or uint16 at depth 16), written [height,
    width] bool), inflated as Pillow's ``ZipDecode`` inflates it: a piece at
    a time (a chunk, in reads of at most 65,536 bytes), one scanline per
    inflate call and only while the piece has input left. So a checksum in
    a later piece is never read, and a scanline the inflater could finish
    from its window alone, after the input ran out, is missing (fewer
    scanlines raise). A stream that ends at a scanline's end ends the image
    there: the pixels not ``written`` keep what the image held."""
    channels = _COLOR_TYPES[ctype][0]
    bpp = max(1, channels * depth // 8)

    def stride_of(w: int) -> int:
        return (w * channels * depth + 7) // 8

    # the scanlines of each pass: (x0, y0, dx, dy, width, height)
    passes = [(0, 0, 1, 1, width, height)] if interlace == 0 else [
        (x0, y0, dx, dy, (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy)
        for x0, y0, dx, dy in _ADAM7]
    passes = [q for q in passes if q[4] > 0 and q[5] > 0]
    lines = [stride_of(pw) + 1 for *_, pw, ph in passes for _ in range(ph)]
    z = zlib.decompressobj()
    got = bytearray()
    done = row = 0  # scanlines done, bytes of the one in progress
    try:
        for chunk in chunks:
            for i in range(0, len(chunk), _READ_BYTES):
                tail = chunk[i: i + _READ_BYTES]
                while tail and done < len(lines):
                    out = z.decompress(tail, lines[done] - row)
                    tail = z.unconsumed_tail
                    got += out
                    row += len(out)
                    if row < lines[done]:
                        break  # the piece is spent: more input first
                    done, row = done + 1, 0
                    if z.eof:  # the stream's end is the image's
                        lines = lines[:done]
                if done == len(lines):
                    break
            if done == len(lines):
                break
    except zlib.error as e:
        raise undecodable(str(e)) from e
    if done < len(lines):
        raise undecodable("truncated PNG image data")
    out = memoryview(bytes(got))
    px = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    written = np.zeros((height, width), bool)
    off = 0
    for x0, y0, dx, dy, pw, ph in passes:
        ph = min(ph, done)  # the scanlines of this pass that came
        done -= ph
        n = ph * (stride_of(pw) + 1)
        rows = _unfilter(out[off: off + n], ph, stride_of(pw), bpp)
        px[y0: y0 + ph * dy: dy, x0::dx] = _samples(rows, ph, pw, channels, depth)
        written[y0: y0 + ph * dy: dy, x0::dx] = True
        off += n
    return px, written


def _read_png(data: bytes, pixels: bool = True) -> tuple[np.ndarray | None, dict, int]:
    """(pixels, info, Pillow's ``n_frames``) of a PNG: an animated PNG's
    frame 0 (its default image, or its first frame's region over zeros).
    ``pixels=False`` stops after the chunk walk: (None, {}, n_frames)."""
    hd = read_png_head(data)
    if not pixels:
        return None, {}, hd.n_frames
    # every IDAT up to IEND. Pillow checks CRCs only in the walk before the
    # first IDAT (read_png_head); from there on it reads each chunk's body,
    # skips its CRC and stops at a chunk type that is not four word bytes
    pos = hd.data_pos
    idat: list[bytes] = []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos: pos + 8])
        if not _CHUNK_TYPE.fullmatch(ctype):
            break
        body = data[pos + 8: pos + 8 + length]
        if len(body) != length:
            raise undecodable("truncated PNG chunk")
        pos += 12 + length
        if ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    check_size(hd.width, hd.height)  # before anything is inflated
    x0, y0, x1, y1 = (hd.first_ctl.bbox if hd.first_ctl is not None
                      else (0, 0, hd.width, hd.height))
    if x1 <= x0 or y1 <= y0:
        raise undecodable("tile cannot extend outside image")
    # the pixels not written keep the new image's zeros
    px = inflate_samples(idat, x1 - x0, y1 - y0, hd.depth, hd.ctype, hd.interlace)[0]
    if (x1 - x0, y1 - y0) != (hd.width, hd.height):
        full = np.zeros((hd.height, hd.width, px.shape[2]), px.dtype)
        full[y0:y1, x0:x1] = px
        px = full
    return _to_rgb(px, hd.ctype, hd.depth, hd.palette), hd.info, hd.n_frames


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


def png_mode(ctype: int, depth: int) -> str:
    """Pillow's mode of a PNG: grey is 1 at 1 bit and I;16 at 16."""
    return {0: {1: "1", 16: "I;16"}.get(depth, "L"), 2: "RGB", 3: "P", 4: "LA",
            6: "RGBA"}[ctype]


def mode_pixels(px: np.ndarray, ctype: int, depth: int) -> np.ndarray:
    """Samples -> the image Pillow holds in the PNG's mode: palette
    indices; grey of 1, 2 and 4 bits scaled to 0..255; 16-bit samples cut
    to their high byte except I;16's (uint16)."""
    if ctype == 3 or (ctype == 0 and depth == 16):
        return px
    if depth == 16:
        return (px >> 8).astype(np.uint8)
    if depth < 8:  # grey: 1-bit to 0/255, 2-bit x 85, 4-bit x 17
        return (px * (255 // ((1 << depth) - 1))).astype(np.uint8)
    return px


def mode_to_rgb(px: np.ndarray, ctype: int, depth: int,
                palette: np.ndarray | None) -> np.ndarray:
    """The image in its mode -> RGB uint8 as ``convert("RGB")`` gives it."""
    if ctype == 3:
        if palette is None:
            raise undecodable("palette PNG without PLTE")
        full = np.zeros((256, 3), np.uint8)
        full[: len(palette)] = palette[:256]
        return full[px[..., 0]]
    if ctype == 0 and depth == 16:  # I;16 to RGB saturates at 255
        px = np.minimum(px, 255).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.array(px[..., :3])  # a copy: an APNG's canvas changes after


def _to_rgb(px: np.ndarray, ctype: int, depth: int,
            palette: np.ndarray | None) -> np.ndarray:
    """Samples -> RGB uint8 as Pillow's mode mapping and ``convert("RGB")``
    give them."""
    return mode_to_rgb(mode_pixels(px, ctype, depth), ctype, depth, palette)


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
    ``Image.open(...).convert("RGB")`` gives for frame 0 of a PNG, JPEG,
    MPO, GIF or WebP, with the ``transparency`` and ``icc_profile`` its
    ``info`` carries (and a WebP's ``loop``, ``background``, ``exif`` and
    ``xmp``). Raises ValueError on other or undecodable bytes."""
    try:
        fmt = _sniff(data)
        if fmt == "PNG":
            rgb, info, _ = _read_png(data)
            return rgb, info
        if fmt == "JPEG":
            return decode_jpeg(data)
        if fmt == "WEBP":
            reader = WebPReader(data)
            return next(reader.frames([0]))[1], dict(reader.info)
        _, rgb, t = next(GifReader(data).frames([0]))
        return rgb, ({} if t is None else {"transparency": t})
    except ValueError:
        raise
    except Exception as e:  # noqa: BLE001 - a malformed file of any kind
        raise undecodable(str(e)) from e


def _animation(data: bytes):
    """(n_frames, the reader of the frames past a still image, or None)."""
    fmt = _sniff(data)
    if fmt == "GIF":
        gif = GifReader(data)
        return gif.n_frames, gif
    if fmt == "WEBP":
        webp = WebPReader(data)
        return webp.n_frames, webp
    if fmt == "JPEG":
        mpo = mpo_reader(data)
        return (1, None) if mpo is None else (mpo.n_frames, mpo)
    n = _read_png(data, pixels=False)[2]
    if n == 1:
        return 1, None
    from dynamo_tpu_torch.multimodal.apng import ApngReader  # it builds on this module

    return n, ApngReader(data)


def frame_count(data: bytes) -> int:
    """Pillow's ``n_frames``: a GIF's, a WebP's or an animated PNG's frames,
    an MPO's images, and 1 for a still image (nothing is decoded)."""
    return _animation(data)[0]


def frames(data: bytes, indices) -> Iterator[tuple[int, np.ndarray, dict]]:
    """``(k, rgb uint8 [H, W, 3], info)`` for each index k in ascending
    order, as Pillow's ``seek(k).convert("RGB")`` gives the frame; ``info``
    holds the ``transparency`` and ``icc_profile`` Pillow's PNG writer
    reads. Frames are decoded forward, as far as the largest index."""
    n, reader = _animation(data)
    want = sorted(set(indices))
    if want and (want[0] < 0 or want[-1] >= n):
        raise undecodable("attempt to seek outside sequence")
    if reader is None:
        if want:
            rgb, info = decode_image(data)
            yield 0, rgb, info
    elif isinstance(reader, GifReader):
        for k, rgb, t in reader.frames(want):
            yield k, rgb, ({} if t is None else {"transparency": t})
    elif isinstance(reader, MpoReader):  # each frame its own info
        yield from reader.frames(want)
    else:  # WebP and animated PNG: one info for every frame
        for k, rgb in reader.frames(want):
            yield k, rgb, reader.info


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
    reference's ``preprocess_image``. Frame 0 of a PNG, JPEG, MPO, GIF or
    WebP; raises ValueError on other or undecodable bytes."""
    img, _ = decode_image(data)
    h, w = img.shape[:2]
    short = min(w, h)
    w, h = round(w * image_size / short), round(h * image_size / short)
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = resize_bicubic(img, w, h, (left, top, left + image_size, top + image_size))
    arr = img.astype(np.float32) / 255.0
    arr = (arr - CLIP_MEAN) / CLIP_STD
    return arr.transpose(2, 0, 1)
