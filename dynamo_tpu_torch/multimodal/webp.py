"""WebP decode with the standard library and numpy: each frame as Pillow 12's
WebP plugin gives it (libwebp 1.6's demuxer and ``WebPAnimDecoder``, which
Pillow runs for a still image too), and what its ``info`` carries.

- the container, as ``src/demux/demux.c`` validates it: the RIFF size
  (data past it ignored, a file shorter than it refused), simple files
  (one ``VP8 `` or ``VP8L`` chunk) and extended ones (``VP8X`` of 10
  bytes exactly: flags,
  canvas size, ``ICCP``, ``EXIF`` and ``XMP `` kept only when their flag
  is set, ``ANIM`` with the background colour and loop count, ``ANMF``
  frames with their offsets (stored halved), duration, blend and dispose
  bits, an ``ALPH`` chunk before a lossy image). A frame's size is its
  bitstream's; a still image must fill the canvas and a frame must lie
  inside it;
- the canvas of ``src/demux/anim_decode.c``, straight (not premultiplied)
  RGBA: a key frame (the first; a frame without alpha or not blended that
  covers the canvas; a frame after one disposed to background that
  covered the canvas or was itself a key frame) starts from a zero
  canvas, any other from the previous frame's disposed canvas; the frame
  is decoded into its rectangle, then, when blended and not a key frame,
  each pixel whose alpha is not 255 is blended over the previous canvas
  with ``BlendPixelNonPremult`` (the integer ``dst_a * (256 - src_a) >>
  8`` and the ``(1 << 24) / blend_a`` scale; an alpha of 0 keeps the
  pixel below). After a frame disposed to background the blend skips the
  previous frame's rectangle (``FindBlendRangeAtRow``): those pixels keep
  their decoded values. Dispose-to-background zero-fills the frame's
  rectangle in the canvas the next frame starts from; the ANIM background
  colour is not painted;
- frames: VP8 (vp8.py, yuv.py) with its ``ALPH`` plane (webp_alpha.py) or
  opaque, VP8L (vp8l.py);
- Pillow's view: ``n_frames`` is the demuxer's frame count; ``info``
  holds ``loop``, ``background`` (R, G, B, A) and the ``icc_profile``,
  ``exif`` and ``xmp`` chunks that are not empty; ``convert("RGB")``
  drops alpha without matting (a pixel of alpha 0 keeps its colour).

The canvas is checked against Pillow's decompression-bomb limit before
anything is decoded. A malformed file raises ``ValueError("undecodable
image bytes: ...")``.
"""

from __future__ import annotations

import struct
from collections.abc import Iterable, Iterator

import numpy as np

from dynamo_tpu_torch.multimodal.formats import check_size, undecodable
from dynamo_tpu_torch.multimodal.vp8 import decode_vp8, vp8_size
from dynamo_tpu_torch.multimodal.vp8l import decode_vp8l, vp8l_info
from dynamo_tpu_torch.multimodal.webp_alpha import decode_alpha
from dynamo_tpu_torch.multimodal.yuv import yuv_to_rgb

__all__ = ["WebPReader", "is_webp"]

_MAX_PAYLOAD = (1 << 32) - 1 - 8 - 1
_ANIMATION, _XMP, _EXIF, _ALPHA, _ICCP = 0x02, 0x04, 0x08, 0x10, 0x20
_VALID_FLAGS = _ANIMATION | _XMP | _EXIF | _ALPHA | _ICCP
_OPEN_ERROR = "could not create decoder object"


def is_webp(data: bytes) -> bool:
    """Pillow's ``_accept``: RIFF, WEBP, and a VP8, VP8L or VP8X chunk first."""
    return data[:4] == b"RIFF" and data[8:12] == b"WEBP" and data[12:16] in (
        b"VP8 ", b"VP8L", b"VP8X")


class _Frame:
    __slots__ = ("x", "y", "width", "height", "duration", "dispose_bg", "blend",
                 "alpha", "image", "lossless", "has_alpha", "num")

    def __init__(self):
        self.x = self.y = self.width = self.height = self.duration = 0
        self.dispose_bg = False
        self.blend = True
        self.alpha = None  # (offset, declared size) of the ALPH payload
        self.image = None  # (offset, declared size) of the VP8/VP8L payload
        self.lossless = False
        self.has_alpha = False
        self.num = 0


class _Fail(Exception):
    """The demuxer refuses the file."""


class WebPReader:
    """A WebP file's frames as Pillow's ``seek(k).convert("RGB")`` gives
    them.

    ``n_frames``, ``size`` (canvas width, height) and ``info`` are read
    without decoding; ``frames(indices)`` yields, for each index in
    ascending order, ``(index, rgb uint8 [H, W, 3])``."""

    def __init__(self, data: bytes):
        if not is_webp(data):
            raise undecodable("not a WebP file")
        try:
            self._demux(data)
        except _Fail:
            raise undecodable(_OPEN_ERROR) from None
        self.size = (self.canvas_w, self.canvas_h)
        check_size(*self.size)
        self.n_frames = len(self.frame_list)
        self.info: dict = {"loop": self.loop,
                           "background": ((self.bgcolor >> 16) & 255, (self.bgcolor >> 8) & 255,
                                          self.bgcolor & 255, (self.bgcolor >> 24) & 255)}
        for key, tag in (("icc_profile", b"ICCP"), ("exif", b"EXIF"), ("xmp", b"XMP ")):
            if self.chunks.get(tag):
                self.info[key] = self.chunks[tag]

    # ------------------------------------------------------------ demux

    def _demux(self, data: bytes) -> None:
        if len(data) < 20:
            raise _Fail
        riff_size = struct.unpack("<I", data[4:8])[0]
        if riff_size < 8 or riff_size > _MAX_PAYLOAD:
            raise _Fail
        self.end = riff_size + 8
        if len(data) < self.end:
            raise _Fail  # a partial file
        self.buf = data[: self.end]
        self.canvas_w = self.canvas_h = 0
        self.flags = 0
        self.loop, self.bgcolor = 1, 0xFFFFFFFF
        self.chunks: dict[bytes, bytes] = {}
        self.frame_list: list[_Frame] = []
        self.extended = False
        if self.buf[12:16] == b"VP8X":
            self._parse_vp8x(12)
            self._valid_extended()
        else:
            self._parse_single(12)
            f = self.frame_list[0] if self.frame_list else None
            if self.canvas_w <= 0 or self.canvas_h <= 0 or f is None or f.width <= 0:
                raise _Fail

    def _le(self, pos: int, n: int) -> int:
        return int.from_bytes(self.buf[pos: pos + n], "little")

    def _store_frame(self, pos: int, num: int, min_size: int, f: _Frame) -> int:
        """``StoreFrame``: an optional ALPH and a VP8/VP8L chunk from
        ``pos`` -> the position after them."""
        end = self.end
        if end - pos < 8 or end - pos < min_size:
            raise _Fail
        alpha_chunks = image_chunks = 0
        while True:
            start = pos
            fourcc, size = self.buf[pos: pos + 4], self._le(pos + 4, 4)
            pos += 8
            if size > _MAX_PAYLOAD:
                raise _Fail
            padded = size + (size & 1)
            if padded > end - pos:
                raise _Fail
            done = False
            if fourcc == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                f.alpha, f.has_alpha, f.num = (pos, size), True, num
                pos += padded
            elif fourcc in (b"VP8 ", b"VP8L") and image_chunks == 0:
                if fourcc == b"VP8L" and alpha_chunks:
                    raise _Fail  # VP8L carries its own alpha
                payload = self.buf[pos: pos + size]
                try:
                    if fourcc == b"VP8L":
                        f.width, f.height, alpha = vp8l_info(payload)
                    else:
                        (f.width, f.height), alpha = vp8_size(payload), False
                except ValueError:
                    raise _Fail from None
                image_chunks = 1
                f.image, f.lossless, f.num = (pos, size), fourcc == b"VP8L", num
                f.has_alpha |= alpha
                pos += padded
            else:
                pos, done = start, True
            if pos == end:
                return pos
            if end - pos < 8:
                raise _Fail
            if done:
                return pos

    def _parse_single(self, pos: int) -> int:
        if self.frame_list or self.end - pos < 8:
            raise _Fail
        f = _Frame()
        pos = self._store_frame(pos, 1, 0, f)
        if not self.flags & _ALPHA and f.alpha is not None:
            f.alpha, f.has_alpha = None, False
        if not self.extended and f.width > 0 and f.height > 0:
            self.canvas_w, self.canvas_h = f.width, f.height
            self.flags |= _ALPHA if f.has_alpha else 0
        self._add(f)
        return pos

    def _add(self, f: _Frame) -> None:
        if self.frame_list and self.frame_list[-1].image is None:
            raise _Fail  # the last frame was left incomplete
        self.frame_list.append(f)

    def _parse_vp8x(self, pos: int) -> None:
        self.extended = True
        size = self._le(pos + 4, 4)
        if size != 10:  # Pillow's libwebp opens no other VP8X size
            raise _Fail
        size += size & 1
        pos += 8
        if size > self.end - pos:
            raise _Fail
        self.flags = self.buf[pos]
        self.canvas_w, self.canvas_h = 1 + self._le(pos + 4, 3), 1 + self._le(pos + 7, 3)
        if self.canvas_w * self.canvas_h >= 1 << 32:
            raise _Fail
        pos += size
        if self.end - pos < 8:
            raise _Fail
        animation = bool(self.flags & _ANIMATION)
        anim_chunks = 0
        while True:
            start = pos
            fourcc, size = self.buf[pos: pos + 4], self._le(pos + 4, 4)
            pos += 8
            if size > _MAX_PAYLOAD:
                raise _Fail
            padded = size + (size & 1)
            if padded > self.end - pos:
                raise _Fail
            if fourcc == b"VP8X":
                raise _Fail
            if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks or animation:
                    raise _Fail  # an animation's frames are all in ANMF chunks
                pos = self._parse_single(start)
            elif fourcc == b"ANIM" and anim_chunks == 0:
                if padded < 6:
                    raise _Fail
                anim_chunks = 1
                self.bgcolor, self.loop = self._le(pos, 4), self._le(pos + 4, 2)
                pos += padded
            elif fourcc == b"ANMF":
                if not anim_chunks:
                    raise _Fail  # ANIM precedes the frames
                pos = self._parse_anmf(pos, padded, animation)
            else:
                store = {b"ICCP": _ICCP, b"EXIF": _EXIF, b"XMP ": _XMP}.get(fourcc)
                if fourcc == b"ANIM":
                    store = 0
                if store is not None and self.flags & store and fourcc not in self.chunks:
                    self.chunks[fourcc] = self.buf[pos: pos + size]
                pos += padded
            if pos == self.end:
                return
            if self.end - pos < 8:
                raise _Fail

    def _parse_anmf(self, pos: int, size: int, animation: bool) -> int:
        if size < 16 or self.end - pos < 16:
            raise _Fail
        f = _Frame()
        f.x, f.y = 2 * self._le(pos, 3), 2 * self._le(pos + 3, 3)
        f.width, f.height = 1 + self._le(pos + 6, 3), 1 + self._le(pos + 9, 3)
        f.duration = self._le(pos + 12, 3)
        bits = self.buf[pos + 15]
        f.dispose_bg, f.blend = bool(bits & 1), not bits & 2
        if f.width * f.height >= 1 << 32:
            raise _Fail
        start = pos + 16
        pos = self._store_frame(start, len(self.frame_list) + 1, size - 16, f)
        if pos - start > size - 16:
            raise _Fail
        if animation and f.num > 0:
            self._add(f)
        return pos

    def _valid_extended(self) -> None:
        animation = bool(self.flags & _ANIMATION)
        if self.canvas_w <= 0 or self.canvas_h <= 0 or not self.frame_list:
            raise _Fail
        if self.flags & ~_VALID_FLAGS:
            raise _Fail
        for f in self.frame_list:
            if not animation and f.num > 1:
                raise _Fail
            if f.image is None:
                raise _Fail  # a partial frame in a complete file
            if f.alpha is not None and f.alpha[0] > f.image[0]:
                raise _Fail
            if f.width <= 0 or f.height <= 0:
                raise _Fail
            if not animation:
                if f.x or f.y or (f.width, f.height) != (self.canvas_w, self.canvas_h):
                    raise _Fail
            elif f.x + f.width > self.canvas_w or f.y + f.height > self.canvas_h:
                raise _Fail

    # ----------------------------------------------------------- decode

    def _decode_frame(self, f: _Frame) -> np.ndarray:
        """One frame's bitstream -> straight RGBA uint8 [h, w, 4]."""
        off, size = f.image
        # the decoders read on to the end of the frame's data: the padding
        # byte of an odd-sized chunk is theirs (WebPDecode's data_size)
        payload = self.buf[off: off + size + (size & 1)]
        if f.lossless:
            argb = decode_vp8l(payload)
            return np.ascontiguousarray(argb, "<u4").view(np.uint8).reshape(
                argb.shape + (4,))[..., [2, 1, 0, 3]]
        y, u, v = decode_vp8(payload)
        rgba = np.empty(y.shape + (4,), np.uint8)
        rgba[..., :3] = yuv_to_rgb(y, u, v)
        if f.alpha is not None:
            aoff, asize = f.alpha
            rgba[..., 3] = decode_alpha(self.buf[aoff: aoff + asize], f.width, f.height)
        else:
            rgba[..., 3] = 255
        return rgba

    def frames(self, indices: Iterable[int]) -> Iterator[tuple[int, np.ndarray]]:
        """Decode forward from the first frame, as far as the largest index,
        keeping only the frames asked for."""
        want = sorted(set(indices))
        if not want:
            return
        if want[0] < 0 or want[-1] >= self.n_frames:
            raise undecodable("attempt to seek outside sequence")
        w, h = self.size
        cur = np.zeros((h, w, 4), np.uint8)
        disposed = np.zeros((h, w, 4), np.uint8)
        prev = None
        prev_key = False
        wi = 0
        for k, f in enumerate(self.frame_list[: want[-1] + 1]):
            full = (f.width, f.height) == (w, h)
            key = (k == 0 or ((not f.has_alpha or not f.blend) and full)
                   or (prev.dispose_bg and ((prev.width, prev.height) == (w, h) or prev_key)))
            if key:
                cur[...] = 0
            else:
                cur[...] = disposed
            try:
                px = self._decode_frame(f)
            except ValueError as e:
                raise undecodable(f"failed to read next frame ({e})") from None
            x0, y0, x1, y1 = f.x, f.y, f.x + f.width, f.y + f.height
            cur[y0:y1, x0:x1] = px
            if k > 0 and f.blend and not key:
                blend = np.ones((f.height, f.width), bool)
                if prev.dispose_bg:
                    # no blend inside the previous frame's rectangle
                    ys = np.arange(y0, y1)[:, None]
                    xs = np.arange(x0, x1)[None, :]
                    inside = ((ys >= prev.y) & (ys < prev.y + prev.height)
                              & (xs >= prev.x) & (xs < prev.x + prev.width))
                    # a row meeting the previous rectangle in x skips only
                    # its overlap; rows outside it in y blend in full
                    blend = ~inside
                region = cur[y0:y1, x0:x1]
                region[...] = _blend(region, disposed[y0:y1, x0:x1], blend)
            prev, prev_key = f, key
            disposed[...] = cur
            if f.dispose_bg:
                disposed[y0:y1, x0:x1] = 0
            if k == want[wi]:
                yield k, cur[..., :3].copy()
                wi += 1
                if wi == len(want):
                    return


def _blend(src: np.ndarray, dst: np.ndarray, where: np.ndarray) -> np.ndarray:
    """``BlendPixelRowNonPremult``: each selected pixel of ``src`` whose
    alpha is not 255 blended over ``dst`` (straight RGBA)."""
    s = src.astype(np.int64)
    d = dst.astype(np.int64)
    sa, da = s[..., 3], d[..., 3]
    dfa = (da * (256 - sa)) >> 8
    ba = (sa + dfa) & 0xFF
    scale = (1 << 24) // np.maximum(ba, 1)
    out = np.empty_like(s)
    for c in range(3):
        out[..., c] = (((s[..., c] * sa + d[..., c] * dfa) * scale & 0xFFFFFFFF) >> 24) & 0xFF
    out[..., 3] = ba
    out = np.where((sa == 0)[..., None], d, out)
    take = where & (sa != 255)
    return np.where(take[..., None], out, s).astype(np.uint8)
