"""Animated PNG frames with the standard library and numpy, each as Pillow
12's PNG plugin composites it (``PngImageFile._seek`` and ``load_end``).

- the stream: the chunks up to the first image data read (and checked)
  as image.py reads a still PNG; after them, as Pillow reads on, without
  checksums: each frame's ``fcTL`` (sequence numbers counted across
  ``fcTL`` and ``fdAT``, the region inside the image) and the run of data
  chunks that follows it; an ``IDAT`` that comes before any ``fcTL`` is the
  default image, frame 0 of one more frame than ``acTL`` declares;
- compositing, on the image in its own mode (``1``, ``L``, ``I;16``, ``P``
  as palette indices, ``LA``, ``RGB``, ``RGBA``; 16-bit samples cut to
  their high byte except ``I;16``): frame 0 starts from zeros; a frame's
  pixels replace its region; dispose ``BACKGROUND`` zero-fills the region
  before the next frame and ``PREVIOUS`` restores it (``PREVIOUS`` on the
  first frame is ``BACKGROUND``); blend ``OVER`` (refused on ``I;16``, as
  Pillow cannot build its mask) pastes the region over the
  image before it through an RGBA mask, which is ``Image.paste``'s
  fixed-point ``BLEND`` of ``libImaging/Paste.c`` on every byte of the
  pixel, alpha and palette indices included: ``out = (o * (255 - a) + n
  * a)`` divided by 255 rounding as ``DIV255`` does. The mask's alpha is
  the frame's own (``LA``, ``RGBA``), the palette's alpha from ``tRNS``
  (``P``), 0 where an ``RGB`` pixel equals the ``tRNS`` colour (its low
  bytes) and 255 otherwise (and for every other mode);
- ``convert("RGB")`` and ``info`` as for a still PNG (image.py): the
  ``transparency`` and ``icc_profile`` read before the image data hold
  for every frame.

Frames are decoded in order, only as far as the largest index asked for.
A malformed stream raises ``ValueError("undecodable image bytes: ...")``.
"""

from __future__ import annotations

import re
import struct
from collections.abc import Iterable, Iterator

import numpy as np

from dynamo_tpu_torch.multimodal import image
from dynamo_tpu_torch.multimodal.formats import check_size, undecodable

__all__ = ["ApngReader"]

_DATA = (b"IDAT", b"DDAT", b"fdAT")
_IS_CID = re.compile(rb"\w\w\w\w")


class _Walk:
    """The chunks from a position as Pillow's reads see them, without
    checksums: (type, body, whole), a body cut short by the end of the
    file being what is left of it; at a broken or missing chunk header
    (b"", b"", False). One chunk can be pushed back."""

    def __init__(self, data: bytes, pos: int):
        self.data, self.pos, self.pushed = data, pos, None

    def next(self) -> tuple[bytes, bytes, bool]:
        if self.pushed is not None:
            c, self.pushed = self.pushed, None
            return c
        data, pos = self.data, self.pos
        if pos + 8 > len(data):
            return b"", b"", False
        length, cid = struct.unpack(">I4s", data[pos: pos + 8])
        if not _IS_CID.match(cid):
            return b"", b"", False
        body = data[pos + 8: pos + 8 + length]
        self.pos = pos + 12 + length
        return cid, body, len(body) == length

    def push(self, c: tuple[bytes, bytes, bool]) -> None:
        self.pushed = c


class ApngReader:
    """An animated PNG's frames as Pillow's ``seek(k).convert("RGB")``
    gives them: ``n_frames``, ``info`` (what image.py's still decode
    keeps) and ``frames(indices)``, yielding ``(index, rgb uint8 [H, W, 3])``
    for each index in ascending order."""

    def __init__(self, data: bytes):
        head = image.read_png_head(data)
        if head.actl is None:
            raise undecodable("not an animated PNG")
        self.head = head
        self.n_frames = head.n_frames
        self.info = head.info
        self._data = data

    def frames(self, indices: Iterable[int]) -> Iterator[tuple[int, np.ndarray]]:
        want = sorted(set(indices))
        if not want:
            return
        if want[0] < 0 or want[-1] >= self.n_frames:
            raise undecodable("attempt to seek outside sequence")
        hd = self.head
        w, h = hd.width, hd.height
        check_size(w, h)
        walk = _Walk(self._data, hd.data_pos)
        seq = hd.seq
        ctl = hd.first_ctl  # None for a default image
        first = walk.next()[1]  # the first IDAT's data
        canvas = None
        dispose = None  # (bbox, pixels) to paste back before the next frame
        wi = k = 0

        def run(first: bytes):
            """``load_read``: the frame's first data, then the data chunks
            after it, read only while the image needs them."""
            nonlocal seq
            yield first
            while True:
                c = walk.next()
                if c[0] not in _DATA:
                    walk.push(c)
                    return
                body = c[1]
                if c[0] == b"fdAT":
                    seq = _fdat_seq(body, seq)
                    body = body[4:]
                yield body

        while True:
            bbox = ctl.bbox if ctl is not None else (0, 0, w, h)
            x0, y0, x1, y1 = bbox
            if x0 == x1 == 0:
                # Pillow's decoder reads a tile of x 0 to 0 as the whole
                # image; disposal and blending keep the empty region
                x0, y0, x1, y1 = 0, 0, w, h
            elif x1 <= x0 or y1 <= y0:
                raise undecodable("tile cannot extend outside image")
            samples, written = image.inflate_samples(run(first), x1 - x0, y1 - y0, hd.depth,
                                                     hd.ctype, hd.interlace)
            new = image.mode_pixels(samples, hd.ctype, hd.depth)
            if canvas is None:
                canvas = np.zeros((h, w, new.shape[2]), new.dtype)
                prev = None
            else:
                if dispose is not None:
                    (dx0, dy0, dx1, dy1), pix = dispose
                    canvas[dy0:dy1, dx0:dx1] = pix
                prev = canvas.copy()
            # the frame's pixels into its region; pixels its data did not
            # reach keep the image's
            px = np.where(written[..., None], new, canvas[y0:y1, x0:x1])
            dop = ctl.dispose if ctl is not None else None
            if prev is None and dop == 2:
                dop = 1  # PREVIOUS on the first frame is BACKGROUND
            bx0, by0, bx1, by1 = bbox
            if dop == 2:
                dispose = (bbox, prev[by0:by1, bx0:bx1].copy())
            elif dop == 1:
                dispose = (bbox, np.zeros_like(canvas[by0:by1, bx0:bx1]))
            else:
                dispose = None
            canvas[y0:y1, x0:x1] = px
            # load_end: the chunks up to the next fcTL (a body cut short
            # fails the frame), then the blend
            while True:
                cid, body, whole = walk.next()
                if cid in (b"", b"IEND"):
                    break
                if cid == b"fcTL":
                    walk.push((cid, body, whole))
                    break
                if not whole:
                    raise undecodable("Truncated File Read")
                if cid == b"fdAT":
                    seq = _fdat_seq(body, seq)
            if prev is not None and ctl is not None and ctl.blend == 1:
                if canvas.dtype == np.uint16:  # Pillow's mask for an I;16 frame
                    raise undecodable("conversion from I;16 to RGBA not supported")
                region = canvas[by0:by1, bx0:bx1]
                prev[by0:by1, bx0:bx1] = _paste(prev[by0:by1, bx0:bx1], region,
                                                self._mask(region))
                canvas = prev
            if k == want[wi]:
                yield k, image.mode_to_rgb(canvas, hd.ctype, hd.depth, hd.palette)
                wi += 1
                if wi == len(want):
                    return
            # _seek: the next fcTL and the fdAT that starts its data
            frame_start = False
            while True:
                cid, body, whole = walk.next()
                if cid == b"IEND":
                    raise undecodable("No more images in APNG file")
                if cid == b"":
                    raise undecodable("truncated APNG")
                if cid == b"fdAT":
                    seq = _fdat_seq(body, seq)
                    if frame_start:
                        first = body[4:]
                        break
                if not whole:
                    raise undecodable("Truncated File Read")
                if cid == b"fcTL":
                    if frame_start:
                        raise undecodable("APNG missing frame data")
                    frame_start = True
                    ctl, seq = image.read_fctl(body, seq, w, h)
            k += 1

    def _mask(self, px: np.ndarray) -> np.ndarray:
        """The alpha of Pillow's RGBA mask for an ``OVER`` paste."""
        hd = self.head
        mode = image.png_mode(hd.ctype, hd.depth)
        if mode in ("LA", "RGBA"):
            return px[..., -1].astype(np.int32)
        t = hd.transparency
        if mode == "RGB" and t is not None:
            hit = ((px[..., 0] == (t[0] & 255)) & (px[..., 1] == (t[1] & 255))
                   & (px[..., 2] == (t[2] & 255)))
            return np.where(hit, 0, 255)
        if mode == "P" and t is not None:
            alpha = np.full(256, 255, np.int32)
            if isinstance(t, bytes):
                alpha[: len(t)] = np.frombuffer(t[:256], np.uint8)
            else:
                alpha[t] = 0
            return alpha[px[..., 0]]
        return np.full(px.shape[:2], 255, np.int32)


def _paste(out: np.ndarray, new: np.ndarray, a: np.ndarray) -> np.ndarray:
    """``paste_mask_RGBA``: ``BLEND(a, out, new)`` on every channel."""
    a = a[..., None]
    v = out.astype(np.int32) * (255 - a) + new.astype(np.int32) * a + 128
    return (((v >> 8) + v) >> 8).astype(out.dtype)


def _fdat_seq(body: bytes, seq: int | None) -> int:
    if len(body) < 4:
        raise undecodable("APNG contains truncated fDAT chunk")
    s = struct.unpack(">I", body[:4])[0]
    if seq is None or seq != s - 1:
        raise undecodable("APNG contains frame sequence errors")
    return s
