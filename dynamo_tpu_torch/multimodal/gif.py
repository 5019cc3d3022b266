"""GIF decode with the standard library and numpy: each frame's pixels as
Pillow 12's GIF plugin composites them, and what its ``convert("RGB")``
carries in ``info``.

- the stream: logical screen, global and local colour tables, the graphic
  control extension (disposal 0-3, transparent index), NETSCAPE loop,
  comment and other extensions, interlaced frames; LZW with a variable
  code width, clear and end codes and a full 4,096-entry table whose clear
  comes late (the table stops growing until it does);
- compositing, after the plugin (``LOADING_STRATEGY`` ``RGB_AFTER_FIRST``):
  frame 0 is a palette image (mode ``P``, or ``L`` when no frame colour
  table or only the identity grey ramp is given) and later frames are
  ``RGB``, or ``RGBA`` when frame 0 had a transparent index; disposal 2 and
  3 as the plugin applies them (the disposal method persists until a later
  graphic control block names another), sub-rectangles at an offset, and
  frames past the logical screen, which grow the canvas;
- ``convert("RGB")``: a palette image's transparent index becomes the RGB
  colour of that index in ``info["transparency"]``, which later frames
  lose with the conversion.

Frames are decoded in order, as Pillow seeks; only the frames asked for are
kept. A GIF whose frame 0 is greyscale (no colour table of its own, or the
grey ramp) while a later frame uses a colour table raises ValueError naming
the ROADMAP item that would port it.
"""

from __future__ import annotations

import struct
from array import array
from collections.abc import Iterable, Iterator

import numpy as np

from dynamo_tpu_torch.multimodal.formats import ITEM_OTHER_FORMATS, check_size, undecodable

__all__ = ["GifReader"]

_TABLE = 4096  # LZW entries


def _is_palette_needed(p: bytes) -> bool:
    """False for the identity grey ramp (entry i is (i, i, i)), which the
    plugin reads as a greyscale image."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2]) for i in range(0, len(p) - 2, 3))


def _pal256(p: bytes) -> np.ndarray:
    """A colour table as the 256-entry palette the image carries: the
    entries past the table are black."""
    out = np.zeros((256, 3), np.uint8)
    n = min(len(p) // 3, 256)
    out[:n] = np.frombuffer(p[: 3 * n], np.uint8).reshape(n, 3)
    return out


class _Frame:
    __slots__ = ("extent", "palette", "transparency", "disposal", "interlace", "bits", "data")


class GifReader:
    """A GIF's frames as Pillow's ``seek(k).convert("RGB")`` gives them.

    ``n_frames`` is Pillow's count; ``frames(indices)`` yields, for each
    index in ascending order, ``(index, rgb uint8 [H, W, 3], transparency)``
    where ``transparency`` is the RGB tuple of ``info["transparency"]`` or
    None."""

    def __init__(self, data: bytes):
        if data[:6] not in (b"GIF87a", b"GIF89a") or len(data) < 13:
            raise undecodable("not a GIF file")
        self._data = data
        w, h, flags, bg = struct.unpack("<HHBB", data[6:12])
        check_size(w, h)
        self.size = (w, h)
        self.background = 0
        self.global_palette = None
        pos = 13
        if flags & 128:
            self.background = bg
            p = data[pos: pos + (3 << ((flags & 7) + 1))]
            pos += 3 << ((flags & 7) + 1)
            if _is_palette_needed(p):
                self.global_palette = p
        self._frames = self._parse(pos)
        if not self._frames:
            raise undecodable("image not found in GIF frame")
        self.n_frames = len(self._frames)

    def _sub_blocks(self, pos: int) -> tuple[list[bytes], int]:
        """The data sub-blocks from ``pos`` up to the terminator."""
        data, out = self._data, []
        while pos < len(data) and data[pos]:
            n = data[pos]
            out.append(data[pos + 1: pos + 1 + n])
            pos += 1 + n
        return out, pos + 1

    def _parse(self, pos: int) -> list[_Frame]:
        """Walk the stream as the plugin does: extensions and junk bytes up
        to each image descriptor, its data skipped to the next."""
        data, frames = self._data, []
        disposal = 0
        while True:
            transparency = None
            while True:
                if pos >= len(data) or data[pos] == 0x3B:
                    return frames
                s = data[pos]
                pos += 1
                if s == 0x21:
                    if pos >= len(data):
                        return frames
                    label = data[pos]
                    blocks, pos = self._sub_blocks(pos + 1)
                    if label == 0xF9 and blocks:
                        b = blocks[0]
                        if len(b) < 4:
                            raise undecodable("short GIF graphic control block")
                        if b[0] & 1:
                            transparency = b[3]
                        if (b[0] >> 2) & 7:  # an unspecified method keeps the last
                            disposal = (b[0] >> 2) & 7
                elif s == 0x2C:
                    d = data[pos: pos + 9]
                    if len(d) < 9:
                        raise undecodable("truncated GIF image descriptor")
                    x0, y0, fw, fh, flags = struct.unpack("<HHHHB", d)
                    pos += 9
                    f = _Frame()
                    f.extent = (x0, y0, x0 + fw, y0 + fh)
                    f.palette = None
                    if flags & 128:
                        n = 3 << ((flags & 7) + 1)
                        p = data[pos: pos + n]
                        pos += n
                        # an identity grey table: no palette for this frame
                        f.palette = p if _is_palette_needed(p) else False
                    if pos >= len(data):
                        raise undecodable("truncated GIF image data")
                    f.bits = data[pos]
                    f.interlace = bool(flags & 64)
                    f.transparency = transparency
                    f.data = pos + 1
                    f.disposal = disposal
                    _, pos = self._sub_blocks(pos + 1)
                    frames.append(f)
                    break
                # any other byte is skipped

    # ------------------------------------------------------------- pixels

    def _lzw(self, f: _Frame, count: int) -> bytes:
        """The frame's first ``count`` indices. Raises where Pillow's
        decoder finds the data short or broken."""
        bits = f.bits
        if not 2 <= bits <= 8:
            raise undecodable(f"GIF LZW code size {bits}")
        blocks, _ = self._sub_blocks(f.data)
        stream = b"".join(blocks)
        buf = np.frombuffer(stream + bytes(8), np.uint8).astype(np.uint64)
        nwin = len(stream) + 1
        win = np.zeros(nwin, np.uint64)
        for i in range(8):  # little-endian 64-bit windows at every byte
            win |= buf[i: i + nwin] << np.uint64(8 * i)
        w = array("Q")
        w.frombytes(win.tobytes())
        nbits = 8 * len(stream)
        clear, end = 1 << bits, (1 << bits) + 1
        base = [bytes([i]) for i in range(clear)] + [b"", b""]
        table = list(base)
        size, nxt, prev = bits + 1, clear + 2, -1
        mask = (1 << size) - 1
        out: list[bytes] = []
        have = 0
        p = 0
        while have < count:
            if p + size > nbits:
                raise undecodable("GIF image data is truncated")
            c = (w[p >> 3] >> (p & 7)) & mask
            p += size
            if c == clear:
                table = list(base)
                size, nxt, prev = bits + 1, clear + 2, -1
                mask = (1 << size) - 1
                continue
            if c == end:
                raise undecodable("GIF image data is truncated")
            if prev < 0:
                if c >= clear:
                    raise undecodable("broken GIF data stream")
                entry = table[c]
            else:
                if c < nxt:
                    entry = table[c]
                    new = table[prev] + entry[:1]
                elif c == nxt:
                    new = entry = table[prev] + table[prev][:1]
                else:
                    raise undecodable("broken GIF data stream")
                if nxt < _TABLE:
                    table.append(new)
                    if nxt == mask and size < 12:
                        size += 1
                        mask = (1 << size) - 1
                    nxt += 1
            out.append(entry)
            have += len(entry)
            prev = c
        return b"".join(out)[:count]

    def _indices(self, f: _Frame) -> np.ndarray:
        """The frame's indices [h, w] in row order."""
        x0, y0, x1, y1 = f.extent
        fw, fh = x1 - x0, y1 - y0
        if fw <= 0 or fh <= 0:
            raise undecodable("GIF frame of zero size")
        px = np.frombuffer(self._lzw(f, fw * fh), np.uint8).reshape(fh, fw)
        if f.interlace:
            rows = np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                   np.arange(2, fh, 4), np.arange(1, fh, 2)])
            out = np.empty_like(px)
            out[rows] = px
            px = out
        return px

    def frames(self, indices: Iterable[int]) -> Iterator[tuple[int, np.ndarray, tuple | None]]:
        want = sorted(set(indices))
        if want and not 0 <= want[0] <= want[-1] < self.n_frames:
            raise undecodable(f"GIF frame {want[-1]} of {self.n_frames}")
        state = _Canvas(self)
        for k in range(want[-1] + 1 if want else 0):
            state.step(k, self._frames[k])
            if k in want:
                yield (k,) + state.rgb()


def _paste(dst: np.ndarray, src: np.ndarray, x0: int, y0: int) -> None:
    """Pillow's ``paste`` without a mask: ``src`` at (x0, y0), clipped."""
    h = min(src.shape[0], dst.shape[0] - y0)
    w = min(src.shape[1], dst.shape[1] - x0)
    if h > 0 and w > 0:
        dst[y0: y0 + h, x0: x0 + w] = src[:h, :w]


def _crop(img: np.ndarray, extent) -> np.ndarray:
    """Pillow's ``crop``: zeros past the image."""
    x0, y0, x1, y1 = extent
    out = np.zeros((y1 - y0, x1 - x0) + img.shape[2:], img.dtype)
    _paste(out, img[y0:y1, x0:x1], 0, 0)
    return out


class _Canvas:
    """The plugin's state between seeks: the mode, the image (indices [H,
    W] for P and L, [H, W, 4] for RGB and RGBA, the fourth byte alpha or
    padding as Pillow stores them), the palette, ``info["transparency"]``
    and the disposal to apply before the next frame."""

    def __init__(self, reader: GifReader):
        self.r = reader
        self.size = reader.size
        self.mode = None
        self.im = None
        self.pal = None  # the palette [256, 3] of a P or L image, if it has one
        self.info_t = None
        self.dispose = None
        self.dispose_extent = None

    def step(self, k: int, f: _Frame) -> None:
        """``_seek(k)`` and the load that follows it."""
        r = self.r
        x0, y0, x1, y1 = f.extent
        w, h = self.size
        if x1 > w or y1 > h:
            self.size = (max(x1, w), max(y1, h))
            check_size(*self.size)
        if self.dispose is not None:
            _paste(self.im, self.dispose, *self.dispose_extent[:2])
        fpal = f.palette if f.palette is not None else r.global_palette
        if k == 0:
            self.mode = "P" if fpal else "L"
            # the image's palette: the frame's table, else the global one
            # (a greyscale frame 0 still takes a global table's colours)
            image_pal = f.palette or r.global_palette
            self.pal = _pal256(image_pal) if image_pal else None
        elif self.mode == "P":
            rgb = self.pal[self.im]
            alpha = np.full(self.im.shape + (1,), 255, np.uint8)
            if self.info_t is not None:
                alpha[self.im == self.info_t] = 0
                self.mode, self.info_t = "RGBA", None
            else:
                self.mode = "RGB"
            self.im = np.concatenate([rgb, alpha], axis=2)
        elif self.mode == "L" and (fpal or self.pal is not None):
            raise ValueError("a GIF whose first frame is greyscale while a colour table is "
                             f"in use is not decoded by this port ({ITEM_OTHER_FORMATS})")
        rgb_mode = self.mode in ("RGB", "RGBA")

        def colour(c: int) -> tuple[int, int, int]:
            if fpal:
                if c * 3 + 3 > len(fpal):
                    c = 0
                return tuple(fpal[c * 3: c * 3 + 3])
            return (c, c, c)

        def fill(value, rgba: bool | None) -> np.ndarray:
            """``Image.core.fill`` over the frame's extent: P indices, or
            RGB(A) with the alpha byte given (RGB pads with 255)."""
            check_size(x1 - x0, y1 - y0)
            if rgba is None:
                return np.full((y1 - y0, x1 - x0), value, np.uint8)
            px = colour(value) + ((0,) if rgba else (255,))
            return np.broadcast_to(np.array(px, np.uint8), (y1 - y0, x1 - x0, 4)).copy()

        self.dispose = None
        self.dispose_extent = f.extent
        if f.disposal == 2:
            t = self.info_t if self.info_t is not None else f.transparency
            if t is not None:
                self.dispose = fill(t, True if rgb_mode else None)
            else:
                self.dispose = fill(r.background, False if rgb_mode else None)
        elif f.disposal == 3:
            if k > 0:
                self.dispose = _crop(self.im, f.extent)
            elif f.transparency is not None:
                self.dispose = fill(f.transparency, True if rgb_mode else None)
        skip = None
        if f.transparency is not None:
            if k == 0:
                self.info_t = f.transparency
            elif not rgb_mode:
                skip = f.transparency
        self._load(k, f, fpal, skip)

    def _load(self, k: int, f: _Frame, fpal, skip: int | None) -> None:
        """``load_prepare``, the decode into the frame's extent, ``load_end``."""
        w, h = self.size
        x0, y0, x1, y1 = f.extent
        idx = self.r._indices(f)
        t = f.transparency
        if k == 0:
            self.im = np.full((h, w), 0 if t is None else t, np.uint8)
            self.im[y0:y1, x0:x1] = idx
            return
        if self.mode == "L":  # greyscale frames decode in place, the skip index left
            if self.im.shape != (h, w):
                grown = np.zeros((h, w), np.uint8)
                _paste(grown, self.im, 0, 0)
                self.im = grown
            region = self.im[y0:y1, x0:x1]
            region[...] = idx if skip is None else np.where(idx == skip, region, idx)
            return
        prev = self.im
        pal = _pal256(fpal) if fpal else None
        if prev.shape[:2] != (h, w):
            if t is not None:
                grown = np.zeros((h, w, 4), np.uint8)
            elif pal is None:  # Pillow asks the frame's greyscale image for a palette
                raise undecodable("image has no palette")
            else:  # index 0 of the frame's palette
                grown = np.broadcast_to(np.append(pal[0], 255).astype(np.uint8), (h, w, 4)).copy()
            _paste(grown, prev, 0, 0)
            prev = grown
            self.mode = "RGBA" if t is not None else "RGB"
        # the frame on its own canvas, filled with the transparent index or 0
        rgb = pal[idx] if pal is not None else np.repeat(idx[..., None], 3, axis=2)
        region = prev[y0:y1, x0:x1]
        if t is None:
            region[..., :3] = rgb
            region[..., 3] = 255
        else:
            keep = idx == t
            region[...] = np.where(keep[..., None], region,
                                   np.concatenate([rgb, np.full(idx.shape + (1,), 255, np.uint8)],
                                                  axis=2))
        self.im = prev

    def rgb(self) -> tuple[np.ndarray, tuple | None]:
        """``convert("RGB")``: the pixels and the transparency it carries
        (a palette colour in mode P, grey in mode L)."""
        if self.mode in ("RGB", "RGBA"):
            return self.im[..., :3].copy(), None  # later frames paint over self.im
        t = self.info_t
        if t is not None:
            t = tuple(int(v) for v in self.pal[t]) if self.mode == "P" else (t,) * 3
        if self.pal is not None:
            return self.pal[self.im], t
        return np.repeat(self.im[..., None], 3, axis=2), t
