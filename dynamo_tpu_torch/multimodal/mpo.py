"""MPO (CIPA DC-007 multi-picture) files as Pillow 12 opens them: a JPEG
whose MP index names more than one image (and that is not Ultra HDR) is
an MPO, each image a frame.

- the MP index (``JpegImagePlugin._getmp``): the TIFF directory of the
  last ``MPF`` APP2 segment before the first scan, tag 0xB001 (the number
  of images, Pillow's ``n_frames``) and 0xB002 (16-byte entries: attribute,
  size, data offset, dependent entries). An index Pillow reads as
  malformed (no number of images, no entries, an image format other than
  JPEG, a count that is not a single number) leaves a plain JPEG;
- frame k is the JPEG at ``data offset + the offset of the MP header``
  (frame 0 at the start of the file), decoded as its own JPEG
  (``MpoImageFile.seek`` re-reads the frame's markers, size and mode);
- ``info``: a frame with ICC segments has its own ``icc_profile``; one
  without keeps frame 0's, as Pillow's ``info`` carries it across seeks;
- Pillow decodes a frame into the image memory of the frame it loaded
  before when their sizes are equal, so a frame of another mode at that
  size comes out as its samples packed into the other mode's pixels: such
  a frame raises ValueError naming the ROADMAP item that would port it.
"""

from __future__ import annotations

import struct
from collections.abc import Iterable, Iterator

import numpy as np

from dynamo_tpu_torch.multimodal.formats import ITEM_OTHER_FORMATS, undecodable
from dynamo_tpu_torch.multimodal.jpeg import decode_jpeg

__all__ = ["MpoReader", "mpo_reader"]

# TIFF field types: bytes per value
_TYPE_SIZE = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
              13: 4, 16: 8, 17: 8, 18: 8}


def _directory(mp: bytes) -> dict[int, tuple[int, int, bytes]]:
    """The first TIFF directory of an MP header as Pillow's
    ``ImageFileDirectory_v2.load`` reads it: tag -> (type, count, data),
    unknown types and short data skipped, a truncated directory kept as
    far as it was read."""
    end = ">" if mp[:4] == b"MM\x00*" else "<"
    tags: dict[int, tuple[int, int, bytes]] = {}
    try:
        (off,) = struct.unpack(end + "I", mp[4:8])
        (n,) = struct.unpack(end + "H", mp[off: off + 2])
    except struct.error:
        return tags
    for i in range(n):
        entry = mp[off + 2 + 12 * i: off + 14 + 12 * i]
        if len(entry) < 12:
            break
        tag, typ, count = struct.unpack(end + "HHI", entry[:8])
        if typ not in _TYPE_SIZE:
            continue
        size = count * _TYPE_SIZE[typ]
        if size > 4:
            (at,) = struct.unpack(end + "I", entry[8:])
            data = mp[at: at + size]
            if len(data) < size:
                break  # a truncated read ends the directory
        else:
            data = entry[8: 8 + size]
        if data:
            tags[tag] = (typ, count, data)
    return tags


def _header(data: bytes) -> tuple[bytes | None, int, bool, tuple | None]:
    """Walking the markers as Pillow's JPEG open does, up to the first
    scan: the last ``MPF`` segment and the file offset of its TIFF header,
    whether an APP1 names Ultra HDR (``hdrgm``), and the frame header's
    (width, height, components)."""
    n, pos = len(data), 2
    mp, mp_offset, ultra, sof = None, 0, False, None
    while pos < n:
        if data[pos] != 0xFF:
            pos += 1
            continue
        while pos < n and data[pos] == 0xFF:
            pos += 1
        if pos >= n:
            break
        m = data[pos]
        pos += 1
        if m in (0xD9, 0xDA):
            break
        if m in (0xD8, 0x01) or 0xD0 <= m <= 0xD7:
            continue
        if pos + 2 > n:
            break
        (length,) = struct.unpack(">H", data[pos: pos + 2])
        body = data[pos + 2: pos + length]
        if length < 2 or len(body) != length - 2:
            break
        if m == 0xE1 and b' hdrgm:Version="' in body:
            ultra = True
        elif m == 0xE2 and body[:4] == b"MPF\x00":
            mp, mp_offset = body[4:], pos + 6
        elif 0xC0 <= m <= 0xCF and m not in (0xC4, 0xC8, 0xCC) and len(body) >= 6:
            height, width, nf = struct.unpack(">HHB", body[1:6])
            sof = (width, height, nf)
        pos += length
    return mp, mp_offset, ultra, sof


def mpo_reader(data: bytes) -> MpoReader | None:
    """An ``MpoReader`` when Pillow opens this JPEG as an MPO, else None."""
    mp, mp_offset, ultra, _ = _header(data)
    offsets = _offsets(mp, mp_offset) if mp is not None and not ultra else None
    return MpoReader(data, offsets) if offsets else None


def _offsets(mp: bytes, mp_offset: int) -> list[int] | None:
    """The file offset of each image an MP index names (frame 0 at 0), or
    None where Pillow reads the file as a plain JPEG."""
    end = ">" if mp[:4] == b"MM\x00*" else "<"
    tags = _directory(mp)
    if 0xB001 not in tags or 0xB002 not in tags:
        return None
    typ, count, data = tags[0xB001]
    if count != 1 or typ not in (1, 3, 4, 8, 9):
        return None  # not a single number: Pillow's comparison fails
    fmt = {1: "B", 3: "H", 4: "I", 8: "h", 9: "i"}[typ]
    n = struct.unpack(end + fmt, data[: struct.calcsize(fmt)])[0]
    if n <= 1:
        return None
    entries = tags[0xB002][2]
    offsets = []
    for k in range(n):
        try:
            attr, _size, off, _e1, _e2 = struct.unpack_from(end + "LLLHH", entries, 16 * k)
        except struct.error:
            raise undecodable("cannot identify image file (malformed MP entries)") from None
        if (attr >> 24) & 7:
            return None  # not JPEG data: Pillow warns and opens a plain JPEG
        offsets.append(off + mp_offset)
    offsets[0] = 0
    return offsets


class MpoReader:
    """An MPO's frames as Pillow's ``seek(k).convert("RGB")`` gives them."""

    def __init__(self, data: bytes, offsets: list[int]):
        self._data = data
        self.offsets = offsets
        self.n_frames = len(offsets)

    def frames(self, indices: Iterable[int]) -> Iterator[tuple[int, np.ndarray, dict]]:
        """(index, rgb uint8 [H, W, 3], info) for each index in ascending
        order; only the frames asked for are decoded. Pillow decodes a frame
        into the image memory of the frame loaded before it when their
        sizes are equal: a frame of another mode (grey after colour, or
        colour after grey) there is refused."""
        want = sorted(set(indices))
        if want and (want[0] < 0 or want[-1] >= self.n_frames):
            raise undecodable("attempt to seek outside sequence")
        first_info = None
        loaded = None  # (width, height, components) of the frame before
        for k in want:
            off = self.offsets[k]
            if len(self._data[off + 2: off + 4]) == 0:
                raise undecodable("No data found for frame")
            frame = self._data[off:]
            sof = _header(frame)[3]
            if loaded is not None and sof is not None and sof[:2] == loaded[:2] \
                    and sof[2] != loaded[2]:
                raise ValueError("an MPO frame of another mode than the frame before it, at "
                                 "its size, is not decoded by this port "
                                 f"({ITEM_OTHER_FORMATS})")
            rgb, info = decode_jpeg(frame)
            loaded = sof
            if k == 0:
                first_info = info
            elif "icc_profile" not in info:
                if first_info is None:
                    first_info = decode_jpeg(self._data, pixels=False)[1]
                if "icc_profile" in first_info:
                    info = {"icc_profile": first_info["icc_profile"]}
            yield k, rgb, info
