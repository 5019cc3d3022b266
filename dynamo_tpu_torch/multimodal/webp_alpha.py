"""A WebP ``ALPH`` chunk decoded as libwebp 1.6's ``src/dec/alpha_dec.c``
decodes it, with numpy: the alpha plane of a lossy frame.

- the header byte: compression (0 raw, 1 lossless), filter (none,
  horizontal, vertical, gradient), pre-processing (0 or 1) and two
  reserved bits that must be 0;
- raw alpha: the first ``width * height`` bytes; lossless alpha: a
  headerless VP8L stream (vp8l.py) whose green channel is the plane;
- the unfilters of ``src/dsp/filters.c``: each row's first sample
  predicted from the one above (0 on the first row), horizontal from the
  left, vertical from above (the first row horizontal), gradient as
  ``clip(left + top - top_left)`` (the first row horizontal). Vertical
  is one vector step per row, the others a running sum or one step per
  pixel;
- pre-processing (level quantization) changes nothing: libwebp dithers
  alpha only when asked to, and the default configuration does not.
"""

from __future__ import annotations

import numpy as np

from dynamo_tpu_torch.multimodal.formats import undecodable
from dynamo_tpu_torch.multimodal.vp8l import decode_argb_stream

__all__ = ["decode_alpha"]


def _unfilter(plane: np.ndarray, kind: int) -> np.ndarray:
    """``WebPUnfilters[kind]`` row by row over deltas [h, w] -> uint8."""
    h, w = plane.shape
    out = np.empty((h, w), np.uint8)
    prev = None
    for y in range(h):
        d = plane[y]
        if kind == 0:
            row = d
        elif kind == 1 or prev is None:  # horizontal (also every first row)
            row = np.cumsum(d, dtype=np.uint8)
            if prev is not None:
                row = row + prev[0]
        elif kind == 2:  # vertical
            row = d + prev
        else:  # gradient
            top = prev.astype(np.int32).tolist()
            dl = d.tolist()
            left = tl = top[0]
            vals = []
            for i in range(w):
                g = left + top[i] - tl
                left = (dl[i] + (0 if g < 0 else 255 if g > 255 else g)) & 0xFF
                tl = top[i]
                vals.append(left)
            row = np.array(vals, np.uint8)
        out[y] = row
        prev = out[y]
    return out


def decode_alpha(chunk: bytes, width: int, height: int) -> np.ndarray:
    """An ``ALPH`` chunk's payload -> the alpha plane uint8 [height, width]."""
    if len(chunk) <= 1:
        raise undecodable("Could not decode alpha data.")
    method, kind, pre, rsrv = chunk[0] & 3, (chunk[0] >> 2) & 3, (chunk[0] >> 4) & 3, chunk[0] >> 6
    if method > 1 or pre > 1 or rsrv:
        raise undecodable("Could not decode alpha data.")
    if method == 0:
        if len(chunk) - 1 < width * height:
            raise undecodable("Could not decode alpha data.")
        plane = np.frombuffer(chunk, np.uint8, width * height, 1).reshape(height, width)
    else:
        plane = ((decode_argb_stream(chunk[1:], width, height) >> 8) & 0xFF).astype(np.uint8)
    return _unfilter(plane, kind)
