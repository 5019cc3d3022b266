"""libwebp's default RGB output of a lossy frame, with numpy: the "fancy"
upsampler of ``src/dsp/upsampling.c`` and the 14-bit integer YUV to RGB
of ``src/dsp/yuv.h``, bit for bit.

- upsampling (``UpsampleRgbaLinePair``): each output row takes its
  nearer chroma row at weight 3 and the farther one at weight 1, and each
  output column its nearer chroma column at 3 and the farther at 1, with
  the rounding of the packed 16-bit lanes (exact per lane). The first row
  takes chroma row 0 as both rows, and so does the last row of an even
  height; the first column and the last of an even width take one chroma
  column as both;
- ``VP8YUVToR/G/B``: ``MultHi(v, c) = (v * c) >> 8`` on 8-bit samples,
  6 fractional bits, and ``VP8Clip8``. Dithering is off by default and is
  not applied.
"""

from __future__ import annotations

import numpy as np

__all__ = ["yuv_to_rgb"]


def _upsample_rows(near: np.ndarray, far: np.ndarray, width: int) -> np.ndarray:
    """One output row per row of ``near`` [n, cw] (with its ``far`` row)
    -> [n, width] (int32)."""
    near, far = near.astype(np.int32), far.astype(np.int32)
    out = np.empty((near.shape[0], width), np.int32)
    out[:, 0] = (3 * near[:, 0] + far[:, 0] + 2) >> 2
    pairs = (width - 1) >> 1
    if pairs:
        tl, t = near[:, :pairs], near[:, 1: pairs + 1]
        lf, c = far[:, :pairs], far[:, 1: pairs + 1]
        avg = tl + t + lf + c + 8
        d12 = (avg + 2 * (t + lf)) >> 3
        d03 = (avg + 2 * (tl + c)) >> 3
        out[:, 1: 2 * pairs: 2] = (d12 + tl) >> 1
        out[:, 2: 2 * pairs + 1: 2] = (d03 + t) >> 1
    if not width & 1:
        out[:, width - 1] = (3 * near[:, pairs] + far[:, pairs] + 2) >> 2
    return out


def _upsample(c: np.ndarray, height: int, width: int) -> np.ndarray:
    """A chroma plane [(H+1)//2, (W+1)//2] -> [H, W] as ``EmitFancyRGB``
    drives the line-pair upsampler."""
    ch = c.shape[0]
    r = np.arange(height)
    near = np.where(r & 1, (r - 1) >> 1, r >> 1)
    far = np.where(r & 1, np.minimum((r + 1) >> 1, ch - 1), np.maximum((r >> 1) - 1, 0))
    far[0] = 0
    return _upsample_rows(c[near], c[far], width)


def _clip8(v: np.ndarray) -> np.ndarray:
    return np.where((v & ~16383) == 0, v >> 6, np.where(v < 0, 0, 255))


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Y [H, W], U and V [(H+1)//2, (W+1)//2] uint8 -> RGB [H, W, 3] uint8."""
    h, w = y.shape
    uu, vv = _upsample(u, h, w), _upsample(v, h, w)
    yy = (y.astype(np.int32) * 19077) >> 8
    r = _clip8(yy + ((vv * 26149) >> 8) - 14234)
    g = _clip8(yy - ((uu * 6419) >> 8) - ((vv * 13320) >> 8) + 8708)
    b = _clip8(yy + ((uu * 33050) >> 8) - 17685)
    return np.stack([r, g, b], axis=2).astype(np.uint8)
