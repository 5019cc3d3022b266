"""The port's WebP decoder (dynamo_tpu_torch/multimodal/{webp,vp8,yuv,vp8l,
webp_alpha}.py) held against Pillow 12.1 / libwebp 1.6 on the CPU, bit for
bit, and its ``preprocess_image`` and ``sample_video_frames`` against the
JAX package's on the same bytes:

- lossy stills (VP8) at 1 to 70 pixels a side, odd sizes included, at
  qualities 0 to 100 and methods 0 to 6, opaque and with an ``ALPH`` plane
  (``alpha_quality`` varied: raw and lossless alpha, each filter);
- the simple loop filter, sharpness, the loop-filter deltas and 2, 4 and
  8 token partitions, which Pillow cannot ask libwebp to write: a
  Pillow-written frame re-encoded with this file's VP8 boolean encoder,
  its filter header or partition count changed, and what libwebp decodes
  from that stream;
- lossless stills (VP8L) with ``exact`` on and off, palette-sized images
  (colour indexing with 1, 2, 4 and 8 bits per pixel), noise;
- animations: Pillow-written ones (``minimize_size``, ``kmin``/``kmax``,
  mixed lossy and lossless) and hand-muxed ones with random offsets,
  durations, blend and dispose bits, frames that reach the canvas edge;
- ``info``: ``icc_profile``, ``exif``, ``xmp``, ``loop`` and ``background``;
  the PNG Pillow writes for a frame has no ``eXIf``;
- malformed files: truncated or corrupt containers and bitstreams raise
  the reference's ``ValueError("undecodable image bytes: ...")`` where
  Pillow raises and decode to Pillow's pixels where it does not; a
  bomb-sized canvas is refused before anything is decoded.
"""

import io
import struct
import warnings

import numpy as np
import pytest
from PIL import Image, features

from dynamo_tpu.multimodal import encoder as jenc
from dynamo_tpu.multimodal import vit as jvit
from dynamo_tpu_torch.multimodal import encoder, image, vp8
from dynamo_tpu_torch.multimodal.webp import WebPReader

pytestmark = pytest.mark.filterwarnings("ignore")


def test_versions():
    import PIL

    assert PIL.__version__ == "12.1.0" and features.version("webp") == "1.6.0"


def _content(h: int, w: int, seed: int, alpha: str = "grad") -> np.ndarray:
    """RGBA: smooth gradients with seeded noise; alpha a gradient, binary
    (mostly 0 or 255) or opaque."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:h, :w]
    px = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                   ((x + y) * 7 + 30 * seed) % 256, (x * 3 + y * 5 + seed) % 256], -1)
    px = px + rng.integers(-30, 30, px.shape)
    if alpha == "binary":
        px[..., 3] = np.where(rng.random((h, w)) < 0.3, 0, 255)
    elif alpha == "opaque":
        px[..., 3] = 255
    return np.clip(px, 0, 255).astype(np.uint8)


def _webp(px: np.ndarray, mode: str = "RGBA", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(px[..., :3] if mode == "RGB" else px, mode).save(buf, "WEBP", **kw)
    return buf.getvalue()


def _pillow_frames(data: bytes) -> list[np.ndarray]:
    im = Image.open(io.BytesIO(data))
    out = []
    for k in range(getattr(im, "n_frames", 1)):
        im.seek(k)
        out.append(np.asarray(im.convert("RGB")))
    return out


def _assert_webp(data: bytes, label="") -> None:
    want = _pillow_frames(data)
    reader = WebPReader(data)
    assert reader.n_frames == len(want) == image.frame_count(data), label
    got = list(reader.frames(range(len(want))))
    assert [k for k, _ in got] == list(range(len(want)))
    for (k, g), w in zip(got, want):
        assert g.dtype == np.uint8 and np.array_equal(g, w), (label, k)
    assert np.array_equal(image.decode_image(data)[0], want[0]), label


def _outcome(fn):
    """('ok', value) or ('error', the exception's class)."""
    try:
        return "ok", fn()
    except Exception as e:  # noqa: BLE001
        return "error", type(e)


def _chunks(data: bytes) -> list[tuple[bytes, bytes]]:
    out, pos = [], 12
    while pos + 8 <= len(data):
        tag, n = data[pos: pos + 4], struct.unpack("<I", data[pos + 4: pos + 8])[0]
        out.append((tag, data[pos + 8: pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def _chunk(tag: bytes, body: bytes) -> bytes:
    return tag + struct.pack("<I", len(body)) + body + b"\0" * (len(body) & 1)


def _riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


# ------------------------------------------------------------------ lossy


LOSSY = [(16, 16, 80, 4), (1, 1, 50, 0), (1, 70, 5, 6), (70, 1, 100, 3), (17, 33, 10, 6),
         (70, 45, 100, 2), (64, 64, 0, 3), (37, 70, 90, 1), (2, 3, 60, 5), (31, 16, 25, 4),
         (15, 17, 95, 6), (48, 33, 40, 0)]


@pytest.mark.parametrize("h,w,q,m", LOSSY)
def test_lossy_opaque(h, w, q, m):
    """Odd sizes (chroma rounding at the edges, the above-right samples of
    the last column and row), every method, qualities 0 to 100."""
    for kind in ("grad", "noise"):
        px = _content(h, w, h * w + q, "opaque")
        if kind == "noise":
            px = np.random.default_rng(q).integers(0, 256, px.shape, dtype=np.uint8)
        _assert_webp(_webp(px, "RGB", quality=q, method=m), (h, w, q, m, kind))


@pytest.mark.parametrize("h,w,q,m", LOSSY[:8])
def test_lossy_with_alpha(h, w, q, m):
    """ALPH: alpha_quality 100 (lossless alpha), lower ones (levels
    pre-processing), 0; gradients and binary alpha (filters chosen per
    image by the encoder's method)."""
    for aq, al in ((100, "grad"), (60, "binary"), (30, "grad"), (0, "binary")):
        px = _content(h, w, h + w + aq, al)
        _assert_webp(_webp(px, quality=q, method=m, alpha_quality=aq), (h, w, q, m, aq))


def test_lossy_alpha_filters_and_raw_alpha():
    """Each alpha filter (horizontal, vertical, gradient) and raw alpha,
    written by hand into the ALPH chunk of a Pillow-written lossy frame."""
    h, w = 23, 29
    px = _content(h, w, 5, "grad")
    base = _webp(px, quality=70, alpha_quality=100)
    vp8x, *rest = _chunks(base)
    assert vp8x[0] == b"VP8X" and rest[0][0] == b"ALPH" and rest[1][0] == b"VP8 "
    a = px[..., 3].astype(np.int32)
    for kind in range(4):
        d = a.copy()
        if kind == 1:  # horizontal: from the left, column 0 from above
            d[:, 1:] = a[:, 1:] - a[:, :-1]
            d[1:, 0] = a[1:, 0] - a[:-1, 0]
        elif kind == 2:  # vertical: from above, row 0 from the left
            d[1:] = a[1:] - a[:-1]
            d[0, 1:] = a[0, 1:] - a[0, :-1]
        elif kind == 3:  # gradient
            pred = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
            d[1:, 1:] = a[1:, 1:] - pred
            d[1:, 0] = a[1:, 0] - a[:-1, 0]
            d[0, 1:] = a[0, 1:] - a[0, :-1]
        alph = bytes([kind << 2]) + (d & 255).astype(np.uint8).tobytes()
        data = _riff(_chunk(b"VP8X", vp8x[1]), _chunk(b"ALPH", alph), _chunk(b"VP8 ", rest[1][1]))
        _assert_webp(data, kind)
        assert np.array_equal(np.asarray(Image.open(io.BytesIO(data)))[..., 3], px[..., 3])


def _risk(case: str) -> bytes:
    rng = np.random.default_rng(len(case))
    if case == "chroma rounding at odd edges":
        return _webp(_content(33, 17, 1, "opaque"), "RGB", quality=90)
    if case == "above-right samples, right column and bottom row":
        # noise at high quality: 4x4 prediction in every macroblock, the
        # last column and row included (48 = 3 macroblocks, 40 cuts one)
        px = rng.integers(0, 256, (40, 48, 4), dtype=np.uint8)
        return _webp(px, "RGB", quality=95, method=6)
    if case == "clip8 of negative values":
        px = np.zeros((24, 24, 4), np.uint8)  # saturated primaries
        px[:, :8, 0] = px[:, 8:16, 1] = px[:, 16:, 2] = 255
        px[::2, :, :3] = 255 - px[::2, :, :3]
        return _webp(px, "RGB", quality=30)
    if case == "loop filter order within a macroblock":
        return _webp(rng.integers(0, 256, (32, 32, 4), dtype=np.uint8), "RGB", quality=3)
    if case == "colour-indexed width not a multiple of the bundle":
        pal = rng.integers(0, 256, (3, 4), dtype=np.uint8)
        return _webp(pal[rng.integers(0, 3, (5, 13))], lossless=True)
    if case == "overlapping LZ77 copies":
        row = rng.integers(0, 256, (1, 3, 4), dtype=np.uint8)
        return _webp(np.tile(row, (9, 11, 1)), lossless=True, quality=100)
    return _muxed(rng, 4, 21, 15, edge=True)  # a frame at the canvas edge


RISKS = ["chroma rounding at odd edges", "above-right samples, right column and bottom row",
         "clip8 of negative values", "loop filter order within a macroblock",
         "colour-indexed width not a multiple of the bundle", "overlapping LZ77 copies",
         "an animation frame reaching the canvas edge"]


@pytest.mark.parametrize("case", RISKS)
def test_bit_equality_risks(case):
    """Where bit-equality with libwebp breaks first, one named file each."""
    _assert_webp(_risk(case), case)


# ------------------------------------------------- a VP8 boolean encoder


class _BoolEncoder:
    """RFC 6386 section 7.3's boolean encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, prob: int, bit: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append(self.bottom >> 24)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def flush(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append(v >> 24)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _partition0_decisions(payload: bytes, monkeypatch) -> tuple[list, int]:
    """Every (probability, bit) the decoder reads from a frame's first
    partition, and the index of the filter header's ``simple`` bit."""
    log: list = []
    calls: list = []

    class Recording(vp8._Bits):
        def __init__(self, data, start, end):
            super().__init__(data, start, end)
            self.first = start == 10

        def get(self, p):
            b = super().get(p)
            if self.first:
                log.append((p, b))
            return b

        def value_of(self, n):
            if self.first:
                calls.append((n, len(log)))
            return super().value_of(n)

    with monkeypatch.context() as m:
        m.setattr(vp8, "_Bits", Recording)
        vp8.decode_vp8(payload)
    # the filter level (6 bits) read right before the sharpness (3 bits)
    k = next(i for i in range(len(calls) - 1)
             if calls[i][0] == 6 and calls[i + 1] == (3, calls[i][1] + 6))
    return log, calls[k][1] - 1


def _reencode(payload: bytes, monkeypatch, simple=None, sharpness=None, level=None,
              lf_delta=None) -> bytes:
    """The frame with its first partition re-encoded, the filter header's
    fields replaced (``lf_delta``: (ref deltas, mode deltas) of 4 each)."""
    log, at = _partition0_decisions(payload, monkeypatch)
    bits = [b for _, b in log]
    head = log[:at]
    old = bits[at: at + 11]  # simple, level, sharpness, use_lf_delta
    assert old[10] == 0, "libwebp writes no loop-filter deltas"
    simple = old[0] if simple is None else simple
    level = int("".join(map(str, old[1:7])), 2) if level is None else level
    sharpness = int("".join(map(str, old[7:10])), 2) if sharpness is None else sharpness
    mid = [simple] + [(level >> (5 - i)) & 1 for i in range(6)] + [
        (sharpness >> (2 - i)) & 1 for i in range(3)]
    if lf_delta is None:
        mid.append(0)
    else:
        mid += [1, 1]
        for d in lf_delta[0] + lf_delta[1]:
            if d is None:
                mid.append(0)
            else:
                mid += [1] + [(abs(d) >> (5 - i)) & 1 for i in range(6)] + [int(d < 0)]
    enc = _BoolEncoder()
    for p, b in head:
        enc.put(p, b)
    for b in mid:
        enc.put(128, b)
    for p, b in log[at + 11:]:
        enc.put(p, b)
    part0 = enc.flush()
    tag = int.from_bytes(payload[:3], "little")
    old_len = tag >> 5
    tag = (tag & 31) | (len(part0) << 5)
    return tag.to_bytes(3, "little") + payload[3:10] + part0 + payload[10 + old_len:]


@pytest.mark.parametrize("case", ["simple", "simple sharp", "normal sharp 3",
                                  "normal sharp 7", "deltas", "simple deltas", "level 0"])
def test_loop_filters_rewritten(case, monkeypatch):
    """The simple filter (luma only, 2 taps), sharpness 1 to 7 (the
    interior limit), filter levels up to 63 (``hev`` thresholds 1 and 2)
    and loop-filter deltas (reference and 4x4 mode), on frames Pillow wrote
    and this file re-encoded; libwebp decodes the rewritten stream."""
    for seed, (h, w, q) in enumerate(((40, 52, 30), (33, 17, 5), (64, 48, 75))):
        px = _content(h, w, seed, "opaque")
        payload = dict(_chunks(_webp(px, "RGB", quality=q, method=4)))[b"VP8 "]
        kw = {"simple": dict(simple=1, level=20), "simple sharp": dict(simple=1, sharpness=5),
              "normal sharp 3": dict(simple=0, sharpness=3, level=45),
              "normal sharp 7": dict(simple=0, sharpness=7, level=63),
              "deltas": dict(lf_delta=((5, None, None, None), (-9, None, None, None))),
              "simple deltas": dict(simple=1, lf_delta=((-3, None, 2, None), (12, 1, None, None))),
              "level 0": dict(level=0, lf_delta=((9, None, None, None), (9, None, None, None)))}
        data = _riff(_chunk(b"VP8 ", _reencode(payload, monkeypatch, **kw[case])))
        _assert_webp(data, (case, seed))


def _repartition(payload: bytes, monkeypatch, n: int) -> bytes:
    """The frame with its tokens re-encoded into ``n`` partitions (row y in
    partition y mod n) and its first partition's partition count changed,
    through the boolean encoder: every decision is recorded with the
    macroblock whose ``_coeffs`` call read it."""
    first: list = []
    calls: list = []
    tokens: list = []  # (macroblock, probability, bit)
    current = [0]
    mb_w = ((int.from_bytes(payload[6:8], "little") & 0x3FFF) + 15) >> 4

    class Recording(vp8._Bits):
        def __init__(self, data, start, end):
            super().__init__(data, start, end)
            self.first = start == 10

        def get(self, p):
            b = super().get(p)
            if self.first:
                first.append((p, b))
            else:
                tokens.append((current[0], p, b))
            return b

        def signed(self, v):
            r = super().signed(v)
            tokens.append((current[0], 128, int(r < 0)))
            return r

        def value_of(self, k):
            if self.first:
                calls.append((k, len(first)))
            return super().value_of(k)

    real = vp8._coeffs

    def coeffs(br, prob, ctx, dq, k, out, base):
        # the Y2 block (its own 16-entry list) belongs to the next block's
        # macroblock, read right after it
        current[0] = base // 384 if len(out) > 16 else -1
        return real(br, prob, ctx, dq, k, out, base)

    with monkeypatch.context() as m:
        m.setattr(vp8, "_Bits", Recording)
        m.setattr(vp8, "_coeffs", coeffs)
        vp8.decode_vp8(payload)
    # a Y2 block's decisions (macroblock -1) go to the macroblock after them
    owner = None
    for i in range(len(tokens) - 1, -1, -1):
        mb, p, b = tokens[i]
        if mb >= 0:
            owner = mb
        else:
            tokens[i] = (owner, p, b)
    k = next(i for i in range(len(calls) - 1)
             if calls[i][0] == 6 and calls[i + 1] == (3, calls[i][1] + 6))
    at = next(c[1] for c in calls[k + 2:] if c[0] == 2)  # the partition count
    v = n.bit_length() - 1  # log2 of the partition count, 2 bits MSB first
    log = first[:at] + [(128, v >> 1), (128, v & 1)]
    log += first[at + 2:]
    enc = _BoolEncoder()
    for p, b in log:
        enc.put(p, b)
    part0 = enc.flush()
    parts = [_BoolEncoder() for _ in range(n)]
    for mb, p, b in tokens:
        parts[(mb // mb_w) % n].put(p, b)
    data = [e.flush() for e in parts]
    tag = (int.from_bytes(payload[:3], "little") & 31) | (len(part0) << 5)
    sizes = b"".join(len(d).to_bytes(3, "little") for d in data[:-1])
    return tag.to_bytes(3, "little") + payload[3:10] + part0 + sizes + b"".join(data)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_token_partitions_rewritten(n, monkeypatch):
    """Token partitions (libwebp writes one; Pillow cannot ask for more):
    a frame's rows re-encoded into 1, 2, 4 or 8 partitions, each row in
    partition ``y mod n``, and what libwebp decodes from that stream."""
    for seed, (h, w, q) in enumerate(((72, 40, 60), (40, 33, 20))):
        px = _content(h, w, seed, "opaque")
        data = _webp(px, "RGB", quality=q)
        payload = dict(_chunks(data))[b"VP8 "]
        rewritten = _repartition(payload, monkeypatch, n)
        assert len(vp8._parse_header(rewritten)[0].parts) == n
        again = _riff(_chunk(b"VP8 ", rewritten))
        assert np.array_equal(_pillow_frames(again)[0], _pillow_frames(data)[0])
        _assert_webp(again, (n, seed))


def test_bool_encoder_round_trip(monkeypatch):
    """The re-encoding alone changes no pixel."""
    px = _content(30, 20, 3, "opaque")
    data = _webp(px, "RGB", quality=55)
    payload = dict(_chunks(data))[b"VP8 "]
    again = _riff(_chunk(b"VP8 ", _reencode(payload, monkeypatch)))
    assert np.array_equal(_pillow_frames(again)[0], _pillow_frames(data)[0])
    _assert_webp(again)


# --------------------------------------------------------------- lossless


@pytest.mark.parametrize("h,w", [(1, 1), (2, 3), (16, 16), (17, 33), (70, 45), (5, 70),
                                 (64, 1), (33, 9)])
def test_lossless(h, w):
    """Predictor (every mode the encoder picks), cross-colour and
    subtract-green transforms, colour cache, LZ77 (overlapping copies on
    repeats), meta prefix codes; ``exact`` on and off (off rewrites the
    colour under alpha 0)."""
    for exact in (False, True):
        for al in ("grad", "binary"):
            px = _content(h, w, h * 7 + w, al)
            _assert_webp(_webp(px, lossless=True, exact=exact, quality=100, method=5),
                         (h, w, exact, al))
    noise = np.random.default_rng(h + w).integers(0, 256, (h, w, 4), dtype=np.uint8)
    _assert_webp(_webp(noise, lossless=True, quality=30, method=1), (h, w, "noise"))
    rep = np.tile(_content(2, 3, 1, "opaque"), (h // 2 + 1, w // 3 + 1, 1))[:h, :w]
    _assert_webp(_webp(rep, lossless=True, quality=0, method=0), (h, w, "repeats"))


@pytest.mark.parametrize("colours", [2, 3, 4, 11, 16, 17, 200])
def test_lossless_palettes(colours):
    """Colour indexing: 8, 4, 2 and 1 pixels per bundle, widths that are
    not a multiple of the bundle."""
    rng = np.random.default_rng(colours)
    pal = rng.integers(0, 256, (colours, 4), dtype=np.uint8)
    pal[:, 3] = rng.choice([0, 128, 255], colours)
    for h, w in ((1, 1), (7, 13), (20, 37), (9, 70)):
        px = pal[rng.integers(0, colours, (h, w))]
        _assert_webp(_webp(px, lossless=True, method=int(rng.integers(0, 7))), (colours, h, w))


# -------------------------------------------------------------- animation


def _pillow_animation(rng, case: int) -> bytes:
    w, h = int(rng.integers(8, 60)), int(rng.integers(8, 60))
    frames = [Image.fromarray(_content(h, w, 10 * case + k, ("grad", "binary", "opaque")[k % 3]),
                              "RGBA") for k in range(int(rng.integers(2, 6)))]
    kw = dict(save_all=True, append_images=frames[1:],
              duration=[int(d) for d in rng.integers(10, 100, len(frames))],
              lossless=bool(case & 1), minimize_size=bool(case & 2), allow_mixed=bool(case & 4),
              loop=int(rng.integers(0, 4)),
              background=tuple(int(v) for v in rng.integers(0, 256, 4)))
    if case & 2:
        kw.update(kmin=1, kmax=int(rng.integers(2, 5)))
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("case", range(8))
def test_pillow_animations(case):
    """Lossy, lossless and mixed; ``minimize_size`` (sub-rectangles, blend
    and dispose chosen by libwebp's encoder); key frames by ``kmin``/``kmax``."""
    data = _pillow_animation(np.random.default_rng(case), case)
    _assert_webp(data, case)
    want = Image.open(io.BytesIO(data)).info
    info = WebPReader(data).info
    assert info["loop"] == want["loop"] and info["background"] == want["background"]


def _still_parts(px: np.ndarray, rng) -> list[bytes]:
    """The chunks of one Pillow-written still (ALPH + VP8, VP8, or VP8L)."""
    kind = int(rng.integers(0, 3))
    if kind == 0:
        data = _webp(px, quality=int(rng.integers(0, 101)), alpha_quality=int(rng.integers(0, 101)))
    elif kind == 1:
        data = _webp(px, "RGB", quality=int(rng.integers(0, 101)))
    else:
        data = _webp(px, lossless=True, exact=bool(rng.integers(0, 2)))
    return [_chunk(t, b) for t, b in _chunks(data) if t in (b"ALPH", b"VP8 ", b"VP8L")]


def _muxed(rng, n: int, W: int, H: int, edge: bool = False) -> bytes:
    """An animation muxed by hand: random frame sizes and even offsets
    (some reaching the canvas edge), durations, blend and dispose bits."""
    chunks = [_chunk(b"ANIM", struct.pack("<IH", int(rng.integers(0, 1 << 32)),
                                          int(rng.integers(0, 5))))]
    for k in range(n):
        fw, fh = int(rng.integers(1, W + 1)), int(rng.integers(1, H + 1))
        x = int(rng.integers(0, (W - fw) // 2 + 1)) * 2
        y = int(rng.integers(0, (H - fh) // 2 + 1)) * 2
        if edge and k % 2:  # out to the right and bottom edges
            x, y = (W - fw) // 2 * 2, (H - fh) // 2 * 2
            fw, fh = W - x, H - y
        flags = int(rng.integers(0, 4))
        px = _content(fh, fw, int(rng.integers(0, 1000)), ("grad", "binary", "opaque")[k % 3])
        body = (struct.pack("<I", x // 2)[:3] + struct.pack("<I", y // 2)[:3]
                + struct.pack("<I", fw - 1)[:3] + struct.pack("<I", fh - 1)[:3]
                + struct.pack("<I", int(rng.integers(0, 200)))[:3] + bytes([flags])
                + b"".join(_still_parts(px, rng)))
        chunks.append(_chunk(b"ANMF", body))
    vp8x = bytes([0x12]) + bytes(3) + struct.pack("<I", W - 1)[:3] + struct.pack("<I", H - 1)[:3]
    return _riff(_chunk(b"VP8X", vp8x), *chunks)


@pytest.mark.parametrize("seed", range(12))
def test_muxed_animations(seed):
    """Blend over a disposed rectangle (libwebp leaves the previous
    frame's rectangle unblended), dispose to background, key frames,
    frames that reach the canvas edge, 1-pixel frames."""
    rng = np.random.default_rng(100 + seed)
    W, H = int(rng.integers(1, 48)), int(rng.integers(1, 48))
    data = _muxed(rng, int(rng.integers(2, 7)), W, H, edge=bool(seed % 2))
    _assert_webp(data, seed)


@pytest.mark.parametrize("n", [1, 2, 8])
def test_video_frames_and_preprocess_equal_the_reference(n):
    rng = np.random.default_rng(n)
    for data in (_pillow_animation(rng, 5), _muxed(rng, 5, 40, 30),
                 _webp(_content(45, 60, 2), quality=80)):
        assert encoder.sample_video_frames(data, n) == jenc.sample_video_frames(data, n)
        for size in (28, 64):
            assert np.array_equal(image.preprocess_image(data, size),
                                  jvit.preprocess_image(data, size))


def test_sampling_decodes_only_up_to_the_last_index(monkeypatch):
    """Frames past the largest index asked for are never decoded."""
    data = _muxed(np.random.default_rng(7), 6, 20, 20)
    decoded = []
    real = WebPReader._decode_frame

    def spy(self, f):
        decoded.append(f)
        return real(self, f)

    monkeypatch.setattr(WebPReader, "_decode_frame", spy)
    assert [k for k, _ in WebPReader(data).frames([2, 0])] == [0, 2] and len(decoded) == 3


# ------------------------------------------------------------------- info


def test_info_icc_exif_xmp():
    """ICCP, EXIF and XMP chunks as Pillow's info holds them, and the PNG a
    frame re-encodes to (iCCP kept, no eXIf)."""
    px = _content(20, 24, 1)
    icc = bytes(range(256)) * 3
    exif = b"Exif\x00\x00MM\x00*\x00\x00\x00\x08\x00\x00"
    xmp = b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"
    for kw in (dict(icc_profile=icc), dict(exif=exif), dict(xmp=xmp),
               dict(icc_profile=icc, exif=exif, xmp=xmp)):
        for lossless in (False, True):
            data = _webp(px, lossless=lossless, **kw)
            want = Image.open(io.BytesIO(data)).info
            got = image.decode_image(data)[1]
            for key in ("icc_profile", "exif", "xmp", "loop", "background"):
                assert got.get(key) == want.get(key), (key, kw.keys())
            assert encoder.sample_video_frames(data, 2) == jenc.sample_video_frames(data, 2)
            png = encoder.sample_video_frames(data, 1)[0]
            assert b"eXIf" not in png and (b"iCCP" in png) == ("icc_profile" in kw)


def test_chunks_ignored_without_their_flag():
    """An ICCP chunk without the VP8X ICC flag is not Pillow's icc_profile."""
    data = _webp(_content(8, 8, 0), icc_profile=b"profile" * 20)
    vp8x, *rest = _chunks(data)
    flags = bytes([vp8x[1][0] & ~0x20]) + vp8x[1][1:]
    data = _riff(_chunk(b"VP8X", flags), *[_chunk(t, b) for t, b in rest])
    assert "icc_profile" not in Image.open(io.BytesIO(data)).info
    assert "icc_profile" not in image.decode_image(data)[1]
    _assert_webp(data)


# -------------------------------------------------------------- malformed


def _same_outcome(data: bytes, label) -> str:
    """Where Pillow raises (at open, frame 0 or a later frame) the port
    raises ValueError("undecodable image bytes: ..."); where it decodes,
    the port gives its frames."""
    first = _outcome(lambda: np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    if first[0] == "error":
        with pytest.raises(ValueError, match="^undecodable image bytes: "):
            image.decode_image(data)
    else:
        assert np.array_equal(image.decode_image(data)[0], first[1]), label
    every = _outcome(lambda: _pillow_frames(data))
    if every[0] == "error":
        with pytest.raises(ValueError, match="^undecodable image bytes: "):
            reader = WebPReader(data)
            list(reader.frames(range(reader.n_frames)))
        return "error"
    reader = WebPReader(data)
    got = [g for _, g in reader.frames(range(reader.n_frames))]
    assert len(got) == len(every[1]) and all(
        np.array_equal(g, w) for g, w in zip(got, every[1])), label
    return "ok"


@pytest.mark.parametrize("kind", ["lossy", "alpha", "lossless", "animation"])
def test_truncated_files(kind):
    rng = np.random.default_rng(len(kind))
    px = _content(24, 30, 9, "grad")
    data = {"lossy": _webp(px, "RGB", quality=60), "alpha": _webp(px, quality=60),
            "lossless": _webp(px, lossless=True),
            "animation": _pillow_animation(rng, 3)}[kind]
    for cut in sorted({1, 12, 19, 20, 21, 29, 30, *rng.integers(20, len(data), 12).tolist(),
                       len(data) - 1}):
        _same_outcome(data[:cut], (kind, cut))


def _with_payload(data: bytes, tag: bytes, new: bytes) -> bytes:
    """The file with one chunk's payload replaced and every size fixed."""
    out = []
    for t, b in _chunks(data):
        out.append(_chunk(t, new if t == tag else b))
    return _riff(*out)


@pytest.mark.parametrize("tag", [b"VP8 ", b"VP8L", b"ALPH"])
def test_truncated_and_corrupt_bitstreams(tag):
    """Bitstreams cut short inside a valid container (libwebp's end of
    partition and end of stream) and with bytes overwritten: the port
    fails where libwebp fails and gives its pixels where it decodes."""
    rng = np.random.default_rng(tag[3])
    px = _content(26, 34, 4, "grad")
    data = (_webp(px, "RGB", quality=70) if tag == b"VP8 "
            else _webp(px, lossless=True) if tag == b"VP8L" else _webp(px, quality=70))
    payload = dict(_chunks(data))[tag]
    seen = set()
    for cut in sorted({0, 1, 4, 5, 9, 10, 11, len(payload) - 1, len(payload) - 2,
                       *rng.integers(1, len(payload), 10).tolist()}):
        seen.add(_same_outcome(_with_payload(data, tag, payload[:cut]), (tag, cut)))
    for _ in range(25):
        b = bytearray(payload)
        for i in rng.integers(1 if tag == b"ALPH" else 10, len(b), int(rng.integers(1, 4))):
            b[i] = int(rng.integers(0, 256))
        seen.add(_same_outcome(_with_payload(data, tag, bytes(b)), (tag, "corrupt")))
    assert "error" in seen


def test_container_errors_and_bomb():
    """Not WebP to Pillow (cannot identify), a RIFF size past the data, a
    VP8X still whose canvas is not its frame's, an unknown VP8X flag, a
    VP8X chunk of another size than 10, data past the RIFF size; a 16384 x
    16384 canvas is refused unread."""
    px = _content(10, 12, 2)
    good = _webp(px, quality=50)
    vp8x, *rest = _chunks(good)
    cases = {
        "riff size": good[:4] + struct.pack("<I", len(good)) + good[8:],
        "canvas": _riff(_chunk(b"VP8X", vp8x[1][:4] + struct.pack("<I", 12)[:3] + vp8x[1][7:]),
                        *[_chunk(t, b) for t, b in rest]),
        "flag": _riff(_chunk(b"VP8X", bytes([vp8x[1][0] | 1]) + vp8x[1][1:]),
                      *[_chunk(t, b) for t, b in rest]),
        "odd chunk": good + b"\x00" * 3,
        "vp8x of 12 bytes": _riff(_chunk(b"VP8X", vp8x[1] + bytes(2)),
                                  *[_chunk(t, b) for t, b in rest]),
    }
    for name, data in cases.items():
        _same_outcome(data, name)
    for bad in (b"RIFF\x10\x00\x00\x00WEBPVP8Q" + bytes(8), b"RIFF" + bytes(20)):
        with pytest.raises(ValueError, match="^undecodable image bytes: cannot identify"):
            image.decode_image(bad)
    frame = (bytes(6) + struct.pack("<I", 11)[:3] + struct.pack("<I", 9)[:3] + bytes(4)
             + b"".join(_chunk(t, b) for t, b in rest))
    big = _riff(_chunk(b"VP8X", bytes([0x12, 0, 0, 0]) + struct.pack("<I", 16383)[:3] * 2),
                _chunk(b"ANIM", bytes(6)), _chunk(b"ANMF", frame))
    with pytest.raises(Exception):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            Image.open(io.BytesIO(big))
    with pytest.raises(ValueError, match="decompression bomb"):
        image.decode_image(big)
    with pytest.raises(ValueError, match="decompression bomb"):
        encoder.sample_video_frames(big, 2)
