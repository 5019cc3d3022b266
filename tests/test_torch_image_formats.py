"""The port's JPEG and GIF decoders, its PNG encoder and its video frame
sampler (dynamo_tpu_torch/multimodal/{jpeg,gif,image,encoder}.py) held
against Pillow and the JAX package on the CPU, bit for bit:

- ``decode_jpeg``: the pixels of Pillow's ``convert("RGB")`` for 4:4:4,
  4:2:2, 4:2:0 and 4:4:0 (a 4:2:2 file with its sampling factors and size
  transposed), baseline and progressive, ``optimize`` on and off, qualities
  50, 95 and 100, grey, restart markers, ICC profiles (Pillow's
  ``info["icc_profile"]``), an RGB-colour-space file, at 1x1, 2x2, 3x17,
  17x3 and 333x251 among others; the variants left unported and corrupt
  files raise ValueError;
- ``GifReader``: ``n_frames``, and each frame's pixels and transparency as
  ``seek(k).convert("RGB")`` gives them, for Pillow-written animations and
  for GIFs from this file's own writer (disposal 3, local tables,
  interlace, frames past the canvas, a late clear code) and a seeded set of
  random ones;
- ``encode_png``: the bytes of Pillow's ``save(format="PNG")``;
- ``sample_video_frames``: the reference's list of bytes;
- ``preprocess_image`` of JPEG and GIF: the reference's f32 arrays;
- the committed fixtures (``tests/torch_mm_fixtures``: JPEG, GIF, WebP,
  APNG and MPO) and their manifest, which ``chip_smoke.py`` reads on the
  GPU machine; ``write_fixtures`` below made them.
"""

import hashlib
import io
import json
import struct
import warnings
import zlib
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile, features

from dynamo_tpu.multimodal import encoder as jenc
from dynamo_tpu.multimodal import vit as jvit
from dynamo_tpu_torch.multimodal import encoder, image
from dynamo_tpu_torch.multimodal.gif import GifReader
from dynamo_tpu_torch.multimodal.jpeg import decode_jpeg

FIXTURES = Path(__file__).parent / "torch_mm_fixtures"
# the GIF fixture's sampled frames: the encode worker's default
FIXTURE_FRAMES = 8

pytestmark = pytest.mark.filterwarnings("ignore")


def _content(h: int, w: int, kind: str, seed: int = 0) -> np.ndarray:
    if kind == "noise":
        return np.random.default_rng(seed + h * 31 + w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    y, x = np.mgrid[:h, :w]
    return np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                     ((x + y + seed) * 3) % 256], axis=-1).astype(np.uint8)


def _save(px: np.ndarray, fmt: str, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    block = ImageFile.MAXBLOCK
    if fmt == "JPEG":
        # Pillow's optimized and progressive writes of noise at quality 100
        # outgrow its default buffer (its PNG chunks are this size: kept)
        ImageFile.MAXBLOCK = 1 << 24
    try:
        Image.fromarray(px).convert(mode).save(buf, fmt, **kw)
    finally:
        ImageFile.MAXBLOCK = block
    return buf.getvalue()


def _pillow_rgb(data: bytes) -> tuple[np.ndarray, dict]:
    im = Image.open(io.BytesIO(data))
    rgb = im.convert("RGB")
    return np.asarray(rgb), rgb.info


def _assert_jpeg(data: bytes, label) -> None:
    want, info = _pillow_rgb(data)
    got, got_info = decode_jpeg(data)
    assert got.dtype == np.uint8 and np.array_equal(got, want), label
    assert got_info.get("icc_profile", "none") == info.get("icc_profile", "none"), label


def _as_440(data: bytes) -> bytes:
    """A 4:2:2 JPEG relabelled 4:4:0: luma's sampling factors and the image
    size transposed. The scan data stays valid (the same blocks per MCU and
    MCUs), so it decodes, to other pixels."""
    i = next(i for i in range(len(data) - 1)
             if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC2))
    b = bytearray(data)
    h, w = struct.unpack(">HH", data[i + 5: i + 9])
    b[i + 5: i + 9] = struct.pack(">HH", w, h)
    assert b[i + 11] == 0x21
    b[i + 11] = 0x12
    return bytes(b)


SIZES = ((1, 1), (2, 2), (3, 17), (17, 3), (48, 64))
SAMPLING = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "4:4:0": 1}


# ------------------------------------------------------------------ JPEG


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_matches_pillow(sampling, progressive, optimize):
    """Every size, smooth content and noise, at qualities 50, 95 and 100."""
    for h, w in SIZES:
        for kind in ("smooth", "noise"):
            px = _content(w, h, kind) if sampling == "4:4:0" else _content(h, w, kind)
            for q in (50, 95, 100):
                data = _save(px, "JPEG", quality=q, subsampling=SAMPLING[sampling],
                             progressive=progressive, optimize=optimize)
                if sampling == "4:4:0":
                    data = _as_440(data)
                _assert_jpeg(data, (h, w, kind, q))


@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_jpeg_odd_size_partial_mcus(sampling):
    """333x251: partial MCUs on both edges, baseline and progressive."""
    h, w = (333, 251) if sampling == "4:4:0" else (251, 333)
    for progressive in (False, True):
        data = _save(_content(h, w, "smooth", 5), "JPEG", quality=90,
                     subsampling=SAMPLING[sampling], progressive=progressive)
        _assert_jpeg(_as_440(data) if sampling == "4:4:0" else data, progressive)


@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_grey(progressive):
    for h, w in SIZES + ((251, 333),):
        for kind in ("smooth", "noise"):
            data = _save(_content(h, w, kind), "JPEG", "L", quality=85,
                         progressive=progressive)
            _assert_jpeg(data, (h, w, kind))


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("restart", [dict(restart_marker_blocks=1),
                                     dict(restart_marker_blocks=3),
                                     dict(restart_marker_rows=1)])
def test_jpeg_restart_intervals(restart, progressive):
    for h, w in ((3, 17), (48, 64), (37, 53)):
        for sub in (0, 2):
            data = _save(_content(h, w, "noise"), "JPEG", quality=80, subsampling=sub,
                         progressive=progressive, **restart)
            assert b"\xff\xdd" in data
            _assert_jpeg(data, (h, w, sub))


@pytest.mark.parametrize("size", [300, 70000, 200000])
def test_jpeg_icc_profile_as_pillow_reads_it(size):
    """One APP2 segment, two, and four: assembled by sequence number."""
    icc = bytes(np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8))
    data = _save(_content(40, 56, "smooth"), "JPEG", quality=90, icc_profile=icc)
    _assert_jpeg(data, size)
    assert decode_jpeg(data)[1]["icc_profile"] == icc


def test_jpeg_icc_segments_out_of_order_or_short():
    """Pillow sorts the segments; a wrong count gives None."""
    icc = bytes(range(256)) * 400
    data = _save(_content(16, 16, "smooth"), "JPEG", icc_profile=icc)
    segs = []
    pos = 2
    while data[pos + 1] != 0xE2:
        pos += 2 + struct.unpack(">H", data[pos + 2: pos + 4])[0]
    start = pos
    while data[pos + 1] == 0xE2:
        n = struct.unpack(">H", data[pos + 2: pos + 4])[0]
        segs.append(data[pos: pos + 2 + n])
        pos += 2 + n
    assert len(segs) == 2
    for body in (segs[1] + segs[0], segs[0]):
        bad = data[:start] + body + data[pos:]
        _assert_jpeg(bad, len(body))


def test_jpeg_rgb_colour_space():
    """keep_rgb writes an Adobe marker with transform 0: no YCbCr."""
    for kind in ("noise", "smooth"):
        data = _save(_content(24, 40, kind), "JPEG", quality=90, keep_rgb=True)
        assert b"Adobe" in data
        _assert_jpeg(data, kind)


def _patched_sof(data: bytes, marker: int | None = None, precision: int | None = None,
                 size: tuple[int, int] | None = None) -> bytes:
    i = next(i for i in range(len(data) - 1)
             if data[i] == 0xFF and data[i + 1] in (0xC0, 0xC2))
    b = bytearray(data)
    if marker is not None:
        b[i + 1] = marker
    if precision is not None:
        b[i + 4] = precision
    if size is not None:
        b[i + 5: i + 9] = struct.pack(">HH", *size)
    return bytes(b)


@pytest.mark.parametrize("case", ["lossless", "hierarchical", "arithmetic", "12-bit",
                                  "CMYK", "MPO"])
def test_jpeg_variants_refused_naming_the_item(case):
    """The variants left unported raise naming their item; an MPO (ported)
    decodes as Pillow's frame 0 and preprocesses as the reference does."""
    base = _save(_content(16, 16, "smooth"), "JPEG")
    if case == "CMYK":
        data = _save(_content(16, 16, "smooth"), "JPEG", "CMYK")
        item = "item 12b-iii"
    elif case == "MPO":
        buf = io.BytesIO()
        ims = [Image.fromarray(_content(16, 16, "smooth", s)) for s in (1, 2)]
        ims[0].save(buf, "MPO", save_all=True, append_images=ims[1:])
        data = buf.getvalue()
        assert Image.open(io.BytesIO(data)).n_frames == 2 == image.frame_count(data)
        assert np.array_equal(decode_jpeg(data)[0], _pillow_rgb(data)[0])
        assert np.array_equal(image.preprocess_image(data, 28), jvit.preprocess_image(data, 28))
        return
    else:
        marker = {"lossless": 0xC3, "hierarchical": 0xC5, "arithmetic": 0xC9}.get(case)
        data = _patched_sof(base, marker=marker, precision=12 if case == "12-bit" else None)
        item = "item 12b-iii"
    with pytest.raises(ValueError, match=item):
        decode_jpeg(data)
    with pytest.raises(ValueError, match=item):
        image.preprocess_image(data, 28)


def test_jpeg_corrupt_truncated_and_bomb_raise():
    data = _save(_content(64, 64, "noise"), "JPEG", quality=90)
    sos = data.index(b"\xff\xda")
    cut = data[: sos + 400]
    flipped = bytearray(data)
    flipped[sos + 20: sos + 28] = b"\xff" * 8  # fill bytes: a marker where data was
    for bad in (cut, bytes(flipped), data[:sos], b"\xff\xd8\xff" + b"\x00" * 10):
        with pytest.raises(ValueError, match="undecodable image bytes"):
            decode_jpeg(bad)
    bomb = _patched_sof(data, size=(30000, 30000))
    with pytest.raises(ValueError, match="decompression bomb"):
        decode_jpeg(bomb)


# ------------------------------------------------------------------- GIF


def _lzw(idx: np.ndarray, min_size: int, late_clear: bool = False) -> bytes:
    """LZW codes (LSB first) of the indices, at the width the decoder reads
    each: a clear code first, the end code last; with ``late_clear`` a full
    table is not cleared (the codes go on at 12 bits)."""
    clear = 1 << min_size
    codes = []
    state = {"size": min_size + 1, "next": clear + 2, "first": True}

    def emit(c):
        codes.append((c, state["size"]))
        if c == clear:
            state.update(size=min_size + 1, next=clear + 2, first=True)
            return
        if not state["first"] and state["next"] < 4096:
            if state["next"] == (1 << state["size"]) - 1 and state["size"] < 12:
                state["size"] += 1
            state["next"] += 1
        state["first"] = False

    def fresh():
        return {bytes([i]): i for i in range(clear)}, clear + 2

    table, nxt = fresh()
    emit(clear)
    cur = b""
    for ch in np.asarray(idx, np.uint8).reshape(-1).tobytes():
        ext = cur + bytes([ch])
        if ext in table:
            cur = ext
            continue
        emit(table[cur])
        if nxt < 4096:
            table[ext] = nxt
            nxt += 1
        elif not late_clear:
            emit(clear)
            table, nxt = fresh()
        cur = bytes([ch])
    if cur:
        emit(table[cur])
    emit(clear + 1)
    acc = nbits = 0
    out = bytearray()
    for c, width in codes:
        acc |= c << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
    return bytes(out + (bytes([acc]) if nbits else b""))


def _blocks(b: bytes) -> bytes:
    return b"".join(bytes([len(b[i:i + 255])]) + b[i:i + 255]
                    for i in range(0, len(b), 255)) + b"\x00"


def write_gif(w: int, h: int, frames: list[dict], gpal=None, bg: int = 0) -> bytes:
    """A GIF89a of ``frames``: dicts with ``idx`` [fh, fw], and optionally
    ``x``, ``y``, ``lpal`` (a local table), ``disposal``, ``trans``,
    ``interlace``, ``gce`` (False: no control block), ``min_size``,
    ``late_clear`` and ``comment``."""
    def table_flags(p):
        return 0x80 | (int(np.log2(len(p))) - 1)

    out = bytearray(b"GIF89a" + struct.pack("<HHBBB", w, h,
                                            table_flags(gpal) if gpal is not None else 0, bg, 0))
    if gpal is not None:
        out += np.asarray(gpal, np.uint8).tobytes()
    out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for f in frames:
        if f.get("comment"):
            out += b"\x21\xfe" + _blocks(f["comment"])
        if f.get("gce", True):
            t = f.get("trans")
            flags = (f.get("disposal", 0) << 2) | (t is not None)
            out += b"\x21\xf9\x04" + struct.pack("<BHB", flags, 10, t or 0) + b"\x00"
        idx = np.asarray(f["idx"], np.uint8)
        fh, fw = idx.shape
        lp = f.get("lpal")
        flags = table_flags(lp) if lp is not None else 0
        if f.get("interlace"):
            flags |= 0x40
            idx = idx[np.concatenate([np.arange(0, fh, 8), np.arange(4, fh, 8),
                                      np.arange(2, fh, 4), np.arange(1, fh, 2)])]
        out += b"\x2c" + struct.pack("<HHHHB", f.get("x", 0), f.get("y", 0), fw, fh, flags)
        if lp is not None:
            out += np.asarray(lp, np.uint8).tobytes()
        ms = f.get("min_size", 8)
        out += bytes([ms]) + _blocks(_lzw(idx, ms, f.get("late_clear", False)))
    return bytes(out + b"\x3b")


def _pillow_frames(data: bytes):
    im = Image.open(io.BytesIO(data))
    n = im.n_frames
    out = []
    for k in range(n):
        im.seek(k)
        rgb = im.convert("RGB")
        out.append((np.asarray(rgb), rgb.info.get("transparency")))
    return n, out


def _assert_gif(data: bytes, label="") -> None:
    n, want = _pillow_frames(data)
    r = GifReader(data)
    assert r.n_frames == n, label
    got = list(r.frames(range(n)))
    assert [k for k, *_ in got] == list(range(n))
    for k, ((wpx, wt), (_, gpx, gt)) in enumerate(zip(want, got)):
        assert np.array_equal(gpx, wpx) and gt == wt, (label, k)


def _pillow_gif(n: int, size=(50, 40), transparency=True, **kw) -> bytes:
    w, h = size
    y, x = np.mgrid[:h, :w]
    pxs = []
    for k in range(n):
        px = np.stack([(x * 5 + k * 20) % 256, (y * 6) % 256,
                       ((x + y + k * 9) * 3) % 256], -1).astype(np.uint8)
        if k % 3 == 1:  # a frame changed only in one region: Pillow writes a sub-rectangle
            px = pxs[-1].copy()
            px[h // 4: h // 2, w // 3: w // 2] = (255, 0, 0)
        pxs.append(px)
    frames = [Image.fromarray(px).quantize(64) for px in pxs]
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=40, loop=0,
                   **({"transparency": 5} if transparency else {}), **kw)
    return buf.getvalue()


@pytest.mark.parametrize("case", [
    dict(n=12, disposal=2), dict(n=7, disposal=[0, 1, 2, 3, 2, 1, 0]),
    dict(n=6, transparency=False, disposal=1), dict(n=9, optimize=True, disposal=3),
    dict(n=1), dict(n=5, interlace=True)], ids=str)
def test_gif_pillow_animations(case):
    case = dict(case)
    _assert_gif(_pillow_gif(case.pop("n"), **case), case)


def _rng_pal(rng, n):
    return rng.integers(0, 256, (n, 3))


def _hand_gifs() -> dict[str, bytes]:
    rng = np.random.default_rng(3)
    g16 = _rng_pal(rng, 16)
    full = rng.integers(0, 16, (12, 14))
    runs = (np.arange(40 * 40).reshape(40, 40) // 97) % 7
    return {
        "disposal 3 restores": write_gif(14, 12, [
            dict(idx=full, trans=3),
            dict(idx=rng.integers(0, 16, (5, 6)), x=2, y=3, disposal=3),
            dict(idx=rng.integers(0, 16, (4, 4)), x=8, y=6, trans=1),
            dict(idx=rng.integers(0, 16, (3, 3)), x=1, y=1, disposal=3, gce=True)], g16),
        "disposal 2 without transparency": write_gif(14, 12, [
            dict(idx=full, disposal=2),
            dict(idx=rng.integers(0, 16, (5, 6)), x=2, y=3, disposal=2),
            dict(idx=rng.integers(0, 16, (6, 6)), x=5, y=4)], g16, bg=9),
        "local tables": write_gif(14, 12, [
            dict(idx=full, lpal=_rng_pal(rng, 16)),
            dict(idx=rng.integers(0, 4, (12, 14)), lpal=_rng_pal(rng, 4), min_size=2, trans=2),
            dict(idx=rng.integers(0, 16, (7, 5)), x=3, y=2)], g16),
        "no global table": write_gif(9, 7, [
            dict(idx=rng.integers(0, 8, (7, 9)), lpal=_rng_pal(rng, 8), min_size=3, trans=0),
            dict(idx=rng.integers(0, 8, (3, 4)), x=1, y=2, lpal=_rng_pal(rng, 8), min_size=3)]),
        "interlaced": write_gif(13, 19, [
            dict(idx=rng.integers(0, 16, (19, 13)), interlace=True),
            dict(idx=rng.integers(0, 16, (11, 5)), x=4, y=3, interlace=True, trans=2)], g16),
        "tiny interlaced": write_gif(3, 3, [
            dict(idx=rng.integers(0, 16, (h, 3)), interlace=True) for h in (1, 2, 3)], g16),
        "frame past the canvas": write_gif(10, 8, [
            dict(idx=rng.integers(0, 16, (8, 10)), trans=4),
            dict(idx=rng.integers(0, 16, (6, 7)), x=6, y=5, disposal=2),
            dict(idx=rng.integers(0, 16, (4, 4)), x=1, y=1)], g16),
        "first frame past the canvas": write_gif(6, 5, [
            dict(idx=rng.integers(0, 16, (7, 8)), x=1, y=1)], g16),
        "late clear": write_gif(40, 40, [
            dict(idx=rng.integers(0, 256, (40, 40)), late_clear=True),
            dict(idx=runs, late_clear=True)], _rng_pal(rng, 256)),
        "clears": write_gif(40, 40, [dict(idx=rng.integers(0, 256, (40, 40)))],
                            _rng_pal(rng, 256)),
        "indices past the table": write_gif(6, 2, [
            dict(idx=np.array([[0, 1, 2, 3, 4, 5], [6, 7, 3, 2, 1, 0]]), min_size=3, trans=6)],
            _rng_pal(rng, 4)),
        "grey": write_gif(6, 4, [
            dict(idx=rng.integers(0, 4, (4, 6)), min_size=2, trans=1),
            dict(idx=rng.integers(0, 4, (2, 3)), x=1, y=1, min_size=2, trans=2, disposal=2),
            dict(idx=rng.integers(0, 4, (4, 6)), min_size=2)],
            np.repeat(np.arange(4)[:, None], 3, axis=1)),
        "comments and no control blocks": write_gif(8, 6, [
            dict(idx=rng.integers(0, 16, (6, 8)), comment=b"frame zero" * 40, gce=False),
            dict(idx=rng.integers(0, 16, (3, 3)), x=2, y=2, gce=False, comment=b"x")], g16),
    }


@pytest.mark.parametrize("name", list(_hand_gifs()))
def test_gif_hand_built(name):
    _assert_gif(_hand_gifs()[name], name)


def _random_gif(rng) -> bytes:
    W, H = int(rng.integers(1, 20)), int(rng.integers(1, 20))
    bits = int(rng.integers(1, 5))
    ncol = 1 << bits

    def pal():
        return _rng_pal(rng, ncol)

    gp = pal() if rng.random() < 0.85 else None
    frames = []
    for _ in range(int(rng.integers(1, 6))):
        fw, fh = int(rng.integers(1, W + 5)), int(rng.integers(1, H + 5))
        x = int(rng.integers(0, W)) if rng.random() < 0.7 else 0
        y = int(rng.integers(0, H)) if rng.random() < 0.7 else 0
        if rng.random() < 0.5:
            fw, fh = min(fw, W - x), min(fh, H - y)
        lp = pal() if rng.random() < 0.3 or gp is None else None
        ms = max(2, bits) + (rng.random() < 0.15)
        idx = rng.integers(0, min(ncol + 2, 1 << ms), (fh, fw))
        if rng.random() < 0.5:
            idx = np.minimum(idx, 1) * int(rng.integers(0, ncol))
        frames.append(dict(idx=idx, x=x, y=y, lpal=lp, min_size=ms,
                           interlace=rng.random() < 0.3,
                           trans=int(rng.integers(0, ncol)) if rng.random() < 0.5 else None,
                           disposal=int(rng.integers(0, 4)), gce=rng.random() < 0.85,
                           late_clear=rng.random() < 0.5))
    return write_gif(W, H, frames, gp, bg=int(rng.integers(0, 256)))


@pytest.mark.parametrize("first", range(0, 160, 40))
def test_gif_random(first):
    """Seeded random GIFs (sizes, tables, offsets, disposal, transparency,
    interlace, frames past the canvas): every frame as Pillow gives it."""
    for seed in range(first, first + 40):
        data = _random_gif(np.random.default_rng(seed))
        _assert_gif(data, seed)


def test_gif_raises_where_pillow_does():
    rng = np.random.default_rng(0)
    g = _rng_pal(rng, 4)
    idx = rng.integers(0, 4, (4, 5))
    good = write_gif(5, 4, [dict(idx=idx, min_size=2)], g)
    short_codes = write_gif(5, 4, [dict(idx=idx[:2], min_size=2)], g).replace(
        struct.pack("<HH", 5, 2), struct.pack("<HH", 5, 4), 1)
    for bad in (short_codes, good[:-12], b"GIF89a" + bytes(7)):
        with pytest.raises(Exception):
            _pillow_frames(bad)
        with pytest.raises(ValueError, match="undecodable image bytes"):
            list(GifReader(bad).frames(range(GifReader(bad).n_frames)))
    with pytest.raises(ValueError, match="decompression bomb"):
        GifReader(b"GIF89a" + struct.pack("<HHBBB", 65535, 65535, 0, 0, 0) + b";")


def test_gif_greyscale_first_frame_with_colour_table_refused():
    """Frame 0 greyscale (no table), a later frame with a colour table:
    Pillow keeps the first frame's grey image; the port refuses."""
    rng = np.random.default_rng(1)
    data = write_gif(6, 4, [dict(idx=rng.integers(0, 4, (4, 6)), min_size=2),
                            dict(idx=rng.integers(0, 4, (4, 6)), min_size=2,
                                 lpal=_rng_pal(rng, 4))])
    r = GifReader(data)
    assert np.array_equal(next(r.frames([0]))[1], _pillow_frames(data)[1][0][0])
    with pytest.raises(ValueError, match="item 12b-iii"):
        list(r.frames([1]))


# ------------------------------------------------------------- PNG encode


def _pillow_png(px: np.ndarray, **info) -> bytes:
    im = Image.fromarray(px, "RGB")
    im.info.update(info)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    return buf.getvalue()


@pytest.mark.parametrize("shape", [(1, 1), (2, 3), (17, 5), (64, 64), (5, 64), (130, 190),
                                   (2, 17000)])
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_encode_png_equals_pillow_save(shape, kind):
    """Past 65,536 compressed bytes (130x190 noise) the IDAT chunks split;
    past 16,384 columns each holds 4 bytes per column."""
    px = _content(*shape, kind)
    got = image.encode_png(px)
    assert got == _pillow_png(px)
    if kind == "noise" and shape in ((130, 190), (2, 17000)):
        assert got.count(b"IDAT") > 1


def test_encode_png_with_transparency_and_icc():
    px = _content(20, 30, "smooth")
    icc = bytes(range(256)) * 9
    for t, p in (((1, 2, 3), None), (None, icc), ((0, 0, 0), icc), ((4660, 5, 65535), None)):
        info = {k: v for k, v in (("transparency", t), ("icc_profile", p)) if v is not None}
        assert image.encode_png(px, t, p) == _pillow_png(px, **info), (t, p is not None)
    with pytest.raises(ValueError):
        image.encode_png(px, 7)  # Pillow's writer refuses a bare int for RGB


# ------------------------------------------------------------ still images


def _stills() -> dict[str, bytes]:
    px = _content(30, 41, "smooth", 2)
    grey_png = _save(px, "PNG", "L")
    buf = io.BytesIO()
    Image.fromarray(px).quantize(16).save(buf, "GIF", transparency=2)
    return {
        "PNG": _save(px, "PNG"),
        "PNG tRNS": _pillow_png(px, transparency=(3, 6, 9)),
        "PNG iCCP": _pillow_png(px, icc_profile=b"p" * 700),
        "PNG grey": grey_png,
        "JPEG": _save(px, "JPEG", quality=92),
        "JPEG ICC": _save(px, "JPEG", icc_profile=bytes(range(256)) * 3),
        "JPEG grey progressive": _save(px, "JPEG", "L", progressive=True),
        "GIF": buf.getvalue(),
        "GIF grey": _save(px, "GIF", "L"),
    }


@pytest.mark.parametrize("name", list(_stills()))
def test_decode_image_and_preprocess_equal_the_reference(name):
    data = _stills()[name]
    want, info = _pillow_rgb(data)
    got, got_info = image.decode_image(data)
    assert np.array_equal(got, want)
    for key in ("transparency", "icc_profile"):
        assert got_info.get(key) == info.get(key), key
    for size in (28, 336):
        assert np.array_equal(image.preprocess_image(data, size),
                              jvit.preprocess_image(data, size))


def _animated(fmt: str) -> bytes:
    frames = [Image.fromarray(_content(12, 16, "smooth", s)) for s in (0, 40, 80)]
    buf = io.BytesIO()
    frames[0].save(buf, fmt, save_all=True, append_images=frames[1:], duration=40)
    return buf.getvalue()


def test_animated_png_still_is_pillows_frame_zero():
    """An animated PNG decodes as its default image, which is Pillow's
    frame 0 whether or not the image data is the animation's first frame;
    as a video its frames are the reference's."""
    for mode in ("RGB", "RGBA", "P", "L"):
        for default_image in (False, True):
            frames = [Image.fromarray(_content(12, 16, "noise", s)).convert(mode)
                      for s in (0, 1, 2)]
            buf = io.BytesIO()
            frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:],
                           default_image=default_image)
            data = buf.getvalue()
            im = Image.open(io.BytesIO(data))
            assert im.n_frames == 3 and image.frame_count(data) == 3
            assert np.array_equal(image.decode_image(data)[0],
                                  np.asarray(im.convert("RGB"))), (mode, default_image)
            assert encoder.sample_video_frames(data, 2) == jenc.sample_video_frames(data, 2)


def _crc_chunk(kind: bytes, body: bytes, bad: bool = False) -> bytes:
    crc = zlib.crc32(kind + body) ^ (1 if bad else 0)
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _crc_case(case: str) -> bytes:
    """A 5x4 RGB PNG, its image data in two IDATs and a tEXt after them,
    with one flipped CRC bit, a cut, or junk where ``case`` says."""
    px = _content(4, 5, "noise", 7)
    data = zlib.compress(b"".join(b"\0" + px[y].tobytes() for y in range(4)))
    chunks = [(b"IHDR", struct.pack(">IIBBBBB", 5, 4, 8, 2, 0, 0, 0)),
              (b"IDAT", data[:9]), (b"IDAT", data[9:]), (b"tEXt", b"key\0value"),
              (b"IEND", b"")]
    bad = {"IHDR": 0, "first IDAT": 1, "second IDAT": 2, "tEXt after IDAT": 3, "IEND": 4}
    out = b"".join(_crc_chunk(k, b, bad.get(case) == i) for i, (k, b) in enumerate(chunks))
    text_at = out.index(b"tEXt") - 4
    if case == "truncated tEXt":
        return image.PNG_SIGNATURE + out[:text_at + 12]
    if case == "tEXt without its CRC":
        return image.PNG_SIGNATURE + out[:text_at + 8 + len(chunks[3][1])]
    if case == "junk chunk type after IDAT":
        return image.PNG_SIGNATURE + out[:text_at] + b"\0\x0f\x42\x40\xff\xfe\xfd\xfc" + b"x" * 6
    return image.PNG_SIGNATURE + out


@pytest.mark.parametrize("case", [
    "first IDAT", "second IDAT", "tEXt after IDAT", "IEND", "tEXt without its CRC",
    "junk chunk type after IDAT", "IHDR", "truncated tEXt"])
def test_png_chunk_faults_read_as_pillow(case):
    """Pillow checks chunk CRCs only before the first IDAT: a bad CRC from
    there on, a CRC cut off at the end and a chunk type that is not four
    word bytes decode to its pixels; a bad IHDR CRC and a truncated chunk
    body raise in both."""
    data = _crc_case(case)
    try:
        want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except (OSError, SyntaxError):
        want = None
    if want is None:
        assert case in ("IHDR", "truncated tEXt")
        with pytest.raises(ValueError, match="^undecodable image bytes: "):
            image.decode_image(data)
    else:
        assert np.array_equal(image.decode_image(data)[0], want)


def test_apng_default_image_with_a_bad_idat_crc_is_pillows_frame_zero():
    frames = [Image.fromarray(_content(6, 7, "noise", s)) for s in (3, 4)]
    buf = io.BytesIO()
    frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:], default_image=True)
    data = bytearray(buf.getvalue())
    at = data.index(b"IDAT") - 4
    end = at + 8 + struct.unpack(">I", data[at: at + 4])[0]
    data[end + 3] ^= 1  # the IDAT's CRC
    data = bytes(data)
    want = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(image.decode_image(data)[0], want)


# ------------------------------------------------------------- video


def _videos() -> dict[str, bytes]:
    out = {f"still {k}": v for k, v in _stills().items()}
    out.update({
        "GIF 12 frames": _pillow_gif(12),
        "GIF 2 frames": _pillow_gif(2, transparency=False),
        "GIF optimized": _pillow_gif(7, optimize=True, disposal=[2, 3, 1, 0, 2, 3, 1]),
        "GIF hand disposal 3": _hand_gifs()["disposal 3 restores"],
        "GIF hand past canvas": _hand_gifs()["frame past the canvas"],
        "GIF hand grey": _hand_gifs()["grey"],
    })
    return out


@pytest.mark.parametrize("n", [1, 2, 8])
@pytest.mark.parametrize("name", list(_videos()))
def test_sample_video_frames_equals_the_reference(name, n):
    data = _videos()[name]
    want = jenc.sample_video_frames(data, n)
    got = encoder.sample_video_frames(data, n)
    assert len(got) == n and got == want


def test_video_errors():
    """Garbage: the reference's error class and prefix; animated WebP and
    PNG: the reference's frames."""
    for bad in (b"not a video at all", b"GIF89a\x01"):
        with pytest.raises(ValueError, match="undecodable video bytes"):
            jenc.sample_video_frames(bad, 4)
        with pytest.raises(ValueError, match="undecodable video bytes"):
            encoder.sample_video_frames(bad, 4)
    assert features.check("webp")
    for fmt in ("WEBP", "PNG"):
        data = _animated(fmt)
        assert len(jenc.sample_video_frames(data, 3)) == 3
        assert encoder.sample_video_frames(data, 3) == jenc.sample_video_frames(data, 3)


# ------------------------------------------------------------- fixtures


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _fixture_icc() -> bytes:
    """A made-up ICC-like profile: a header and seeded tag data."""
    body = np.random.default_rng(2828).integers(0, 256, 2940, dtype=np.uint8).tobytes()
    return struct.pack(">I", 128 + len(body)) + b"dtpu" + bytes(120) + body


def _fixture_gif() -> bytes:
    """320x240, 12 frames of smooth moving content with mixed disposal and
    a transparent index (frame 0 keeps it; later frames composite)."""
    w, h = 320, 240
    y, x = np.mgrid[:h, :w]
    frames = []
    for k in range(12):
        px = np.stack([(x + 12 * k) * 255 // (w + 140), y * 255 // h,
                       (128 + 60 * np.sin((x + y) / 40 + k / 2)).astype(int)], -1)
        px = px.astype(np.uint8)
        if k % 4 == 2:
            px[40:120, 60 + 10 * k: 140 + 10 * k] = (250, 250, 250)
        frames.append(Image.fromarray(px).quantize(48, dither=Image.Dither.NONE))
    buf = io.BytesIO()
    frames[0].save(buf, "GIF", save_all=True, append_images=frames[1:], duration=80, loop=0,
                   transparency=7, disposal=[1, 2, 3, 1, 2, 0, 1, 3, 2, 1, 0, 2])
    return buf.getvalue()


def _fixture_files() -> dict[str, bytes]:
    smooth = {}
    for (w, h), s in (((640, 480), 0), ((500, 375), 1), ((333, 251), 2)):
        y, x = np.mgrid[:h, :w]
        smooth[w] = np.stack([x * 255 // w, y * 255 // h,
                              (128 + 90 * np.sin(x / 57 + y / 83 + s)).astype(int)], -1)
    jpeg = {
        "photo_420_icc_rst.jpg": _save(smooth[640].astype(np.uint8), "JPEG", quality=85,
                                       subsampling=2, icc_profile=_fixture_icc(),
                                       restart_marker_rows=2),
        "photo_422_progressive.jpg": _save(smooth[500].astype(np.uint8), "JPEG", quality=88,
                                           subsampling=1, progressive=True, optimize=True),
        "grey_333x251.jpg": _save(smooth[333].astype(np.uint8), "JPEG", "L", quality=90),
    }
    return {**jpeg, "anim_320x240.gif": _fixture_gif(), **_fixture_webp_apng_mpo()}


def _textured(w: int, h: int, seed: int, t: int = 0) -> np.ndarray:
    """Smooth colour fields with fine stripes and seeded grain: a photo's
    share of texture for the lossy coders."""
    y, x = np.mgrid[:h, :w]
    grain = np.random.default_rng(seed).integers(-12, 13, (h, w, 3))
    px = np.stack([(x + 9 * t) * 255 // (w + 120), y * 255 // h,
                   128 + 90 * np.sin(x / 57 + y / 83 + seed + t / 3)], -1)
    px = px + 24 * np.sin((x * 3 + y * 2) / 5.0)[..., None] + grain
    return np.clip(px, 0, 255).astype(np.uint8)


def _sprite_frames(w: int, h: int, n: int) -> list[np.ndarray]:
    """RGBA frames: a still textured background and a moving half-clear
    disc, so that animation writers emit sub-rectangles, blend and dispose."""
    bg = _textured(w, h, 5)
    y, x = np.mgrid[:h, :w]
    out = []
    for k in range(n):
        cx, cy = 20 + k * (w - 40) // max(n - 1, 1), h // 2 + int(20 * np.sin(k))
        disc = np.hypot(x - cx, y - cy) < 18
        px = np.dstack([bg, np.full((h, w), 255, np.uint8)])
        px[disc] = (240, 40 + 15 * k, 30, 140 if k % 3 else 0)
        out.append(px)
    return out


def _fixture_webp_apng_mpo() -> dict[str, bytes]:
    """A lossy 640x480 WebP, a lossless 200x150 WebP with alpha, a 12-frame
    animated WebP and APNG of a moving disc, a 2-frame MPO."""
    buf = io.BytesIO()
    Image.fromarray(_textured(640, 480, 0)).save(buf, "WEBP", quality=80, method=4)
    lossy = buf.getvalue()
    a = np.clip(255 - np.hypot(*np.mgrid[-75:75, -100:100]) * 2, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(np.dstack([_textured(200, 150, 1), a]), "RGBA").save(buf, "WEBP",
                                                                         lossless=True)
    lossless = buf.getvalue()
    frames = [Image.fromarray(f, "RGBA") for f in _sprite_frames(160, 120, 12)]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=80, loop=0,
                   minimize_size=True, allow_mixed=True, quality=75, kmin=3, kmax=5)
    anim_webp = buf.getvalue()
    buf = io.BytesIO()
    frames[0].save(buf, "PNG", save_all=True, append_images=frames[1:], duration=80,
                   disposal=[0, 1, 2] * 4, blend=[0, 1] * 6)
    apng = buf.getvalue()
    buf = io.BytesIO()
    ims = [Image.fromarray(_textured(320, 240, 3, t)) for t in (0, 4)]
    ims[0].save(buf, "MPO", save_all=True, append_images=ims[1:], quality=85)
    return {"photo_640x480.webp": lossy, "alpha_200x150_lossless.webp": lossless,
            "anim_160x120.webp": anim_webp, "anim_160x120.png": apng,
            "stereo_320x240.mpo": buf.getvalue()}


def _versions() -> dict[str, str]:
    import PIL

    return {"pillow": PIL.__version__, "libjpeg_turbo": features.version("libjpeg_turbo"),
            "libwebp": features.version("webp"), "zlib": zlib.ZLIB_RUNTIME_VERSION}


def write_fixtures(folder: Path = FIXTURES) -> dict:
    """Write the fixture files and ``manifest.json`` (every digest from
    Pillow and the reference's ``sample_video_frames``). Run as ``python -c
    'from tests.test_torch_image_formats import write_fixtures;
    write_fixtures()'`` from the repo root."""
    folder.mkdir(parents=True, exist_ok=True)
    manifest = {"versions": _versions(), "frames": FIXTURE_FRAMES, "files": {}}
    for name, data in _fixture_files().items():
        (folder / name).write_bytes(data)
        manifest["files"][name] = _manifest_entry(data)
    (folder / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")
    return manifest


def _manifest_entry(data: bytes) -> dict:
    rgb, _ = _pillow_rgb(data)
    entry = {"sha256": _sha(data), "rgb_sha256": _sha(rgb.tobytes()), "shape": list(rgb.shape)}
    n = getattr(Image.open(io.BytesIO(data)), "n_frames", 1)
    if n > 1:
        entry["n_frames"] = n
        entry["frame_png_sha256"] = [_sha(f) for f in
                                     jenc.sample_video_frames(data, FIXTURE_FRAMES)]
        entry["frame_rgb_sha256"] = [
            _sha(np.asarray(Image.open(io.BytesIO(f)).convert("RGB")).tobytes())
            for f in jenc.sample_video_frames(data, FIXTURE_FRAMES)]
    return entry


def test_fixtures_match_their_manifest():
    """The committed files are what ``write_fixtures`` writes, and the
    manifest holds what Pillow and the reference give for them here; the
    port's decode and sampling give the same digests."""
    manifest = json.loads((FIXTURES / "manifest.json").read_text())
    assert manifest["versions"] == _versions()
    files = _fixture_files()
    assert sorted(manifest["files"]) == sorted(files)
    total = 0
    for name, entry in manifest["files"].items():
        data = (FIXTURES / name).read_bytes()
        total += len(data)
        assert data == files[name], name
        assert _manifest_entry(data) == entry, name
        if name.endswith(".gif"):
            rgb = next(GifReader(data).frames([0]))[1]
        else:
            rgb = image.decode_image(data)[0]
        if "n_frames" in entry:
            assert image.frame_count(data) == entry["n_frames"], name
            frames = encoder.sample_video_frames(data, FIXTURE_FRAMES)
            assert [_sha(f) for f in frames] == entry["frame_png_sha256"], name
        assert _sha(rgb.tobytes()) == entry["rgb_sha256"] and list(rgb.shape) == entry["shape"]
    assert total < 400_000
