"""The port's animated PNG and MPO readers (dynamo_tpu_torch/multimodal/
{apng,mpo,image}.py) held against Pillow 12.1 on the CPU, bit for bit, and
``preprocess_image`` and ``sample_video_frames`` against the JAX package's
on the same bytes:

- APNG: Pillow-written animations in modes RGB, RGBA, L, LA and P, with
  and without a default image, every dispose/blend pair; APNGs written by
  this file's own muxer with random frame regions (some reaching the
  image's edge), dispose ``NONE``/``BACKGROUND``/``PREVIOUS`` and blend
  ``SOURCE``/``OVER`` per frame, in modes 1, L (2, 4 and 8 bits), I;16,
  LA, RGB (8 and 16 bits), RGBA and P (1 to 8 bits), with ``tRNS`` (a
  colour, a grey level, a palette index, an alpha table), a seeded fuzz of
  ``Image.paste``'s fixed-point BLEND; a first frame that is a region of
  the image; sequence errors, a missing frame's data, an ``acTL`` that
  declares more frames than the file has, truncation;
- MPO: Pillow-written files of 2 and 3 images (sizes and modes differing
  per frame, an ICC profile in frame 0 only or in each), frame counts,
  pixels and the ``icc_profile`` the PNG writer reads; an index Pillow
  reads as malformed leaves a plain JPEG.
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from dynamo_tpu.multimodal import encoder as jenc
from dynamo_tpu.multimodal import vit as jvit
from dynamo_tpu_torch.multimodal import encoder, image
from dynamo_tpu_torch.multimodal.apng import ApngReader

pytestmark = pytest.mark.filterwarnings("ignore")


def _pillow_frames(data: bytes) -> tuple[list[tuple[np.ndarray, dict]], bool]:
    """Pillow's frames up to the first that fails, and whether one failed."""
    im = Image.open(io.BytesIO(data))
    out = []
    try:
        for k in range(getattr(im, "n_frames", 1)):
            im.seek(k)
            rgb = im.convert("RGB")
            out.append((np.asarray(rgb), rgb.info))
    except Exception:  # noqa: BLE001
        return out, True
    return out, False


def _assert_frames(data: bytes, label="", may_fail: bool = False) -> None:
    """The port's frames are Pillow's; where Pillow fails at a frame the
    port raises the reference's error there."""
    want, failed = _pillow_frames(data)
    assert may_fail or not failed, label
    n = image.frame_count(data)
    got = []
    if failed:
        with pytest.raises(ValueError, match="^undecodable image bytes: "):
            for k, rgb, info in image.frames(data, range(n)):
                got.append((k, rgb, info))
        with pytest.raises(ValueError, match="^undecodable video bytes"):
            encoder.sample_video_frames(data, n)
    else:
        assert n == len(want), label
        got = list(image.frames(data, range(n)))
    assert [k for k, _, _ in got] == list(range(len(want))), label
    for (k, rgb, info), (w, winfo) in zip(got, want):
        assert rgb.dtype == np.uint8 and np.array_equal(rgb, w), (label, k)
        for key in ("transparency", "icc_profile"):
            assert info.get(key) == winfo.get(key), (label, k, key)
    if want:
        assert np.array_equal(image.decode_image(data)[0], want[0][0]), label


# ------------------------------------------------------------ APNG writer


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _scanlines(px: np.ndarray, depth: int) -> bytes:
    """Samples [h, w, c] -> filter-0 scanlines (MSB-first below 8 bits)."""
    h, w, c = px.shape
    if depth == 16:
        rows = px.astype(">u2").reshape(h, w * c).view(np.uint8)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, w * c)
    else:
        bits = (px.reshape(h, w * c)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
        rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
    return b"".join(b"\0" + r.tobytes() for r in rows)


_CTYPES = {"L": 0, "RGB": 2, "P": 3, "LA": 4, "RGBA": 6}


def write_apng(ctype: int, depth: int, w: int, h: int, frames: list[dict],
               default: np.ndarray | None = None, palette: bytes | None = None,
               trns: bytes | None = None, actl: int | None = None) -> bytes:
    """An APNG: each frame a dict of ``px`` (samples), ``x``, ``y``,
    ``dispose``, ``blend``; ``default`` an image outside the animation."""
    out = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype,
                                                              0, 0, 0))]
    out.append(_chunk(b"acTL", struct.pack(">II", actl or len(frames), 0)))
    if palette is not None:
        out.append(_chunk(b"PLTE", palette))
    if trns is not None:
        out.append(_chunk(b"tRNS", trns))
    seq = 0
    if default is not None:
        out.append(_chunk(b"IDAT", zlib.compress(_scanlines(default, depth))))
    for k, f in enumerate(frames):
        fh, fw = f["px"].shape[:2]
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, fw, fh, f["x"], f["y"],
                                               1, 10, f["dispose"], f["blend"])))
        seq += 1
        data = zlib.compress(_scanlines(f["px"], depth))
        if k == 0 and default is None:
            out.append(_chunk(b"IDAT", data))
        else:
            half = max(1, len(data) // 2)  # two fdAT chunks per frame
            for part in (data[:half], data[half:]):
                if part:
                    out.append(_chunk(b"fdAT", struct.pack(">I", seq) + part))
                    seq += 1
    out.append(_chunk(b"IEND", b""))
    return b"".join(out)


_MODES = [("L", 8), ("L", 1), ("L", 2), ("L", 4), ("L", 16), ("LA", 8), ("LA", 16),
          ("RGB", 8), ("RGB", 16), ("RGBA", 8), ("RGBA", 16), ("P", 8), ("P", 4), ("P", 1)]


def _samples(rng, mode: str, depth: int, h: int, w: int, few: np.ndarray | None) -> np.ndarray:
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    top = (1 << depth) - 1
    if few is not None and rng.random() < 0.7:  # colours repeated (tRNS hits)
        px = few[rng.integers(0, len(few), (h, w))]
    else:
        px = rng.integers(0, top + 1, (h, w, c))
    if mode in ("LA", "RGBA"):  # alpha mostly 0 or full, some between
        a = rng.choice([0, top, top // 3, top // 2 + 1], (h, w), p=[0.3, 0.4, 0.15, 0.15])
        px[..., -1] = a
    if mode == "P":
        px = np.minimum(px, (1 << depth) - 1)
    return px.astype(np.uint16 if depth == 16 else np.uint8)


def _random_apng(rng, mode: str, depth: int) -> bytes:
    w, h = int(rng.integers(1, 24)), int(rng.integers(1, 24))
    ctype = _CTYPES[mode]
    top = (1 << depth) - 1
    c = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    few = rng.integers(0, top + 1, (3, c))
    palette = trns = None
    if mode == "P":
        n = int(rng.integers(1, (1 << depth) + 1))
        palette = rng.integers(0, 256, 3 * n, dtype=np.uint8).tobytes()
        if rng.random() < 0.5:
            trns = rng.integers(0, 256, int(rng.integers(1, n + 1)), dtype=np.uint8).tobytes()
        elif rng.random() < 0.5:
            trns = b"\xff" * int(rng.integers(0, n)) + b"\x00"  # one index
    elif mode == "L" and rng.random() < 0.6:
        trns = struct.pack(">H", int(few[0, 0]))
    elif mode == "RGB" and rng.random() < 0.8:
        trns = struct.pack(">HHH", *(int(v) for v in few[0]))
    frames = []
    for k in range(int(rng.integers(1, 6))):
        fw, fh = int(rng.integers(1, w + 1)), int(rng.integers(1, h + 1))
        x, y = int(rng.integers(0, w - fw + 1)), int(rng.integers(0, h - fh + 1))
        if rng.random() < 0.2:  # out to the image's edge
            x, y = w - fw, h - fh
        if k == 0 and rng.random() < 0.5:
            x, y, fw, fh = 0, 0, w, h
        frames.append(dict(px=_samples(rng, mode, depth, fh, fw, few), x=x, y=y,
                           dispose=int(rng.integers(0, 3)), blend=int(rng.integers(0, 2))))
    default = _samples(rng, mode, depth, h, w, few) if rng.random() < 0.3 else None
    return write_apng(ctype, depth, w, h, frames, default, palette, trns)


@pytest.mark.parametrize("mode,depth", _MODES)
def test_muxed_apng_fuzz(mode, depth):
    """Every dispose/blend pair at random regions, 12 seeded files per mode."""
    rng = np.random.default_rng(depth * 100 + len(mode))
    for case in range(12):
        data = _random_apng(rng, mode, depth)
        # Pillow cannot blend an I;16 frame over the image (no RGBA mask)
        _assert_frames(data, (mode, depth, case), may_fail=(mode, depth) == ("L", 16))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P"])
@pytest.mark.parametrize("default_image", [False, True])
def test_pillow_apng(mode, default_image):
    """Pillow's writer: its own regions (only what changed), disposal and
    blend per frame, ``transparency`` in the modes that carry it."""
    rng = np.random.default_rng(len(mode) + default_image)
    h, w = 17, 23
    y, x = np.mgrid[:h, :w]
    frames = []
    for k in range(6):
        px = np.stack([(x * 11 + 40 * k) % 256, y * 9 % 256, np.full_like(x, 30 * k),
                       rng.choice([0, 128, 255], (h, w))], -1).astype(np.uint8)
        if k % 2:
            px[: h // 2] = frames[-1][: h // 2] if frames else px[: h // 2]
        frames.append(px)
    ims = [Image.fromarray(f, "RGBA").convert(mode) if mode != "P"
           else Image.fromarray(f[..., :3]).quantize(20) for f in frames]
    # Pillow's writer disposes only in RGB, RGBA and LA (in L and P it
    # fails): this file's muxer covers the rest
    rgbish = mode in ("RGB", "RGBA", "LA")
    kw = dict(save_all=True, append_images=ims[1:], duration=30, default_image=default_image,
              disposal=[0, 1, 2, 0, 2, 1] if rgbish else 0, blend=[0, 1, 1, 0, 1, 1])
    if mode in ("RGB", "L", "P"):
        kw["transparency"] = (12, 9, 0) if mode == "RGB" else 3
    buf = io.BytesIO()
    ims[0].save(buf, "PNG", **kw)
    data = buf.getvalue()
    _assert_frames(data, (mode, default_image))
    for n in (1, 3, 8):
        assert encoder.sample_video_frames(data, n) == jenc.sample_video_frames(data, n)
    assert np.array_equal(image.preprocess_image(data, 28), jvit.preprocess_image(data, 28))


def test_blend_is_pastes_fixed_point_blend():
    """OVER on RGBA: each channel (alpha too) is DIV255(o * (255 - a) + n
    * a), not Porter-Duff; seeded pixels against Pillow's composite."""
    rng = np.random.default_rng(99)
    h, w = 16, 16
    base = rng.integers(0, 256, (h, w, 4))
    over = rng.integers(0, 256, (h, w, 4))
    data = write_apng(6, 8, w, h, [dict(px=base, x=0, y=0, dispose=0, blend=0),
                                   dict(px=over, x=0, y=0, dispose=0, blend=1)])
    im = Image.open(io.BytesIO(data))
    im.seek(1)
    got_rgba = np.asarray(im.convert("RGBA")).astype(np.int64)
    a = over[..., 3:4]
    v = base * (255 - a) + over * a + 128
    assert np.array_equal(got_rgba, ((v >> 8) + v) >> 8)
    _assert_frames(data)


def test_first_frame_a_region():
    """The first frame a region of the image: zeros around it (index 0 in
    P), as a still image and as frame 0."""
    rng = np.random.default_rng(3)
    for mode, depth in (("RGB", 8), ("P", 8), ("LA", 8)):
        c = {"RGB": 3, "P": 1, "LA": 2}[mode]
        pal = rng.integers(0, 256, 30, dtype=np.uint8).tobytes() if mode == "P" else None
        frames = [dict(px=rng.integers(0, 10, (5, 7, c)), x=3, y=2, dispose=0, blend=0),
                  dict(px=rng.integers(0, 10, (9, 11, c)), x=0, y=0, dispose=1, blend=1)]
        data = write_apng(_CTYPES[mode], depth, 11, 9, frames, palette=pal)
        _assert_frames(data, mode)
        assert np.array_equal(image.preprocess_image(data, 28), jvit.preprocess_image(data, 28))


def _errors(data: bytes, label) -> None:
    """Pillow raises at some frame: the port raises ValueError from
    ``frames`` by then, and gives Pillow's pixels before it."""
    im = Image.open(io.BytesIO(data))
    good = []
    try:
        for k in range(im.n_frames):
            im.seek(k)
            good.append(np.asarray(im.convert("RGB")))
        pytest.fail(f"Pillow decoded {label}")
    except Exception:  # noqa: BLE001
        pass
    got = []
    with pytest.raises(ValueError, match="^undecodable image bytes: "):
        for _, rgb, _ in image.frames(data, range(image.frame_count(data))):
            got.append(rgb)
    assert len(got) == len(good) and all(np.array_equal(a, b) for a, b in zip(got, good)), label
    with pytest.raises(ValueError, match="^undecodable video bytes"):
        encoder.sample_video_frames(data, 8)


def test_apng_stream_errors():
    rng = np.random.default_rng(5)
    fr = [dict(px=rng.integers(0, 256, (6, 6, 3)), x=0, y=0, dispose=0, blend=0)
          for _ in range(3)]
    good = write_apng(2, 8, 6, 6, fr)
    _assert_frames(good)
    # a frame's fcTL with its sequence number bumped: "frame sequence errors"
    i = good.index(b"fcTL", good.index(b"fcTL") + 1)
    bumped = good[: i + 4] + struct.pack(">I", 40) + good[i + 8:]
    cases = {"sequence": bumped, "more frames declared": write_apng(2, 8, 6, 6, fr, actl=5),
             "missing data": good.replace(b"fdAT", b"zzAT")}
    for name, data in cases.items():
        _errors(data, name)
    for cut in (len(good) - 20, len(good) - 60, good.index(b"fdAT") + 30):
        data = good[:cut]
        want = []
        try:
            im = Image.open(io.BytesIO(data))
            for k in range(im.n_frames):
                im.seek(k)
                want.append(np.asarray(im.convert("RGB")))
        except Exception:  # noqa: BLE001
            with pytest.raises(ValueError, match="^undecodable"):
                list(image.frames(data, range(image.frame_count(data))))
            continue
        got = [rgb for _, rgb, _ in image.frames(data, range(len(want)))]
        assert all(np.array_equal(a, b) for a, b in zip(got, want)), cut


def test_zlib_reads_as_pillows_zipdecode():
    """Pillow inflates a frame one scanline per call while its read has
    input left: a stream that ends at a scanline's end ends the frame (the
    rest keeps the image's pixels); a scanline the inflater could finish
    from its window alone after the input ran out is missing (the frame
    fails); a checksum in a chunk the frame never reads is never checked;
    a region of no width fails the frame."""
    rng = np.random.default_rng(17)
    w, h = 6, 8
    base = rng.integers(0, 256, (h, w, 3))

    def frames_with(second: list[bytes], fw=w, fh=h) -> bytes:
        out = [b"\x89PNG\r\n\x1a\n", _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)),
               _chunk(b"acTL", struct.pack(">II", 2, 0)),
               _chunk(b"fcTL", struct.pack(">IIIIIHHBB", 0, w, h, 0, 0, 1, 10, 0, 0)),
               _chunk(b"IDAT", zlib.compress(_scanlines(base, 8))),
               _chunk(b"fcTL", struct.pack(">IIIIIHHBB", 1, fw, fh, 0, 0, 1, 10, 0, 0))]
        for k, part in enumerate(second):
            out.append(_chunk(b"fdAT", struct.pack(">I", 2 + k) + part))
        return b"".join(out + [_chunk(b"IEND", b"")])

    px = rng.integers(0, 256, (h, w, 3))
    full = zlib.compress(_scanlines(px, 8))
    short = zlib.compress(_scanlines(px[:5], 8))  # 5 of 8 scanlines, then the end
    bad_check = full[:-4] + bytes(4)
    # a long run: the last scanlines come from a match, out of the window
    flat = zlib.compress(b"".join(b"\0" + bytes([9, 9, 9]) * w for _ in range(h)), 9)
    cases = {"stream ends at a scanline": [short], "checksum in an unread chunk":
             [bad_check[:-4], bad_check[-4:]], "whole": [full[:9], full[9:]],
             "window only after the input": [flat[:-6]]}
    for name, parts in cases.items():
        _assert_frames(frames_with(parts), name, may_fail=True)
    _assert_frames(frames_with([full], fw=0), "no width", may_fail=True)


def test_reader_decodes_only_up_to_the_last_index(monkeypatch):
    rng = np.random.default_rng(8)
    data = write_apng(6, 8, 9, 9, [dict(px=rng.integers(0, 256, (9, 9, 4)), x=0, y=0,
                                        dispose=0, blend=1) for _ in range(6)])
    calls = []
    real = image.inflate_samples

    def spy(*args):
        calls.append(args[1])
        return real(*args)

    monkeypatch.setattr(image, "inflate_samples", spy)
    assert [k for k, _ in ApngReader(data).frames([1, 3])] == [1, 3] and len(calls) == 4


# -------------------------------------------------------------------- MPO


def _mpo(sizes, modes, icc: bool = True) -> bytes:
    """Pillow's MPO writer: the first frame's options (its ICC profile)
    go to every frame."""
    rng = np.random.default_rng(len(sizes))
    ims = []
    for (w, h), mode in zip(sizes, modes):
        y, x = np.mgrid[:h, :w]
        px = np.stack([x * 255 // w, y * 255 // h, rng.integers(0, 256, (h, w))], -1)
        ims.append(Image.fromarray(px.astype(np.uint8)).convert(mode))
    buf = io.BytesIO()
    kw = dict(icc_profile=bytes(range(256)) * 2) if icc else {}
    ims[0].save(buf, "MPO", save_all=True, append_images=ims[1:], **kw)
    return buf.getvalue()


def _frame1_icc(data: bytes, how: str) -> bytes:
    """Frame 1's ICC segment removed (it then keeps frame 0's profile in
    Pillow's info) or its profile changed."""
    start = Image.open(io.BytesIO(data))._MpoImageFile__mpoffsets[1]
    i = data.index(b"ICC_PROFILE\x00", start) - 4
    n = struct.unpack(">H", data[i + 2: i + 4])[0]
    if how == "strip":
        return data[:i] + data[i + 2 + n:]
    body = bytearray(data[i + 4 + 14: i + 2 + n])
    body[5:9] = b"diff"
    return data[: i + 4 + 14] + bytes(body) + data[i + 2 + n:]


@pytest.mark.parametrize("case", ["2 frames", "3 frames sizes", "modes", "icc frame 0 only",
                                  "icc differs"])
def test_mpo_frames(case):
    sizes, modes, icc = {
        "2 frames": ([(32, 24), (32, 24)], ["RGB", "RGB"], True),
        "3 frames sizes": ([(40, 30), (17, 9), (64, 48)], ["RGB"] * 3, True),
        "modes": ([(24, 24), (20, 24), (13, 31)], ["RGB", "L", "L"], False),
        "icc frame 0 only": ([(16, 16), (20, 12)], ["RGB", "L"], True),
        "icc differs": ([(16, 16), (20, 12)], ["RGB", "RGB"], True),
    }[case]
    data = _mpo(sizes, modes, icc)
    if case == "icc frame 0 only":
        data = _frame1_icc(data, "strip")
    elif case == "icc differs":
        data = _frame1_icc(data, "change")
    assert Image.open(io.BytesIO(data)).format == "MPO"
    _assert_frames(data, case)
    for n in (1, 2, 5):
        assert encoder.sample_video_frames(data, n) == jenc.sample_video_frames(data, n)
    assert np.array_equal(image.preprocess_image(data, 28), jvit.preprocess_image(data, 28))


def test_mpo_frame_of_another_mode_at_the_same_size_refused():
    """Pillow decodes a frame into the image memory of the frame loaded
    before it when the size is the same: a grey frame after a colour one
    comes out as grey samples packed into RGB pixels. The port refuses
    that frame naming item 12b-iii, and decodes the frames before it."""
    data = _mpo([(24, 24), (24, 24)], ["RGB", "L"], False)
    im = Image.open(io.BytesIO(data))
    im.seek(0)
    first = np.asarray(im.convert("RGB"))
    im.seek(1)
    packed = np.asarray(im.convert("RGB"))
    grey = next(image.frames(data, [1]))[1]  # frame 1 alone, nothing loaded before
    assert not np.array_equal(packed, grey)
    got = image.frames(data, [0, 1])
    assert np.array_equal(next(got)[1], first)
    with pytest.raises(ValueError, match="item 12b-iii"):
        next(got)
    with pytest.raises(ValueError, match="undecodable video bytes.*item 12b-iii"):
        encoder.sample_video_frames(data, 4)


def test_mpo_malformed_index_is_a_plain_jpeg():
    """An MP index whose entry says the image data is not JPEG: Pillow warns
    and opens a plain JPEG of one frame; so does the port."""
    data = _mpo([(16, 16), (16, 16)], ["RGB", "RGB"])
    i = data.index(b"MPF\x00") + 4
    end = ">" if data[i: i + 4] == b"MM\x00*" else "<"
    off = struct.unpack(end + "I", data[i + 4: i + 8])[0]
    n = struct.unpack(end + "H", data[i + off: i + off + 2])[0]
    for e in range(n):
        tag, typ, count, value = struct.unpack(end + "HHII", data[i + off + 2 + 12 * e:
                                                                   i + off + 14 + 12 * e])
        if tag == 0xB002:
            at = i + value
            attr = struct.unpack(end + "I", data[at: at + 4])[0] | (3 << 24)
            data = data[:at] + struct.pack(end + "I", attr) + data[at + 4:]
    im = Image.open(io.BytesIO(data))
    assert im.format == "JPEG" and getattr(im, "n_frames", 1) == 1
    assert image.frame_count(data) == 1
    _assert_frames(data)
