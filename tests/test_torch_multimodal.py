"""The port's multimodal pieces (dynamo_tpu_torch/multimodal/) held against
the JAX package's on the CPU:

- ``load_image_bytes``, ``MockVisionEncoder`` rows, the ``embeds_to_wire``
  bytes and ``salt_from_wire`` are the reference's bit for bit;
- ``image.preprocess_image`` equals the reference's Pillow-based one: the
  decoded and resized uint8 pixels bit for bit, the normalized f32 within
  NORM_TOL, over a grid of PNGs (every colour type at bit depths 8 and 16,
  1, 2 and 4-bit grey and palette, palette and colour keys with tRNS,
  Adam7, every scanline filter) at sizes 1x1, 17x400, 80x60, 336x336 and
  1000x37. Pillow writes the kinds it can; the rest come from this file's
  own writer (Pillow writes neither Adam7, 16-bit colour nor chosen
  filters), and Pillow decodes them all for the reference;
- JPEG, GIF, WebP and MPO decode to Pillow's pixels
  (tests/test_torch_image_formats.py, test_torch_webp.py and
  test_torch_apng_mpo.py hold the decoders at length); BMP, TIFF, ICO and
  PPM raise ValueError naming their ROADMAP item 12b-iii;
- ``VisionTower`` + ``project`` on the JAX init's tree equal ``vit_forward``
  + ``project`` within TOWER_TOL (f32 on both sides: XLA and PyTorch sum in
  other orders);
- ``params_from_torch`` on a ``transformers`` ``CLIPVisionModel`` (a tiny
  config built here) is the reference's tree bit for bit, and the tower's
  rows equal the model's post-LN ``last_hidden_state`` (class token
  dropped) within TOWER_TOL;
- the preprocessor splices the reference's ids and positions for images,
  videos and a sanitized marker; a text-only card refuses images.
"""

import base64
import io
import struct
import zlib

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from dynamo_tpu.frontend.preprocessor import OpenAIPreprocessor as JaxPreprocessor
from dynamo_tpu.frontend.tokenizer import MockTokenizer as JaxMockTokenizer
from dynamo_tpu.multimodal import encoder as jenc
from dynamo_tpu.multimodal import vit as jvit
from dynamo_tpu.multimodal import worker as jworker
from dynamo_tpu_torch.frontend.preprocessor import OpenAIPreprocessor
from dynamo_tpu_torch.frontend.tokenizer import MockTokenizer
from dynamo_tpu_torch.multimodal import encoder, image, vit, worker

NORM_TOL = 1e-6  # the CLIP mean/std of equal uint8 pixels (both numpy f32)
TOWER_TOL = 2e-5  # f32 rows of magnitude ~1 after the LayerNorms


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------- png writer

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body))


def _filter_rows(px: np.ndarray, depth: int, bpp: int, first_filter: int) -> bytes:
    """Scanlines of ``px [h, w, c]`` packed at ``depth``, each filtered with
    the next filter type in turn (0..4), starting at ``first_filter``."""
    h = px.shape[0]
    if depth == 16:
        rows = px.astype(">u2").reshape(h, -1).view(np.uint8)
    elif depth == 8:
        rows = px.astype(np.uint8).reshape(h, -1)
    else:
        vals = px.reshape(h, -1).astype(np.uint8)
        bits = ((vals[..., None] >> np.arange(depth - 1, -1, -1)) & 1).reshape(h, -1)
        rows = np.packbits(bits, axis=1)
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int64)
    for r in range(h):
        line = rows[r].astype(np.int64)
        ftype = (first_filter + r) % 5
        left = np.concatenate([np.zeros(bpp, np.int64), line[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(line)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prior
        elif ftype == 3:
            pred = (left + prior) >> 1
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(ftype)
        out += ((line - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = line
    return bytes(out)


def write_png(px: np.ndarray, ctype: int, depth: int, *, interlace: bool = False,
              palette: np.ndarray | None = None, trns: bytes | None = None,
              first_filter: int = 0) -> bytes:
    h, w, c = px.shape
    bpp = max(1, c * depth // 8)
    if interlace:
        raw = b"".join(
            _filter_rows(px[y0::dy, x0::dx], depth, bpp, first_filter + i)
            for i, (x0, y0, dx, dy) in enumerate(_ADAM7)
            if x0 < w and y0 < h)
    else:
        raw = _filter_rows(px, depth, bpp, first_filter)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, 1 if interlace else 0))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    return out + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _pillow_png(im: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    im.save(buf, format="PNG", **kw)
    return buf.getvalue()


def _content(rng, h, w, c, hi=255):
    """Noise in half the image and a gradient in the other half: edges and
    smooth ramps for the cubic."""
    noise = rng.integers(0, hi + 1, (h, w, c))
    ramp = (np.add.outer(np.arange(h), np.arange(w))[..., None] * hi
            // max(1, h + w - 2)) + np.arange(c) * 7
    px = np.where((np.arange(w) < w // 2)[None, :, None], noise, ramp % (hi + 1))
    return px


def png_grid(w: int, h: int, seed: int = 0) -> dict[str, bytes]:
    rng = np.random.default_rng(seed + 7 * w + h)
    c8 = _content(rng, h, w, 4).astype(np.uint8)
    c16 = _content(rng, h, w, 4, hi=65535).astype(np.uint16)
    pal = rng.integers(0, 256, (16, 3))
    idx = rng.integers(0, 16, (h, w, 1))
    out = {
        "pillow RGB": _pillow_png(Image.fromarray(c8[..., :3], "RGB")),
        "pillow RGBA": _pillow_png(Image.fromarray(c8, "RGBA")),
        "pillow L": _pillow_png(Image.fromarray(c8[..., 0], "L")),
        "pillow LA": _pillow_png(Image.fromarray(c8[..., :2], "LA")),
        "pillow P tRNS": _pillow_png(Image.fromarray(c8[..., :3], "RGB").quantize(32),
                                     transparency=3),
        "pillow I;16": _pillow_png(Image.fromarray((c16[..., 0] // 97).astype(np.uint16))),
        "RGB 16": write_png(c16[..., :3], 2, 16),
        "RGBA 16": write_png(c16, 6, 16, first_filter=1),
        "LA 16": write_png(c16[..., :2], 4, 16, first_filter=2),
        "L 16": write_png(c16[..., :1], 0, 16, first_filter=3),
        "RGB 8 tRNS adam7": write_png(c8[..., :3], 2, 8, interlace=True,
                                      trns=b"\x00\x10\x00\x20\x00\x30"),
        "RGBA 8 adam7": write_png(c8, 6, 8, interlace=True, first_filter=4),
        "P 4-bit tRNS adam7": write_png(idx, 3, 4, interlace=True, palette=pal,
                                        trns=bytes(range(0, 160, 10))),
        "P 2-bit": write_png(idx % 4, 3, 2, palette=pal[:4], first_filter=3),
        "L 1-bit": write_png(c8[..., :1] >> 7, 0, 1, first_filter=1),
        "L 2-bit adam7": write_png(c8[..., :1] >> 6, 0, 2, interlace=True),
        "L 4-bit": write_png(c8[..., :1] >> 4, 0, 4, first_filter=4),
        "LA 8 adam7": write_png(c8[..., :2], 4, 8, interlace=True, first_filter=2),
    }
    return out


def pillow_resized(data: bytes, size: int) -> np.ndarray:
    """The reference's decode, resize and crop, stopped at uint8."""
    img = Image.open(io.BytesIO(data)).convert("RGB")
    w, h = img.size
    short = min(w, h)
    img = img.resize((round(w * size / short), round(h * size / short)), Image.BICUBIC)
    w, h = img.size
    left, top = (w - size) // 2, (h - size) // 2
    return np.asarray(img.crop((left, top, left + size, top + size)))


def port_resized(img: np.ndarray, size: int, window: bool = False) -> np.ndarray:
    """The port's resize of decoded pixels, whole and then cropped as the
    reference crops, or (``window``) only the crop's window, as
    ``preprocess_image`` computes it."""
    h, w = img.shape[:2]
    short = min(w, h)
    w, h = round(w * size / short), round(h * size / short)
    left, top = (w - size) // 2, (h - size) // 2
    box = (left, top, left + size, top + size)
    if window:
        return image.resize_bicubic(img, w, h, box)
    return image.resize_bicubic(img, w, h)[top: top + size, left: left + size]


@pytest.mark.parametrize("size", [(1, 1), (17, 400), (80, 60), (336, 336), (1000, 37)])
def test_preprocess_matches_pillow_bit_for_bit(size):
    """Every PNG of the grid at one size: Pillow's RGB decode, the resized
    and cropped uint8 pixels at 336 (and at the tiny tower's 28, a strong
    reduction), and the reference's normalized f32."""
    w, h = size
    for name, data in png_grid(w, h).items():
        px = image.decode_png(data)
        assert np.array_equal(px, np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))), name
        assert np.array_equal(port_resized(px, 28), pillow_resized(data, 28)), name
        assert np.array_equal(port_resized(px, 336, window=True),
                              pillow_resized(data, 336)), name
        got = image.preprocess_image(data, 336)
        want = jvit.preprocess_image(data, 336)
        assert got.dtype == np.float32 and got.shape == (3, 336, 336)
        np.testing.assert_allclose(got, want, rtol=0, atol=NORM_TOL, err_msg=name)


@pytest.mark.parametrize("shape", [(9, 700), (336, 335), (2, 2), (451, 229)])
def test_resize_matches_pillow_up_and_down(shape):
    """resize_bicubic alone on noise, at odd sizes, upscales, downscales and
    extreme aspect ratios, against Image.resize."""
    h, w = shape
    px = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), dtype=np.uint8)
    for ow, oh in ((336, 336), (w * 3 + 1, h), (w, max(1, h // 5)), (13, 1009), (1, 1)):
        want = np.asarray(Image.fromarray(px, "RGB").resize((ow, oh), Image.BICUBIC))
        assert np.array_equal(image.resize_bicubic(px, ow, oh), want), (ow, oh)
        box = (ow // 3, oh // 4, ow - ow // 5, oh)  # a window computed alone
        assert np.array_equal(image.resize_bicubic(px, ow, oh, box),
                              want[box[1]:box[3], box[0]:box[2]]), (ow, oh)


@pytest.mark.parametrize("fmt", ["JPEG", "GIF", "WEBP", "BMP", "TIFF", "MPO", "ICO", "PPM"])
def test_other_formats_raise_naming_the_item(fmt):
    """JPEG, GIF, WebP and MPO decode as the reference's Pillow does; the
    formats left unported, which Pillow opens, raise naming their item."""
    rng = np.random.default_rng(12)
    im = Image.fromarray(_content(rng, 8, 8, 3).astype(np.uint8), "RGB")
    buf = io.BytesIO()
    kw = {"MPO": dict(save_all=True, append_images=[im.rotate(90)]),
          "ICO": dict(sizes=[(8, 8)])}.get(fmt, {})
    im.save(buf, format=fmt, **kw)
    data = buf.getvalue()
    Image.open(io.BytesIO(data)).convert("RGB")
    if fmt in ("JPEG", "GIF", "WEBP", "MPO"):
        assert np.array_equal(image.decode_image(data)[0],
                              np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
        assert np.array_equal(image.preprocess_image(data, 336),
                              jvit.preprocess_image(data, 336))
        return
    with pytest.raises(ValueError, match="item 12b-iii"):
        image.preprocess_image(data, 336)


def test_malformed_png_raises_value_error():
    data = png_grid(5, 4)["RGB 16"]
    for bad in (b"not an image", data[:40], data[:-20] + b"\x00" * 20):
        with pytest.raises(ValueError, match="undecodable image bytes"):
            image.preprocess_image(bad, 28)


def _edge_pngs() -> dict[str, bytes]:
    rng = np.random.default_rng(11)
    tall = _content(rng, 1100, 7, 3).astype(np.uint8)
    px = rng.integers(0, 256, (4, 5, 3), dtype=np.uint8)
    rows = b"".join(b"\x00" + px[r].tobytes() for r in range(4))
    return {
        # more rows than one wavefront band, every filter type in turn
        "tall, all filters": write_png(tall, 2, 8, first_filter=3),
        "Pillow's RGB, 1,030 rows": _pillow_png(Image.fromarray(
            _content(rng, 1030, 90, 3).astype(np.uint8), "RGB")),
        # image data past the scanlines: Pillow ignores it, and so does the
        # port, without inflating it
        "surplus data": b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
            ">IIBBBBB", 5, 4, 8, 2, 0, 0, 0)) + _chunk(
            b"IDAT", zlib.compress(rows + bytes(1 << 20))) + _chunk(b"IEND", b""),
    }


@pytest.mark.parametrize("case", list(_edge_pngs()))
def test_png_edge_cases_match_pillow(case):
    data = _edge_pngs()[case]
    assert np.array_equal(image.decode_png(data),
                          np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))
    np.testing.assert_allclose(image.preprocess_image(data, 28),
                               jvit.preprocess_image(data, 28), rtol=0, atol=NORM_TOL)


def test_decompression_bomb_is_refused_as_the_reference():
    """Past Pillow's pixel limit the image is refused before anything is
    inflated, with the reference's error text."""
    side = 15000  # 225M pixels > 2 * MAX_IMAGE_PIXELS
    bomb = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(
        ">IIBBBBB", side, side, 1, 0, 0, 0, 0)) + _chunk(
        b"IDAT", zlib.compress(bytes(side // 8 + 1) * 64)) + _chunk(b"IEND", b"")
    assert image.MAX_IMAGE_PIXELS == Image.MAX_IMAGE_PIXELS
    with pytest.raises(ValueError) as want:
        jvit.preprocess_image(bomb, 28)
    with pytest.raises(ValueError) as got:
        image.preprocess_image(bomb, 28)
    assert str(got.value) == str(want.value)
    assert "decompression bomb" in str(got.value)


# ------------------------------------------------------------ wire + mock


def test_load_image_bytes_and_mock_rows_match_the_reference(tmp_path, monkeypatch):
    data = png_grid(3, 2)["pillow RGB"]
    urls = ["data:image/png;base64," + base64.b64encode(data).decode(),
            "data:text/plain,raw-bytes"]
    for url in urls:
        assert encoder.load_image_bytes(url) == jenc.load_image_bytes(url)
    path = tmp_path / "a.png"
    path.write_bytes(data)
    for env, ok in ((None, False), ("1", True), ("true", True)):
        if env is None:
            monkeypatch.delenv("DYNAMO_MM_ALLOW_FILE_URLS", raising=False)
        else:
            monkeypatch.setenv("DYNAMO_MM_ALLOW_FILE_URLS", env)
        if ok:
            assert encoder.load_image_bytes(f"file://{path}") == data
        else:
            with pytest.raises(ValueError, match="disabled"):
                encoder.load_image_bytes(f"file://{path}")
    for url in ("http://example.invalid/x.png", "data:nocomma"):
        with pytest.raises(ValueError) as got:
            encoder.load_image_bytes(url)
        with pytest.raises(ValueError) as want:
            jenc.load_image_bytes(url)
        assert str(got.value) == str(want.value)
    imgs = [data, b"other", data]
    rows = encoder.MockVisionEncoder(24, 3, scale=0.5).encode(imgs)
    ref = jenc.MockVisionEncoder(24, 3, scale=0.5).encode(imgs)
    assert rows.dtype == np.float32 and rows.tobytes() == ref.tobytes()
    assert encoder.MockVisionEncoder(8).encode([]).shape == (0, 8)
    wire = worker.embeds_to_wire(rows)
    assert wire == jworker.embeds_to_wire(ref)
    assert worker.salt_from_wire(wire) == jworker.salt_from_wire(wire)
    assert worker.embeds_from_wire(wire).tobytes() == rows.tobytes()
    # a tensor's rows (the tower's output) give the same bytes
    assert worker.embeds_to_wire(torch.from_numpy(rows).numpy()) == wire


# ------------------------------------------------------------------ tower


def _jax_tree(spec, seed=0):
    return jax.tree.map(np.asarray, jvit.init_vit_params(spec, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("projector", [False, True])
def test_tower_matches_the_reference(projector):
    """VisionTower (+ project) on the JAX init's params and the same pixels
    equals vit_forward (+ project); VitEncoder.encode on PNG bytes equals
    the reference's VitEncoder.encode."""
    spec = vit.VitSpec.tiny()
    if projector:
        spec = vit.VitSpec(**{**vit.VitSpec.tiny().__dict__, "projector_hidden": 40,
                              "llm_hidden": 48})
    jspec = jvit.VitSpec(**spec.__dict__)
    tree = _jax_tree(jspec, seed=int(projector))
    imgs = [png_grid(30, 20, seed=i)["pillow RGB"] for i in range(3)]
    pixels = np.stack([jvit.preprocess_image(b, spec.image_size) for b in imgs])
    want = np.asarray(jvit.vit_forward(jspec, tree, pixels))
    params = vit.params_from_numpy(tree)
    tower = vit.VisionTower(spec, params)
    with torch.inference_mode():
        got = tower(torch.from_numpy(pixels))
        assert got.shape == (3, spec.tokens_per_image, spec.hidden_size)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOWER_TOL)
        if projector:
            pw = np.asarray(jvit.project(tree["projector"], want))
            pg = vit.project(params["projector"], torch.from_numpy(want)).numpy()
            np.testing.assert_allclose(pg, pw, rtol=0, atol=TOWER_TOL)
    enc = vit.VitEncoder(spec, params, device="cpu")
    ref = jvit.VitEncoder(jspec, tree)
    assert enc.hidden_size == ref.hidden_size == (48 if projector else 32)
    np.testing.assert_allclose(enc.encode(imgs), ref.encode(imgs), rtol=0, atol=TOWER_TOL)


def test_seeded_tower_is_deterministic_and_refuses_a_missing_gpu():
    spec = vit.VitSpec.tiny()
    a = vit.VitEncoder(spec, device="cpu", generator=torch.Generator().manual_seed(4))
    b = vit.VitEncoder(spec, device="cpu", generator=torch.Generator().manual_seed(4))
    img = [png_grid(9, 9)["pillow L"]]
    assert np.array_equal(a.encode(img), b.encode(img))
    assert a.encode([]).shape == (0, 32)
    with pytest.raises(ValueError, match="needs a generator"):
        vit.VitEncoder(spec, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            vit.VitEncoder(spec)


def _clip_model():
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(0)
    cfg = CLIPVisionConfig(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
                           num_attention_heads=4, image_size=28, patch_size=14,
                           hidden_act="quick_gelu", layer_norm_eps=1e-5)
    model = CLIPVisionModel(cfg).eval()
    with torch.no_grad():  # non-trivial LayerNorms and biases
        for name, p in model.named_parameters():
            if "norm" in name or name.endswith("bias"):
                p.add_(torch.randn_like(p) * 0.1)
    return cfg, model


def test_params_from_torch_matches_the_reference_and_transformers():
    cfg, model = _clip_model()
    sd = model.state_dict()
    spec = vit.VitSpec.from_hf_config(cfg.to_dict())
    jspec = jvit.VitSpec.from_hf_config(cfg.to_dict())
    assert spec.__dict__ == jspec.__dict__
    got = vit.params_from_torch(spec, sd)
    want = jax.tree.map(np.asarray, jvit.params_from_torch(jspec, sd))
    gl, gt = jax.tree.flatten(jax.tree.map(lambda t: t.numpy(), got))
    wl, wt = jax.tree.flatten(want)
    assert gt == wt
    assert all(g.dtype == w.dtype and np.array_equal(g, w) for g, w in zip(gl, wl))
    imgs = [png_grid(40, 31, seed=i)["pillow RGBA"] for i in range(2)]
    pixels = torch.from_numpy(np.stack([image.preprocess_image(b, 28) for b in imgs]))
    with torch.no_grad():
        out = model(pixel_values=pixels)
        hf_rows = model.vision_model.post_layernorm(out.last_hidden_state)[:, 1:]
        rows = vit.VisionTower(spec, got)(pixels)
    np.testing.assert_allclose(rows.numpy(), hf_rows.numpy(), rtol=0, atol=TOWER_TOL)
    # a LLaVA layout: prefixed tower keys and a projector, mapped as the
    # reference maps them
    llava = {"vision_tower." + k: v for k, v in sd.items()}
    llava["multi_modal_projector.linear_1.weight"] = torch.randn(40, 32)
    llava["multi_modal_projector.linear_1.bias"] = torch.randn(40)
    llava["multi_modal_projector.linear_2.weight"] = torch.randn(48, 40)
    llava["multi_modal_projector.linear_2.bias"] = torch.randn(48)
    got = vit.params_from_torch(spec, llava)
    want = jvit.params_from_torch(jspec, llava)
    for k in ("w1", "b1", "w2", "b2"):
        assert np.array_equal(got["projector"][k].numpy(), np.asarray(want["projector"][k]))
    assert vit.VitEncoder.from_torch(spec, llava, device="cpu").hidden_size == 48
    bad = vit.VitSpec(**{**spec.__dict__, "image_size": 42})
    with pytest.raises(ValueError, match="geometry mismatch"):
        vit.params_from_torch(bad, sd)


# ------------------------------------------------------------ preprocessor

IMG = "data:image/png;base64,AAAA"


def _chat(*parts, system=None):
    msgs = [{"role": "system", "content": system}] if system else []
    return {"model": "m", "messages": msgs + [{"role": "user", "content": list(parts)}]}


def _pre(cls, tok, **mm):
    return cls(tok, model_name="m", context_length=4096, **mm)


@pytest.mark.parametrize("case", ["one image", "two images", "video", "marker",
                                  "text only"])
def test_preprocessor_splices_the_reference_ids_and_positions(case):
    text = {"type": "text", "text": "describe <|mm_image|>this"}
    img = {"type": "image_url", "image_url": {"url": IMG}}
    vid = {"type": "video_url", "video_url": {"url": IMG + "v"}}
    body = {
        "one image": _chat(text, img),
        "two images": _chat(img, {"type": "text", "text": "and"}, img),
        "video": _chat(vid, text, img),
        "marker": {"model": "m", "messages": [
            {"role": "system", "content": "sys <|mm_image|> keep"},
            {"role": "user", "content": [img, {"type": "text", "text": "x<|mm_image|>y"}]}]},
        "text only": _chat(text),
    }[case]
    mm = dict(mm_tokens_per_image=3, image_token_id=5, mm_video_frames=2)
    got = _pre(OpenAIPreprocessor, MockTokenizer(), **mm).preprocess(body)
    want = _pre(JaxPreprocessor, JaxMockTokenizer(), **mm).preprocess(body)
    assert got == want
    if case == "text only":
        assert "multimodal" not in got
    else:
        pos = got["multimodal"]["positions"]
        assert [got["token_ids"][p] for p in pos] == [5] * len(pos)
    if case == "video":
        assert len(got["multimodal"]["positions"]) == 3 * 2 + 3
        assert got["multimodal"]["images"][0] == {"url": IMG + "v", "kind": "video"}


def test_text_only_card_refuses_media_as_the_reference():
    img = {"type": "image_url", "image_url": {"url": IMG}}
    vid = {"type": "video_url", "video_url": {"url": IMG}}
    for body, mm in ((_chat(img), {}), (_chat(vid), {"mm_tokens_per_image": 2}),
                     (_chat({"type": "image_url", "image_url": {}}),
                      {"mm_tokens_per_image": 2}),
                     (_chat({"type": "audio"}), {"mm_tokens_per_image": 2})):
        with pytest.raises(ValueError) as got:
            _pre(OpenAIPreprocessor, MockTokenizer(), **mm).preprocess(body)
        with pytest.raises(ValueError) as want:
            _pre(JaxPreprocessor, JaxMockTokenizer(), **mm).preprocess(body)
        assert str(got.value) == str(want.value)
