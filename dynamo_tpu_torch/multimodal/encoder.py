"""Image fetch and the mock vision encoder of the multimodal EPD path (the
counterpart of dynamo_tpu/multimodal/encoder.py).

``MockVisionEncoder`` is the test encoder: deterministic rows seeded by the
image CONTENT digest (a sha256-seeded numpy generator, the reference's bits),
so the same image always gives the same rows and different images change
the model's output. The ViT tower (multimodal/vit.py) serves behind the same
``encode`` interface.

Images arrive as OpenAI ``image_url`` values: ``data:`` URIs (base64), and
local ``file://`` paths behind ``DYNAMO_MM_ALLOW_FILE_URLS``; http(s) URLs
raise. ``sample_video_frames`` is the reference's: frames sampled from an
animated GIF (or a still PNG, JPEG or GIF repeated), each re-encoded as the
PNG bytes Pillow writes (image.py), so the mock encoder's digest-seeded
rows and the worker's frame deduplication see the reference's bytes.
Animated WebP and PNG raise ValueError naming their ROADMAP item.
"""

from __future__ import annotations

import base64
import hashlib
import os

import numpy as np

from dynamo_tpu_torch.multimodal import image

__all__ = ["MockVisionEncoder", "load_image_bytes", "sample_video_frames"]


def sample_video_frames(data: bytes, n_frames: int) -> list[bytes]:
    """``n_frames`` frames sampled uniformly from an animated GIF, WebP or
    PNG or an MPO, each as the PNG bytes of Pillow's
    ``convert("RGB").save(format="PNG")``; a still image gives its one
    frame ``n_frames`` times. The reference's indices, endpoints included:
    ``round(i * (total - 1) / (n_frames - 1))``; frames are decoded forward
    only as far as the last of them. Raises ``ValueError("undecodable
    video bytes ...")``."""
    try:
        total = image.frame_count(data)
        if n_frames == 1 or total == 1:
            idx = [0] * n_frames
        else:
            idx = [round(i * (total - 1) / (n_frames - 1)) for i in range(n_frames)]
        pngs = {k: image.encode_png(rgb, info.get("transparency"), info.get("icc_profile"))
                for k, rgb, info in image.frames(data, idx)}
        return [pngs[i] for i in idx]
    except Exception as e:  # noqa: BLE001 - a malformed or unported file of any kind
        raise ValueError(f"undecodable video bytes ({image.DECODED} are decoded by this "
                         f"port): {e}") from e


def load_image_bytes(url: str) -> bytes:
    """Fetch one image's raw bytes from a data: URI or file:// path."""
    if url.startswith("data:"):
        # data:[<mediatype>][;base64],<payload>
        try:
            header, payload = url.split(",", 1)
        except ValueError as e:
            raise ValueError(f"malformed data URI: {url[:40]}...") from e
        if ";base64" in header:
            return base64.b64decode(payload)
        return payload.encode()
    if url.startswith("file://"):
        # a file read from untrusted request input is an arbitrary-file
        # oracle on the encode worker's host: explicit opt-in only
        if os.environ.get("DYNAMO_MM_ALLOW_FILE_URLS") not in ("1", "true"):
            raise ValueError(
                "file:// image_url is disabled "
                "(set DYNAMO_MM_ALLOW_FILE_URLS=1 to opt in)"
            )
        with open(url[len("file://"):], "rb") as f:
            return f.read()
    raise ValueError(
        "only data: URIs and file:// paths are supported for image_url "
        f"(got {url[:40]!r}...)"
    )


class MockVisionEncoder:
    """Deterministic content-seeded embeddings: [tokens_per_image, hidden]
    rows per image, unit-scale normal values from a digest-seeded RNG."""

    def __init__(self, hidden_size: int, tokens_per_image: int = 4,
                 scale: float = 1.0):
        self.hidden_size = hidden_size
        self.tokens_per_image = tokens_per_image
        self.scale = scale

    def encode(self, images: list[bytes]) -> np.ndarray:
        """-> [n_images * tokens_per_image, hidden_size] float32."""
        rows = []
        for img in images:
            seed = int.from_bytes(hashlib.sha256(img).digest()[:8], "little")
            rng = np.random.default_rng(seed)
            rows.append(
                rng.standard_normal(
                    (self.tokens_per_image, self.hidden_size)
                ).astype(np.float32) * self.scale
            )
        if not rows:
            return np.zeros((0, self.hidden_size), np.float32)
        return np.concatenate(rows, axis=0)
