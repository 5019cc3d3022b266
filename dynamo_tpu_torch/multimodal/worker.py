"""Encode worker: the E of the multimodal EPD pipeline (the counterpart of
dynamo_tpu/multimodal/worker.py).

A runtime component (namespace/encoder/encode) that turns a request's image
refs into one embeddings tensor, returned base64 (float32, little-endian)
over the push transport. The frontend's MultimodalEncode operator calls it
before routing; the engine injects the rows at the prompt's placeholder
positions. The wire payload, its salt and the worker's metadata are the
reference's byte for byte, so either package's frontend and engine talk to
either package's encode worker.

Run: ``python -m dynamo_tpu_torch.multimodal.worker --hub HOST:PORT
--hidden-size 4096 --encoder vit`` (or ``python -m dynamo_tpu_torch.cli
encoder ...``); ``--device cpu`` runs the tower on the CPU (default: the
GPU). Prints ``ENCODER_READY`` once registered. A ``kind: "video"``
attachment is sampled into ``video_frames`` PNG frames
(encoder.sample_video_frames), each encoded like an image.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import hashlib
import logging
import signal
from typing import Any

import numpy as np

from dynamo_tpu_torch.multimodal.encoder import (
    MockVisionEncoder,
    load_image_bytes,
    sample_video_frames,
)

log = logging.getLogger("dynamo_tpu_torch.mm.worker")

ENCODER_COMPONENT = "encoder"
ENCODER_ENDPOINT = "encode"


def embeds_to_wire(arr: np.ndarray) -> dict[str, Any]:
    """[n, d] rows -> the wire dict: base64 of the float32 little-endian
    bytes, the shape and the dtype name. Pass host arrays (a CUDA tensor goes
    ``.cpu()`` first)."""
    arr = np.ascontiguousarray(arr, dtype="<f4")
    return {
        "embeds_b64": base64.b64encode(arr.tobytes()).decode(),
        "shape": list(arr.shape),
        "dtype": "float32",
    }


def embeds_from_wire(d: dict[str, Any]) -> np.ndarray:
    return np.frombuffer(
        base64.b64decode(d["embeds_b64"]), dtype=np.dtype(d["dtype"])
    ).reshape(d["shape"])


def salt_from_wire(d: dict[str, Any]) -> str:
    """Cache-partition salt of a wire payload: the embedding digest. The one
    definition: the operator (the router-visible salt) and the engine (the
    block-hash salt) must agree bit for bit."""
    return hashlib.sha256(base64.b64decode(d["embeds_b64"])).hexdigest()[:16]


async def launch_encode_worker(
    drt,
    *,
    namespace: str = "dynamo",
    hidden_size: int,
    tokens_per_image: int = 4,
    encoder=None,
    video_frames: int = 8,
):
    """Serve the encode endpoint on ``drt``; returns the served handle.

    Attachments are image URLs (str) or ``{"url": ..., "kind": ...}`` dicts;
    a video is sampled into ``video_frames`` stills, each encoded as an
    image. Each unique image or frame is encoded once and its rows tiled
    where it repeats."""
    if video_frames < 1:
        raise ValueError(
            "video_frames must be >= 1 (a zero-frame video would "
            "silently contribute no rows and desync placeholder counts)"
        )
    enc = encoder or MockVisionEncoder(hidden_size, tokens_per_image)
    hidden_size = getattr(enc, "hidden_size", hidden_size)

    def encode(atts: list) -> np.ndarray:
        images: list[bytes] = []
        for a in atts:
            if isinstance(a, dict) and a.get("kind") == "video":
                images.extend(sample_video_frames(load_image_bytes(a["url"]), video_frames))
            else:
                images.append(load_image_bytes(a["url"] if isinstance(a, dict) else a))
        uniq: dict[bytes, int] = {}
        order = [uniq.setdefault(b, len(uniq)) for b in images]
        uniq_rows = enc.encode(list(uniq))
        tpi = enc.tokens_per_image
        if not order:
            return uniq_rows
        return np.concatenate([uniq_rows[i * tpi:(i + 1) * tpi] for i in order])

    async def handler(request: dict, context):
        try:
            # the tower's forward (and the image decodes) off the event loop
            rows = await asyncio.to_thread(encode, list(request.get("images") or []))
        except Exception as e:  # noqa: BLE001
            yield {"error": f"image encode failed: {e}"}
            return
        out = embeds_to_wire(rows)
        out["tokens_per_image"] = enc.tokens_per_image
        out["video_frames"] = video_frames
        yield out

    ep = drt.namespace(namespace).component(ENCODER_COMPONENT).endpoint(ENCODER_ENDPOINT)
    return await ep.serve(
        handler,
        metadata={
            "role": "encoder",
            "tokens_per_image": enc.tokens_per_image,
            "hidden_size": hidden_size,
            "video_frames": video_frames,
        },
    )


def _build_vit(args):
    """The ViT tower (multimodal/vit.py) on ``args.device``. A checkpoint is
    a torch state dict of a CLIPVisionModel; without one the tower is the
    random init from a generator seeded with 0. When the LLM hidden differs
    from the vision hidden, a LLaVA-style projector bridges them."""
    from dataclasses import replace

    import torch

    from dynamo_tpu_torch.multimodal.vit import VitEncoder, VitSpec

    spec = VitSpec.tiny() if args.vit_size == "tiny" else VitSpec()
    if args.hidden_size != spec.hidden_size:
        spec = replace(spec, projector_hidden=spec.hidden_size,
                       llm_hidden=args.hidden_size)
    if args.vit_checkpoint:
        sd = torch.load(args.vit_checkpoint, map_location="cpu", weights_only=True)
        return VitEncoder.from_torch(spec, sd, device=args.device)
    return VitEncoder(spec, device=args.device,
                      generator=torch.Generator().manual_seed(0))


async def _amain(args) -> None:
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import connect_hub

    # the tower (and its device check) before the worker registers
    encoder = _build_vit(args) if args.encoder == "vit" else None
    rcfg = RuntimeConfig.from_env()
    if args.hub:
        rcfg.override_hub(args.hub)
    drt = DistributedRuntime(await connect_hub(rcfg.hub_target()), rcfg)
    try:
        await launch_encode_worker(
            drt,
            namespace=args.namespace,
            hidden_size=args.hidden_size,
            tokens_per_image=args.tokens_per_image,
            encoder=encoder,
            video_frames=args.video_frames,
        )
        print("ENCODER_READY", flush=True)
        # SIGTERM: withdraw from the hub and exit 0
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, drt.runtime.shutdown)
        await drt.runtime.wait_for_shutdown()
    finally:
        await drt.close()


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("python -m dynamo_tpu_torch.cli encoder")
    p.add_argument("--hub", required=True)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--hidden-size", type=int, required=True)
    p.add_argument("--tokens-per-image", type=int, default=4)
    p.add_argument("--video-frames", type=int, default=8,
                   help="frames per video attachment (the card's mm_video_frames)")
    p.add_argument("--encoder", default="mock", choices=("mock", "vit"))
    p.add_argument("--vit-size", default="clip-l", choices=("clip-l", "tiny"))
    p.add_argument("--vit-checkpoint", default="",
                   help="torch state_dict (.pt) of a CLIPVisionModel")
    p.add_argument("--device", default=None,
                   help="torch device of the ViT tower (default: the GPU)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
