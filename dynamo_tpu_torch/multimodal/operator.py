"""MultimodalEncode operator: the frontend half of the EPD encode hop (the
counterpart of dynamo_tpu/multimodal/operator.py).

It sits in the model pipeline between the backend op and migration
(Backend -> MultimodalEncode -> Migration -> router): a request whose
preprocessed form carries image refs has them resolved to ONE embeddings
tensor by the encode worker before routing, once per request, so a migration
retry reuses the encoded rows. It sets the router-visible ``salt`` (the KV
router's overlap estimate hashes under it) from ``salt_from_wire``.
"""

from __future__ import annotations

import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch.multimodal.worker import salt_from_wire
from dynamo_tpu_torch.runtime.context import Context

log = logging.getLogger("dynamo_tpu_torch.mm.op")


class MultimodalEncode:
    def __init__(self, downstream, *, encode_router):
        self.downstream = downstream
        self.encode_router = encode_router

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        mm = request.get("multimodal")
        if mm and mm.get("images") and "embeds_b64" not in mm:
            resp: dict[str, Any] | None = None
            try:
                async for item in self.encode_router.generate(
                    {"images": mm["images"]}, context.child(f"{context.id}-enc"),
                ):
                    resp = item
                    break
            except Exception as e:  # noqa: BLE001
                log.exception("encode worker call failed")
                yield {"token_ids": [], "finish_reason": "error",
                       "error": f"image encoding unavailable: {e}"}
                return
            if not resp or resp.get("error"):
                yield {"token_ids": [], "finish_reason": "error",
                       "error": (resp or {}).get("error", "empty encode reply")}
                return
            # the config-skew check at the hop, not deep in the engine: the
            # encoder's rows per attachment must match the card's placeholder
            # span (a video counts frames x rows per image); an explicit
            # video_frames of 0 is itself the skew this surfaces
            tpi = resp.get("tokens_per_image")
            vf = int(resp.get("video_frames", 1))
            n_pos = len(mm.get("positions") or ())
            n_units = sum(
                vf if isinstance(a, dict) and a.get("kind") == "video" else 1
                for a in mm["images"]
            )
            if tpi and n_pos and n_units * int(tpi) != n_pos:
                yield {
                    "token_ids": [], "finish_reason": "error",
                    "error": (
                        f"encoder produces {tpi} rows/image x {n_units} "
                        f"frame(s) but the model card spliced {n_pos} "
                        "placeholder tokens — align --tokens-per-image/"
                        "--video-frames with the card's "
                        "mm_tokens_per_image/mm_video_frames"
                    ),
                }
                return
            missing = [k for k in ("embeds_b64", "shape", "dtype") if k not in resp]
            if missing:
                yield {"token_ids": [], "finish_reason": "error",
                       "error": f"malformed encode reply: missing {missing}"}
                return
            enriched = {k: resp[k] for k in ("embeds_b64", "shape", "dtype")}
            # the digest the engine salts its block hashes with: the KV
            # router needs it to estimate overlap correctly
            enriched["salt"] = salt_from_wire(resp)
            request = {
                **request,
                # the raw image refs stay behind; the engine sees embeddings
                "multimodal": {
                    **{k: v for k, v in mm.items() if k != "images"},
                    **enriched,
                },
            }
        async for item in self.downstream.generate(request, context):
            yield item


def make_operator(sink, **kwargs) -> "MultimodalEncode":
    return MultimodalEncode(sink, **kwargs)
