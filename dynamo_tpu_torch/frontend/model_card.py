"""ModelDeploymentCard + worker-side registration (a copy of
dynamo_tpu/frontend/model_card.py).

A card describes everything the frontend needs to serve a model: tokenizer
spec, context window, KV block size, router preferences, migration limit.
Workers write their card to the hub under ``v1/mdc/{ns}/{component}/{endpoint}``
bound to their lease (ref: lib/llm/src/model_card.rs:118
ModelDeploymentCard, local_model.rs:418 attach; etcd path v1/mdc).

A card built without a router mode says "round_robin" (the reference's
dataclass says "kv"); ``register_llm`` and the workers register "kv" by
default, as the reference's, and the watcher builds a KV router for it.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import TYPE_CHECKING, Any

if TYPE_CHECKING:
    from dynamo_tpu_torch.runtime.component import Endpoint
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

MDC_ROOT = "v1/mdc"


@dataclass
class ModelDeploymentCard:
    name: str  # served model name (what clients put in "model")
    namespace: str
    component: str
    endpoint: str
    model_type: str = "chat"  # "chat" | "completions" | "embeddings" (chat serves both chat+completions)
    model_input: str = "tokens"  # "tokens" | "text"
    tokenizer: str = "mock"  # "mock" or local HF path
    context_length: int = 8192
    kv_block_size: int = 16
    migration_limit: int = 3
    router_mode: str = "round_robin"  # "kv" | "round_robin" | "random"
    chat_template: str | None = None
    tool_call_parser: str | None = None  # parsers.TOOL_PARSERS key
    reasoning_parser: str | None = None  # parsers.REASONING_PARSERS key
    # multimodal: placeholder tokens spliced per image (0 = text-only);
    # the engine overwrites them with encoder embedding rows at prefill
    mm_tokens_per_image: int = 0
    image_token_id: int = 0
    # frames sampled per video attachment (0 = video input rejected);
    # each frame occupies mm_tokens_per_image placeholder rows
    mm_video_frames: int = 0
    runtime_config: dict[str, Any] = field(default_factory=dict)

    def key_for(self, instance_id: int) -> str:
        """Per-instance card key: each worker's card is bound to its own
        lease, so the model only disappears when the last worker does."""
        return (
            f"{MDC_ROOT}/{self.namespace}/{self.component}/"
            f"{self.endpoint}/{instance_id:x}"
        )

    @property
    def component_path(self) -> str:
        return f"{self.namespace}/{self.component}"

    def to_dict(self) -> dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict[str, Any]) -> "ModelDeploymentCard":
        known = {f for f in cls.__dataclass_fields__}  # noqa: C416
        return cls(**{k: v for k, v in d.items() if k in known})


async def register_llm(
    drt: "DistributedRuntime",
    endpoint: "Endpoint",
    handler,
    *,
    model_name: str,
    model_type: str = "chat",
    tokenizer: str = "mock",
    context_length: int = 8192,
    kv_block_size: int = 16,
    migration_limit: int = 3,
    router_mode: str = "kv",
    tool_call_parser: str | None = None,
    reasoning_parser: str | None = None,
    mm_tokens_per_image: int = 0,
    image_token_id: int = 0,
    mm_video_frames: int = 0,
    runtime_config: dict[str, Any] | None = None,
    metadata: dict[str, Any] | None = None,
):
    """Worker-side one-call registration: serve the endpoint + publish the card.

    Ref: Python binding ``register_llm`` (lib/bindings/python/rust/lib.rs:180)
    followed by ``serve_endpoint`` (:618).
    """
    card = ModelDeploymentCard(
        name=model_name,
        namespace=endpoint.namespace,
        component=endpoint.component,
        endpoint=endpoint.name,
        model_type=model_type,
        tokenizer=tokenizer,
        context_length=context_length,
        kv_block_size=kv_block_size,
        migration_limit=migration_limit,
        router_mode=router_mode,
        tool_call_parser=tool_call_parser,
        reasoning_parser=reasoning_parser,
        mm_tokens_per_image=mm_tokens_per_image,
        image_token_id=image_token_id,
        mm_video_frames=mm_video_frames,
        runtime_config=runtime_config or {},
    )
    served = await endpoint.serve(
        handler, metadata={"model": model_name, **(metadata or {})}
    )
    lease = await drt.lease_id()
    await drt.hub.put(
        card.key_for(served.instance.instance_id), card.to_dict(), lease_id=lease
    )
    return served, card
