"""Engine worker: build the torch engine and serve it (the counterpart of
dynamo_tpu/engine/worker.py, aggregated mode).

``launch_engine_worker`` builds ``InferenceEngine(spec, cfg, device=...)``,
optionally captures its decode graphs (``precompile``) off the event loop,
registers the model card and the ``generate`` endpoint, serves the
``admin`` endpoint (``clear_kv_blocks``, ``cache_status``) and starts the
engine's step thread on the calling loop: the step thread posts its tokens
to the loop that started it, so run the worker and the HTTP frontend on one
loop.

The default router mode is "round_robin" (the reference's is "kv") until
the KV router and the KV-event publisher are ported (ROADMAP Queue A item
4b). Not in this slice: the worker process entry point (it needs the TCP
hub, 4b), KV-event and metrics publishers, health server, drain, faults and
timeline admin ops, disagg, KVBM, SPMD, speculative and guided decoding.
"""

from __future__ import annotations

import asyncio
import logging

import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.frontend.model_card import register_llm
from dynamo_tpu_torch.frontend.tokenizer import load_tokenizer
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime

log = logging.getLogger("dynamo_tpu_torch.engine.worker")


async def launch_engine_worker(
    drt: DistributedRuntime,
    *,
    namespace: str = "dynamo",
    component: str = "backend",
    endpoint: str = "generate",
    model: str = "tiny-test",
    model_name: str | None = None,
    model_type: str = "chat",
    tokenizer: str = "mock",
    engine_config: EngineConfig | None = None,
    spec: ModelSpec | None = None,
    router_mode: str = "round_robin",
    precompile: bool = False,
    device: str | torch.device | None = None,
    params=None,
) -> tuple[InferenceEngine, object]:
    """Build + register one aggregated engine worker in this process, on
    ``device`` (None = the GPU; no GPU raises), serving ``params`` (default:
    the seeded random init of ``engine_config.seed``). Returns (engine,
    served generate endpoint)."""
    if router_mode == "kv":
        raise NotImplementedError(
            "router_mode 'kv' needs the KV router and the KV-event publisher "
            "(ROADMAP Queue A item 4b); use 'round_robin'"
        )
    if model_type not in ("chat", "completions"):
        raise NotImplementedError(
            f"model_type {model_type!r}: the port serves chat and completions "
            "models (embeddings are ROADMAP Queue A item 14)"
        )
    load_tokenizer(tokenizer)  # a tokenizer the frontend cannot load fails here
    cfg = engine_config or EngineConfig()
    spec = spec or ModelSpec.preset(model)
    engine = InferenceEngine(spec, cfg, params=params, device=device)
    if precompile:
        # capture every decode graph variant before registration, off the
        # event loop: no request waits for a capture
        await asyncio.to_thread(engine.precompile)

    served, _card = await register_llm(
        drt, drt.namespace(namespace).component(component).endpoint(endpoint),
        engine.generate,
        model_name=model_name or spec.name,
        model_type=model_type,
        tokenizer=tokenizer,
        context_length=cfg.max_context,
        kv_block_size=cfg.page_size,
        router_mode=router_mode,
        runtime_config={"engine": "torch", "device": str(engine.device)},
        metadata={"engine": "torch", "role": "aggregated"},
    )

    # admin endpoint: control-plane ops; endpoint-scoped instance keys keep
    # it invisible to generate-routing clients
    async def admin_handler(request, context):
        op = request.get("op")
        if op == "clear_kv_blocks":
            engine.request_clear_cache()
            yield {"ok": True}
        elif op == "cache_status":
            yield {
                "ok": True,
                "active_pages": engine.allocator.active_pages,
                "cached_pages": engine.allocator.evictable_pages,
                "free_pages": engine.allocator.free_pages,
                "kvbm": None,
            }
        else:
            yield {"ok": False, "error": f"unknown op {op!r}"}

    await drt.namespace(namespace).component(component).endpoint("admin").serve(
        admin_handler, metadata={"role": "admin"})
    await engine.start()
    log.info(
        "engine worker %x up: model=%s device=%s pages=%d slots=%d",
        served.instance.instance_id, spec.name, engine.device, cfg.num_pages,
        cfg.max_decode_slots,
    )
    return engine, served
