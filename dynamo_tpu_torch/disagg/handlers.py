"""Decode / prefill worker handlers for disaggregated serving (the port's
copy of dynamo_tpu/disagg/handlers.py).

Mirrors the reference's engine-worker handler split
(components/src/dynamo/vllm/handlers.py:119 DecodeWorkerHandler, :227
PrefillWorkerHandler), around the in-process torch engine:

  decode.generate(request):
    if policy says remote and prefill workers are live:
      prefill_req = request + {max_tokens: 1, disagg.do_remote_decode}
      → prefill pool (KV-aware prefill router or round-robin PushRouter)
      ← first token + kv_transfer_params
      resume local engine from transferred KV (skips prompt FLOPs)
    else: fully local (aggregated path)

Failures at any disagg step fall back to the local aggregated path, so
disagg is strictly an optimization, never an availability risk. Under
tensor parallelism the prefill side's ``kv_transfer_params`` carry the
shards (``shard_axis``, ``shards``: disagg/transfer.py); both handlers
pass them through unchanged. A pull that fails (the leader's own shard
at intake, or any rank's at the resume) ends in a local prefill of the
prompt and the relayed first token (``engine.disagg_fallbacks``), never
in a partial install.
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any, AsyncIterator

from dynamo_tpu_torch.disagg.policy import DisaggPolicy
from dynamo_tpu_torch.disagg.transfer import release_kv_blocks
from dynamo_tpu_torch.runtime.context import Context, StreamError

log = logging.getLogger("dynamo_tpu_torch.disagg.handlers")


class PrefillWorkerHandler:
    """Thin guard in front of the engine on prefill workers: force the
    1-token budget and require the remote-decode marker."""

    def __init__(self, engine):
        self.engine = engine

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        disagg = request.get("disagg") or {}
        if not (disagg.get("kv_transfer") or {}).get("do_remote_decode"):
            if "health-canary" in (request.get("annotations") or ()):
                # canary probe (runtime/health.py): run a plain 1-token
                # local generate through the engine — no KV export, but
                # exercises the real admission + decode path
                request = dict(request)
                request["stop_conditions"] = {
                    **(request.get("stop_conditions") or {}),
                    "max_tokens": 1,
                }
                async for item in self.engine.generate(request, context):
                    yield item
                return
            yield {"token_ids": [], "finish_reason": "error",
                   "error": "prefill worker requires disagg.kv_transfer.do_remote_decode"}
            return
        request = dict(request)
        stop = dict(request.get("stop_conditions") or {})
        stop["max_tokens"] = 1
        stop["min_tokens"] = 0
        request["stop_conditions"] = stop
        async for item in self.engine.generate(request, context):
            yield item


class DecodeWorkerHandler:
    """Front door on decode workers: conditional remote prefill + resume."""

    def __init__(
        self,
        engine,
        *,
        prefill_router=None,
        policy: DisaggPolicy | None = None,
    ):
        self.engine = engine
        self.prefill_router = prefill_router
        self.policy = policy or DisaggPolicy()

    def _prefill_client(self):
        r = self.prefill_router
        if r is None:
            return None
        return getattr(r, "client", None) or getattr(
            getattr(r, "push_router", None), "client", None
        )

    def can_prefill(self) -> bool:
        if self.prefill_router is None:
            return False
        client = self._prefill_client()
        if client is None:
            return True  # custom router; assume live, failures fall back
        return bool(client.instance_ids())

    async def wait_for_prefill_pool(self, n: int = 1, timeout: float = 10.0) -> None:
        """Block until ≥n prefill workers are discovered (instance watch is
        eventually consistent)."""
        client = self._prefill_client()
        if client is not None:
            await client.wait_for_instances(n, timeout)

    async def generate(
        self, request: dict[str, Any], context: Context
    ) -> AsyncIterator[dict[str, Any]]:
        token_ids = request.get("token_ids") or []
        # guided requests prefill locally: the remote prefill worker
        # samples the FIRST token, and conformance requires that sample
        # to run under this request's grammar mask — keeping the whole
        # constrained stream on one engine keeps the guarantee simple
        if self._should_remote(token_ids) and not request.get("guided"):
            resumed = await self._remote_prefill(dict(request), context)
            if resumed is not None:
                first_item, resume_request = resumed
                yield first_item
                if first_item.get("finish_reason") is not None:
                    return
                if resume_request is not None:
                    async for item in self.engine.generate(resume_request, context):
                        yield item
                    return
        async for item in self.engine.generate(request, context):
            yield item

    # -- internals ---------------------------------------------------------

    def _should_remote(self, token_ids: list[int]) -> bool:
        if not token_ids or not self.can_prefill():
            return False
        hit = 0
        probe = getattr(self.engine, "prefix_hit_tokens", None)
        if probe is not None:
            hit = probe(token_ids)
        return self.policy.prefill_remote(len(token_ids), hit)

    async def _remote_prefill(
        self, request: dict[str, Any], context: Context
    ) -> tuple[dict[str, Any], dict[str, Any] | None] | None:
        """Run the 1-token remote prefill. Returns (first_item,
        resume_request|None) or None to signal 'fall back to local'."""
        prefill_req = dict(request)
        stop = dict(prefill_req.get("stop_conditions") or {})
        orig_max_tokens = stop.get("max_tokens")
        stop["max_tokens"] = 1
        stop["min_tokens"] = 0
        prefill_req["stop_conditions"] = stop
        prefill_req["disagg"] = {
            "mode": "prefill",
            "kv_transfer": {"do_remote_decode": True},
        }

        first_tok: int | None = None
        first_lp: list | None = None
        kv_params: dict | None = None
        finish: str | None = None
        try:
            pctx = context.child()
            async for item in self.prefill_router.generate(prefill_req, pctx):
                if not isinstance(item, dict):
                    continue
                toks = item.get("token_ids") or []
                if toks and first_tok is None:
                    first_tok = toks[0]
                    first_lp = item.get("logprobs")
                if item.get("kv_transfer_params"):
                    kv_params = item["kv_transfer_params"]
                if item.get("finish_reason") not in (None, "length"):
                    finish = item["finish_reason"]
        except (StreamError, asyncio.TimeoutError, ConnectionError) as e:
            log.warning("remote prefill failed (%s); falling back to local", e)
            return None
        if first_tok is None or kv_params is None:
            if finish == "error":
                log.warning("remote prefill errored; falling back to local")
            return None

        first_item = {"token_ids": [first_tok], "finish_reason": None}
        if first_lp:
            # the export's logprob entry rides to the client (the reference
            # drops it here)
            first_item["logprobs"] = first_lp
        # EOS / stop / single-token budget: no decode needed
        eos = set(request.get("eos_token_ids") or (2,))
        stop_ids = set((request.get("stop_conditions") or {}).get("stop_token_ids") or ())
        ignore_eos = bool((request.get("stop_conditions") or {}).get("ignore_eos"))
        if (not ignore_eos and first_tok in eos) or first_tok in stop_ids:
            first_item["finish_reason"] = "stop"
        elif orig_max_tokens is not None and orig_max_tokens <= 1:
            first_item["finish_reason"] = "length"
        if first_item["finish_reason"] is not None:
            await asyncio.to_thread(release_kv_blocks, kv_params)
            return first_item, None

        resume_request = dict(request)
        resume_request["disagg"] = {
            "mode": "decode",
            "kv_transfer": {**kv_params, "first_token": first_tok},
        }
        return first_item, resume_request
