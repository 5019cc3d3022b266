"""OpenAI-compatible HTTP frontend (the counterpart of
dynamo_tpu/frontend/http.py, on frontend/http_server.py instead of aiohttp).

Routes:
  POST /v1/chat/completions   - streaming (SSE) + aggregated
  POST /v1/completions        - streaming (SSE) + aggregated
  GET  /v1/models             - discovered model cards
  POST /clear_kv_blocks       - evict every worker's inactive prefix-cache pages
  GET  /health, /live, /ready - liveness/readiness
  GET  /metrics               - Prometheus exposition (TTFT/ITL/duration
                                histograms per model)
  GET  /openapi.json, /docs   - the served surface

The statuses, JSON error bodies and metrics are the reference's. Not served
until their slices (ROADMAP Queue A), so they answer 404: /v1/responses,
/v1/embeddings, /debug/timeline. There is no audit bus and no tracing span
yet (Queue A item 15).

Client disconnect mid-SSE stops the request's context, so the engine frees
the slot and its pages.
"""

from __future__ import annotations

import asyncio
import json
import logging
import math
import time
from contextlib import aclosing
from typing import Any

from dynamo_tpu_torch.frontend.http_server import (
    HttpServer,
    Request,
    Response,
    StreamResponse,
)
from dynamo_tpu_torch.frontend.protocols import new_request_id
from dynamo_tpu_torch.frontend.validation import (
    RequestValidationError,
    validate_request,
    validate_tenancy,
)
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelPipeline
from dynamo_tpu_torch.runtime.compute import ComputePool
from dynamo_tpu_torch.runtime.context import (
    PRIORITY_HEADER,
    TENANT_HEADER,
    Context,
    DeadlineExceeded,
    OverQuota,
    ServiceUnavailable,
    StreamError,
    tighten_timeout_s,
)
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry
from dynamo_tpu_torch.runtime.push import NoInstancesError

log = logging.getLogger("dynamo_tpu_torch.http")

# SSE framing: byte-identical to json.dumps with its default separators
_SSE_DATA = b"data: "
_SSE_SEP = b"\n\n"
_SSE_DONE = b"data: [DONE]\n\n"
_JSON_ENCODER = json.JSONEncoder()


def _sse_bytes(chunk: dict) -> bytes:
    return b"".join((_SSE_DATA, _JSON_ENCODER.encode(chunk).encode(), _SSE_SEP))


# per-request deadline override (ms); clamped to the server-side default
TIMEOUT_HEADER = "x-dyn-timeout-ms"


class HttpFrontend:
    def __init__(
        self,
        manager: ModelManager,
        *,
        host: str = "0.0.0.0",
        port: int = 8000,
        metrics: MetricsRegistry | None = None,
        drt=None,  # DistributedRuntime: enables admin routes
        request_timeout_s: float = 600.0,  # end-to-end deadline default
    ):
        self.manager = manager
        self.host = host
        self.port = port
        self.request_timeout_s = request_timeout_s
        self.metrics = metrics or MetricsRegistry()
        self._drt = drt
        self._compute = ComputePool()
        self._server = HttpServer()
        for method, path, handler in (
            ("POST", "/v1/chat/completions", self.chat_completions),
            ("POST", "/v1/completions", self.completions),
            ("GET", "/v1/models", self.models),
            ("POST", "/clear_kv_blocks", self.clear_kv_blocks),
            ("GET", "/health", self.health),
            ("GET", "/live", self.health),
            ("GET", "/ready", self.health),
            ("GET", "/metrics", self.prometheus),
            ("GET", "/openapi.json", self.openapi),
            ("GET", "/docs", self.docs),
        ):
            self._server.add_route(method, path, handler)
        m = self.metrics
        self._m_requests = m.counter(
            "http_requests_total", "HTTP requests", ["model", "route", "status"]
        )
        self._m_ttft = m.histogram(
            "time_to_first_token_seconds", "TTFT", ["model"]
        )
        self._m_itl = m.histogram(
            "inter_token_latency_seconds", "ITL", ["model"],
            buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5),
        )
        self._m_duration = m.histogram(
            "request_duration_seconds", "request duration", ["model"]
        )
        self._m_tokens = m.counter(
            "output_tokens_total", "generated tokens", ["model"]
        )
        self._m_input_tokens = m.counter(
            "input_tokens_total", "prompt tokens", ["model"]
        )
        self._m_completed = m.counter(
            "requests_completed_total",
            "generation requests that reached the backend", ["model"],
        )
        self._m_inflight = m.gauge(
            "inflight_requests", "in-flight requests", ["model"]
        )

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> tuple[str, int]:
        self.port = await self._server.start(self.host, self.port)
        log.info("http frontend on %s:%d", self.host, self.port)
        return self.host, self.port

    async def stop(self) -> None:
        await self._server.stop()
        self._compute.shutdown()

    # -- helpers -----------------------------------------------------------

    def _pipeline_or_error(
        self, body: dict[str, Any]
    ) -> tuple[ModelPipeline | None, Response | None]:
        model = body.get("model")
        if not model:
            return None, _error(400, "missing 'model' field")
        pipe = self.manager.get(model)
        if pipe is None:
            return None, _error(
                404, f"model {model!r} not found", code="model_not_found"
            )
        return pipe, None

    def _context(self, request: Request) -> Context:
        """Per-request Context with the END-TO-END DEADLINE (default
        ``request_timeout_s``; ``x-dyn-timeout-ms`` tightens it) and the
        validated tenant id + priority class stamped into its baggage
        headers. Raises RequestValidationError (-> 400) on malformed
        tenancy headers."""
        tenant, priority = validate_tenancy(request.headers)
        headers = {TENANT_HEADER: tenant, PRIORITY_HEADER: priority}
        timeout_s = self.request_timeout_s
        raw = request.headers.get(TIMEOUT_HEADER)
        if raw:
            timeout_s = tighten_timeout_s(timeout_s, raw)
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        return Context(
            request_id=new_request_id(), headers=headers, deadline=deadline
        )

    # -- routes ------------------------------------------------------------

    def _openapi_spec(self) -> dict:
        """OpenAPI 3 description of the served surface. Models list
        reflects live discovery."""
        models = sorted(self.manager.names())

        def op(summary, tag, stream=False, method="post"):
            body = {
                "summary": summary,
                "tags": [tag],
                "responses": {"200": {"description": "OK"}},
            }
            if method == "post":
                body["requestBody"] = {
                    "content": {"application/json": {"schema": {
                        "type": "object",
                        "properties": {"model": {
                            "type": "string", "enum": models or None,
                        }},
                    }}}
                }
            if stream:
                body["responses"]["200"]["description"] = (
                    "OK (SSE stream when request sets stream=true)"
                )
            return {method: body}

        return {
            "openapi": "3.0.3",
            "info": {
                "title": "dynamo-tpu OpenAI-compatible frontend",
                "version": "0.3.0",
            },
            "paths": {
                "/v1/chat/completions": op(
                    "Chat completion", "openai", stream=True),
                "/v1/completions": op("Text completion", "openai",
                                      stream=True),
                "/v1/models": op("Discovered models", "openai",
                                 method="get"),
                "/clear_kv_blocks": op("Evict inactive prefix-cache pages "
                                       "on every worker", "admin"),
                "/health": op("Liveness", "ops", method="get"),
                "/metrics": op("Prometheus exposition", "ops", method="get"),
            },
        }

    async def openapi(self, request: Request) -> Response:
        return Response.json(self._openapi_spec())

    async def docs(self, request: Request) -> Response:
        """Minimal human-readable API index (no JS bundle dependencies)."""
        paths = self._openapi_spec()["paths"]
        rows = "".join(
            f"<tr><td><code>{next(iter(ops)).upper()}</code></td>"
            f"<td><code>{path}</code></td>"
            f"<td>{next(iter(ops.values()))['summary']}</td></tr>"
            for path, ops in paths.items()
        )
        html = (
            "<html><head><title>dynamo-tpu API</title></head><body>"
            "<h1>dynamo-tpu OpenAI-compatible frontend</h1>"
            "<p>Machine-readable spec: <a href='/openapi.json'>"
            "/openapi.json</a></p>"
            f"<table border=1 cellpadding=6>{rows}</table></body></html>"
        )
        return Response(200, html, "text/html; charset=utf-8")

    async def chat_completions(self, request: Request) -> Response | StreamResponse:
        return await self._completions_common(request, chat=True)

    async def completions(self, request: Request) -> Response | StreamResponse:
        return await self._completions_common(request, chat=False)

    async def _completions_common(
        self, request: Request, *, chat: bool
    ) -> Response | StreamResponse:
        route = "chat" if chat else "completions"
        try:
            body = request.json()
        except ValueError:
            self._m_requests.labels("?", route, "400").inc()
            return _error(400, "invalid JSON body")
        try:
            validate_request(body, route)
        except RequestValidationError as e:
            self._m_requests.labels(str(body.get("model")) if isinstance(body, dict) else "?", route, "400").inc()
            return _error(400, str(e), param=e.param)
        pipe, err = self._pipeline_or_error(body)
        if err is not None:
            self._m_requests.labels(str(body.get("model")), route, str(err.status)).inc()
            return err
        model = pipe.card.name
        try:
            ctx = self._context(request)
        except RequestValidationError as e:
            # malformed tenancy header: typed 400 naming the header
            self._m_requests.labels(model, route, "400").inc()
            return _error(400, str(e), param=e.param)
        return await self._serve_completions(
            request, body, pipe, route, chat=chat, ctx=ctx
        )

    async def _serve_completions(
        self, request: Request, body: dict, pipe: ModelPipeline,
        route: str, *, chat: bool, ctx: Context,
    ) -> Response | StreamResponse:
        model = pipe.card.name
        t_start = time.monotonic()
        self._m_inflight.labels(model).inc()
        try:
            try:
                # CPU-bound render+tokenize runs on the compute pool, not
                # the serving event loop
                preprocessed = await self._compute.run(
                    pipe.preprocessor.preprocess, body
                )
            except ValueError as e:
                self._m_requests.labels(model, route, "400").inc()
                return _error(400, str(e))
            prompt_tokens = len(preprocessed["token_ids"])
            deltas = pipe.generate(preprocessed, ctx)
            timed = self._timed_stream(deltas, model, t_start)

            if preprocessed.get("guided"):
                # worker-side refusals of a guided request arrive as the
                # FIRST stream item, typed "invalid_request:"; peek it so
                # they map to a real 400 instead of a 200 that errors
                try:
                    first = await timed.__anext__()
                except StopAsyncIteration:
                    first = None
                err = (
                    str(first.get("error") or "")
                    if isinstance(first, dict)
                    and first.get("finish_reason") == "error" else ""
                )
                if err.startswith("invalid_request:"):
                    ctx.stop_generating()
                    await timed.aclose()
                    msg = err[len("invalid_request:"):].strip()
                    self._m_requests.labels(model, route, "400").inc()
                    return _error(400, msg)
                timed = self._rechain(first, timed)

            if body.get("stream"):
                include_usage = bool(
                    (body.get("stream_options") or {}).get("include_usage"))
                pp = (
                    pipe.preprocessor.postprocess_chat_stream(
                        timed, request_id=ctx.id, include_usage=include_usage,
                        prompt_tokens=prompt_tokens, request=body,
                    )
                    if chat
                    else pipe.preprocessor.postprocess_completions_stream(
                        timed, request_id=ctx.id, include_usage=include_usage,
                        prompt_tokens=prompt_tokens,
                    )
                )
                resp = await self._sse(request, pp, ctx)
                self._m_requests.labels(model, route, "200").inc()
                self._mark_completed(model, prompt_tokens)
                return resp
            agg = (
                await pipe.preprocessor.aggregate_chat(
                    timed, request_id=ctx.id, prompt_tokens=prompt_tokens,
                    request=body,
                )
                if chat
                else await pipe.preprocessor.aggregate_completions(
                    timed, request_id=ctx.id, prompt_tokens=prompt_tokens
                )
            )
            self._m_requests.labels(model, route, "200").inc()
            self._mark_completed(model, prompt_tokens)
            return Response.json(agg)
        except OverQuota as e:
            ctx.stop_generating()
            self._m_requests.labels(model, route, "429").inc()
            return _error(
                429, f"over quota: {e}", code="over_quota",
                headers={"Retry-After": _retry_after_header(e.retry_after_s)},
            )
        except (ServiceUnavailable, NoInstancesError) as e:
            # every worker draining/saturated (or none left) and the retry
            # budget exhausted: tell the client when to come back
            ctx.stop_generating()
            retry_after = getattr(e, "retry_after_s", 1.0)
            self._m_requests.labels(model, route, "503").inc()
            return _error(
                503, f"service unavailable: {e}", code="service_unavailable",
                headers={"Retry-After": _retry_after_header(retry_after)},
            )
        except DeadlineExceeded as e:
            ctx.stop_generating()
            self._m_requests.labels(model, route, "504").inc()
            return _error(504, f"deadline exceeded: {e}", code="deadline_exceeded")
        except (ConnectionError, asyncio.CancelledError):
            # the client went away mid-stream (_sse stopped the context)
            raise
        except Exception as e:  # noqa: BLE001
            log.exception("request %s failed", ctx.id)
            ctx.stop_generating()
            self._m_requests.labels(model, route, "500").inc()
            return _error(500, f"internal error: {e}")
        finally:
            self._m_inflight.labels(model).dec()
            self._m_duration.labels(model).observe(time.monotonic() - t_start)

    @staticmethod
    async def _rechain(first, rest):
        """Put a peeked item back in front of its stream."""
        if first is not None:
            yield first
        async with aclosing(rest):
            async for d in rest:
                yield d

    def _mark_completed(self, model: str, prompt_tokens: int) -> None:
        """ISL/OSL accounting, counted only when the stream finished, so
        isl = input_tokens / requests_completed and osl = output_tokens /
        requests_completed line up."""
        self._m_input_tokens.labels(model).inc(prompt_tokens)
        self._m_completed.labels(model).inc()

    async def _timed_stream(self, deltas, model: str, t_start: float):
        """Wrap the backend stream with TTFT/ITL/token metrics."""
        last = None
        async with aclosing(deltas):
            async for d in deltas:
                now = time.monotonic()
                if last is None:
                    self._m_ttft.labels(model).observe(now - t_start)
                else:
                    self._m_itl.labels(model).observe(now - last)
                last = now
                self._m_tokens.labels(model).inc(len(d.get("token_ids") or ()))
                yield d

    async def _sse(
        self, request: Request, chunks, ctx: Context
    ) -> StreamResponse:
        resp = StreamResponse(request, {
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
        })
        try:
            async with aclosing(chunks):
                await resp.prepare()
                try:
                    async for chunk in chunks:
                        await resp.write(_sse_bytes(chunk))
                    await resp.write(_SSE_DONE)
                except (ConnectionError, asyncio.CancelledError):
                    raise
                except Exception as e:  # noqa: BLE001
                    # mid-stream failure (e.g. migration exhausted): the
                    # response is already streaming, so deliver the error
                    # as a final SSE event
                    log.exception("stream %s failed mid-flight", ctx.id)
                    err = {"error": {"message": str(e), "type": "server_error"}}
                    await resp.write(_sse_bytes(err))
                    await resp.write(_SSE_DONE)
        finally:
            # done or the client went away: cancel the whole pipeline
            ctx.stop_generating()
        await resp.write_eof()
        return resp

    async def clear_kv_blocks(self, request: Request) -> Response:
        """Admin: evict every worker's inactive prefix-cache pages through
        their admin endpoints."""
        if self._drt is None:
            return _error(501, "admin plane unavailable (no runtime handle)")
        results: dict[str, Any] = {}
        for ns, comp in await self._admin_components():
            acks = 0
            replies = await self._admin_call(ns, comp, {"op": "clear_kv_blocks"})
            if replies is None:
                results[f"{ns}/{comp}"] = {"error": "no admin instances"}
                continue
            acks = sum(1 for r in replies.values()
                       if isinstance(r, dict) and r.get("ok"))
            results[f"{ns}/{comp}"] = {"workers_cleared": acks}
        return Response.json({"results": results})

    async def _admin_components(self) -> list[tuple[str, str]]:
        """Every component exposing an admin endpoint."""
        instance_keys = await self._drt.hub.get_prefix("v1/instances/")
        admin_components: set[tuple[str, str]] = set()
        for key in instance_keys:
            parts = key.split("/")
            # v1/instances/{ns}/{component}/{endpoint}/{instance}
            if len(parts) >= 6 and parts[4] == "admin":
                admin_components.add((parts[2], parts[3]))
        return sorted(admin_components)

    async def _admin_call(self, ns: str, comp: str, payload: dict) -> dict | None:
        """Send ``payload`` to every admin instance of ``ns/comp``; returns
        {instance hex id: first reply or {"error"}}, or None when no
        instance appeared within 2 s."""
        ep = self._drt.namespace(ns).component(comp).endpoint("admin")
        client = await ep.client().start()
        try:
            try:
                await client.wait_for_instances(1, timeout=2)
            except TimeoutError:
                return None
            replies: dict[str, Any] = {}
            for inst in client.instances():
                try:
                    # a bounded admin budget: one wedged worker must not
                    # hang the fan-out
                    stream = client.call_instance(
                        inst.instance_id, payload,
                        Context(deadline=time.monotonic() + 10.0))
                    async with aclosing(stream):
                        async for item in stream:
                            replies[f"{inst.instance_id:x}"] = item
                            break
                except (StreamError, DeadlineExceeded) as e:
                    replies[f"{inst.instance_id:x}"] = {"error": str(e)}
            return replies
        finally:
            await client.close()

    async def models(self, request: Request) -> Response:
        return Response.json(
            {
                "object": "list",
                "data": [
                    {
                        "id": c.name,
                        "object": "model",
                        "owned_by": "dynamo-tpu",
                        "created": 0,
                        "meta": {
                            "context_length": c.context_length,
                            "model_type": c.model_type,
                            "router_mode": c.router_mode,
                        },
                    }
                    for c in self.manager.cards()
                ],
            }
        )

    async def health(self, request: Request) -> Response:
        models = {}
        for pipe in [self.manager.get(n) for n in self.manager.names()]:
            if pipe:
                models[pipe.card.name] = {
                    "instances": len(pipe.push_router.client.instance_ids())
                }
        status = "healthy" if models else "no_models"
        return Response.json({"status": status, "models": models})

    async def prometheus(self, request: Request) -> Response:
        return Response(200, self.metrics.exposition(), "text/plain; charset=utf-8")


def _retry_after_header(retry_after_s: float) -> str:
    """HTTP Retry-After is integer seconds: round UP so a 0.4 s hint
    becomes 1, never 0."""
    return str(max(int(math.ceil(retry_after_s)), 1))


def _error(
    status: int, message: str, code: str | None = None,
    param: str | None = None, headers: dict[str, str] | None = None,
) -> Response:
    return Response.json(
        {"error": {"message": message, "type": "invalid_request_error",
                   "param": param, "code": code}},
        status=status,
        headers=headers,
    )
