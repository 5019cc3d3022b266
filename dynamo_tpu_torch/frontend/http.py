"""OpenAI-compatible HTTP frontend (the counterpart of
dynamo_tpu/frontend/http.py, on frontend/http_server.py instead of aiohttp).

Routes:
  POST /v1/chat/completions   - streaming (SSE) + aggregated
  POST /v1/completions        - streaming (SSE) + aggregated
  POST /v1/responses          - OpenAI Responses API on the chat pipeline
                                (SSE events or one response object)
  POST /v1/embeddings         - embeddings models (one pooled vector per
                                input, one engine request each)
  GET  /v1/models             - discovered model cards
  POST /clear_kv_blocks       - evict every worker's inactive prefix-cache pages
  GET  /health, /live, /ready - liveness/readiness
  GET  /metrics               - Prometheus exposition (TTFT/ITL/duration
                                histograms per model)
  GET  /openapi.json, /docs   - the served surface
  GET  /debug/timeline        - flight-recorder timelines from every worker
                                (``?request_id=`` for one, ``&n=`` for the
                                summary tail)

The statuses, JSON error bodies and metrics are the reference's.

Tracing (runtime/tracing.py): each generation route binds the client's
``traceparent`` and runs under an ``http.request`` span, with
``http.preprocess`` around render + tokenize; the request's Context
carries the trace, tenancy and deadline in one set of headers
(``_traced_context``). Audit (runtime/audit.py): with a sink configured
(``DYN_AUDIT_PATH``, or an ``AuditBus`` given), every completed request
emits one record after its response, off the request path.

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
from dynamo_tpu_torch.frontend.protocols import (
    embeddings_response,
    make_embedding_request,
    new_request_id,
)
from dynamo_tpu_torch.frontend.validation import (
    RequestValidationError,
    validate_request,
    validate_tenancy,
)
from dynamo_tpu_torch.frontend.watcher import ModelManager, ModelPipeline
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.audit import AuditBus, AuditRecord
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


_SSE_EVENT = b"event: "
_SSE_EVENT_DATA = b"\ndata: "


def _sse_bytes(chunk: dict) -> bytes:
    return b"".join((_SSE_DATA, _JSON_ENCODER.encode(chunk).encode(), _SSE_SEP))


def _sse_event_bytes(event: str, payload: dict) -> bytes:
    return b"".join((
        _SSE_EVENT, event.encode(), _SSE_EVENT_DATA,
        _JSON_ENCODER.encode(payload).encode(), _SSE_SEP,
    ))


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
        audit: AuditBus | None = None,  # default: configured from the env
    ):
        self.manager = manager
        self.audit = audit if audit is not None else AuditBus()
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
            ("POST", "/v1/responses", self.responses),
            ("POST", "/v1/embeddings", self.embeddings),
            ("GET", "/v1/models", self.models),
            ("POST", "/clear_kv_blocks", self.clear_kv_blocks),
            ("GET", "/health", self.health),
            ("GET", "/live", self.health),
            ("GET", "/ready", self.health),
            ("GET", "/metrics", self.prometheus),
            ("GET", "/openapi.json", self.openapi),
            ("GET", "/docs", self.docs),
            ("GET", "/debug/timeline", self.debug_timeline),
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
        # the file sink's writer thread drains its queue, then exits (a
        # blocking join: off the loop)
        await asyncio.to_thread(self.audit.close)

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

    def _traced_context(self, request: Request) -> Context:
        """Per-request Context joined to the route's ``http.request`` span
        (opened after ``bind_trace``, so its traceparent continues the
        client's W3C trace or starts one); the traceparent rides
        Context.headers, and the transport client re-stamps it with its own
        ``transport.call`` span at send time. It carries the END-TO-END
        DEADLINE (default ``request_timeout_s``; ``x-dyn-timeout-ms``
        tightens it) and the validated tenant id + priority class in the
        same headers. Raises RequestValidationError (-> 400) on malformed
        tenancy headers."""
        tenant, priority = validate_tenancy(request.headers)
        headers = {TENANT_HEADER: tenant, PRIORITY_HEADER: priority}
        cur = tracing.current_trace()
        if cur is None:
            tracing.ensure_trace(headers)
        else:
            headers[tracing.TRACEPARENT] = cur.to_traceparent()
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
                "/v1/responses": op("Responses API", "openai"),
                "/v1/embeddings": op("Embeddings", "openai"),
                "/v1/models": op("Discovered models", "openai",
                                 method="get"),
                "/clear_kv_blocks": op("Evict inactive prefix-cache pages "
                                       "on every worker", "admin"),
                "/health": op("Liveness", "ops", method="get"),
                "/metrics": op("Prometheus exposition", "ops", method="get"),
                "/debug/timeline": op(
                    "Flight-recorder timelines from every worker", "ops",
                    method="get"),
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
        # the server span of the whole route handling, admission through
        # stream completion, child of the client's traceparent when one
        # came in; bind_trace also CLEARS a binding a previous request left
        # on this keep-alive connection's task
        tracing.bind_trace(request.headers)
        with tracing.span("http.request", route=route, model=model):
            try:
                ctx = self._traced_context(request)
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
                with tracing.span("http.preprocess"):
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
                    self._audit(route, model, ctx, body, 400, t_start, error=msg)
                    return _error(400, msg)
                timed = self._rechain(first, timed)

            # a streamed request's audit record carries the real output
            # tokens and finish reason, and a mid-stream failure (an SSE
            # error event on an already-200 response) as its error
            audit_state = {"tokens": 0, "finish": None, "error": None}
            if body.get("stream") and self.audit.enabled:
                timed = self._observe_for_audit(timed, audit_state)

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
                self._audit(route, model, ctx, body, 200, t_start,
                            finish_reason=audit_state["finish"],
                            output_tokens=audit_state["tokens"],
                            error=audit_state["error"])
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
            self._audit(route, model, ctx, body, 200, t_start,
                        finish_reason=(agg.get("choices") or [{}])[0].get(
                            "finish_reason"),
                        output_tokens=(agg.get("usage") or {}).get(
                            "completion_tokens", 0))
            return Response.json(agg)
        except OverQuota as e:
            ctx.stop_generating()
            self._m_requests.labels(model, route, "429").inc()
            self._audit(route, model, ctx, body, 429, t_start, error=str(e))
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
            self._audit(route, model, ctx, body, 503, t_start, error=str(e))
            return _error(
                503, f"service unavailable: {e}", code="service_unavailable",
                headers={"Retry-After": _retry_after_header(retry_after)},
            )
        except DeadlineExceeded as e:
            ctx.stop_generating()
            self._m_requests.labels(model, route, "504").inc()
            self._audit(route, model, ctx, body, 504, t_start, error=str(e))
            return _error(504, f"deadline exceeded: {e}", code="deadline_exceeded")
        except (ConnectionError, asyncio.CancelledError):
            # the client went away mid-stream (_sse stopped the context)
            raise
        except Exception as e:  # noqa: BLE001
            log.exception("request %s failed", ctx.id)
            ctx.stop_generating()
            self._m_requests.labels(model, route, "500").inc()
            self._audit(route, model, ctx, body, 500, t_start, error=str(e))
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

    @staticmethod
    async def _observe_for_audit(stream, state: dict):
        """Pass ``stream`` through, counting its output tokens, finish
        reason and error into ``state`` for the audit record."""
        try:
            async with aclosing(stream):
                async for d in stream:
                    state["tokens"] += len(d.get("token_ids") or ())
                    if d.get("finish_reason"):
                        state["finish"] = d["finish_reason"]
                    if d.get("error"):
                        state["error"] = str(d["error"])
                    yield d
        except Exception as e:  # noqa: BLE001
            state["error"] = str(e)
            raise

    def _audit(
        self, route: str, model: str, ctx: Context, body: dict, status: int,
        t_start: float, *, finish_reason: str | None = None,
        output_tokens: int = 0, error: str | None = None,
    ) -> None:
        """Emit one audit record AFTER the response completes (the sinks
        enqueue; nothing waits on them)."""
        if not self.audit.enabled:
            return
        self.audit.emit(AuditRecord.make(
            route=route, model=model, request_id=ctx.id, request=body,
            status=status, finish_reason=finish_reason,
            output_tokens=output_tokens,
            duration_ms=(time.monotonic() - t_start) * 1e3, error=error,
        ))

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

    async def responses(self, request: Request) -> Response | StreamResponse:
        """OpenAI Responses API surface (/v1/responses): maps input onto
        the chat pipeline; streams response.output_text.delta events or
        returns one response object."""
        try:
            body = request.json()
        except ValueError:
            return _error(400, "invalid JSON body")
        try:
            validate_request(body, "responses")
        except RequestValidationError as e:
            return _error(400, str(e), param=e.param)
        pipe, err = self._pipeline_or_error(body)
        if err is not None:
            return err
        model = pipe.card.name
        inp = body.get("input", "")
        messages = (
            inp if isinstance(inp, list)
            else [{"role": "user", "content": str(inp)}]
        )
        chat_body = {
            "model": model,
            "messages": messages,
            "max_tokens": body.get("max_output_tokens"),
            "temperature": body.get("temperature"),
            "top_p": body.get("top_p"),
        }
        chat_body = {k: v for k, v in chat_body.items() if v is not None}
        tracing.bind_trace(request.headers)
        with tracing.span("http.request", route="responses", model=model):
            try:
                ctx = self._traced_context(request)
            except RequestValidationError as e:
                self._m_requests.labels(model, "responses", "400").inc()
                return _error(400, str(e), param=e.param)
            t_start = time.monotonic()
            try:
                return await self._serve_responses(request, body, pipe,
                                                   chat_body, ctx)
            except OverQuota as e:
                # the completions routes' 429 accounting, audited too
                ctx.stop_generating()
                self._m_requests.labels(model, "responses", "429").inc()
                self._audit("responses", model, ctx, body, 429, t_start,
                            error=str(e))
                return _error(
                    429, f"over quota: {e}", code="over_quota",
                    headers={"Retry-After": _retry_after_header(e.retry_after_s)},
                )

    async def _serve_responses(
        self, request: Request, body: dict, pipe: ModelPipeline,
        chat_body: dict, ctx: Context,
    ) -> Response | StreamResponse:
        model = pipe.card.name
        rid = f"resp_{ctx.id}"
        try:
            with tracing.span("http.preprocess"):
                preprocessed = await self._compute.run(
                    pipe.preprocessor.preprocess, chat_body
                )
        except ValueError as e:
            return _error(400, str(e))
        prompt_tokens = len(preprocessed["token_ids"])
        deltas = self._timed_stream(
            pipe.generate(preprocessed, ctx), model, time.monotonic()
        )

        if body.get("stream"):
            resp = StreamResponse(request, {
                "Content-Type": "text/event-stream",
                "Cache-Control": "no-store",
            })
            await resp.prepare()

            async def send(event: str, payload: dict) -> None:
                await resp.write(_sse_event_bytes(event, payload))

            await send("response.created",
                       {"response": {"id": rid, "status": "in_progress"}})
            n_out = 0
            try:
                async with aclosing(deltas):
                    async for d in deltas:
                        n_out += len(d.get("token_ids") or ())
                        if d.get("finish_reason") == "error":
                            await send("response.failed", {
                                "response": {
                                    "id": rid, "status": "failed",
                                    "error": {"message": d.get("error")
                                              or "generation error"},
                                }
                            })
                            await resp.write_eof()
                            return resp
                        if d.get("text"):
                            await send(
                                "response.output_text.delta",
                                {"delta": d["text"], "item_id": rid},
                            )
                await send("response.completed", {
                    "response": {
                        "id": rid, "status": "completed",
                        "usage": {"input_tokens": prompt_tokens,
                                  "output_tokens": n_out},
                    }
                })
            except (ConnectionError, asyncio.CancelledError, StreamError):
                ctx.stop_generating()
                raise
            await resp.write_eof()
            self._mark_completed(model, prompt_tokens)
            return resp

        try:
            agg = await pipe.preprocessor.aggregate_chat(
                deltas, request_id=ctx.id, prompt_tokens=prompt_tokens,
                request=body,
            )
        except StreamError as e:
            ctx.stop_generating()
            return _error(502, f"generation failed: {e}")
        if agg["choices"][0]["finish_reason"] == "error":
            return _error(502, "generation error")
        msg = agg["choices"][0]["message"]
        self._mark_completed(model, prompt_tokens)
        return Response.json({
            "id": rid,
            "object": "response",
            "created_at": agg["created"],
            "status": "completed",
            "model": model,
            "output": [{
                "type": "message",
                "id": f"msg_{ctx.id}",
                "role": "assistant",
                "status": "completed",
                "content": [{
                    "type": "output_text",
                    "text": msg.get("content") or "",
                    "annotations": [],
                }],
            }],
            "usage": {
                "input_tokens": prompt_tokens,
                "output_tokens": agg["usage"]["completion_tokens"],
                "total_tokens": agg["usage"]["total_tokens"],
            },
        })

    async def embeddings(self, request: Request) -> Response:
        try:
            body = request.json()
        except ValueError:
            return _error(400, "invalid JSON body")
        try:
            validate_request(body, "embeddings")
        except RequestValidationError as e:
            return _error(400, str(e), param=e.param)
        pipe, err = self._pipeline_or_error(body)
        if err is not None:
            return err
        if pipe.card.model_type != "embeddings":
            return _error(400, f"model {pipe.card.name!r} is not an embeddings model")
        # the shape was validated at the edge
        inputs = body.get("input")
        if isinstance(inputs, str):
            inputs = [inputs]
        # the generation routes' trace and end-to-end deadline contract
        tracing.bind_trace(request.headers)
        with tracing.span("http.request", route="embeddings", model=pipe.card.name):
            try:
                ctx = self._traced_context(request)
            except RequestValidationError as e:
                return _error(400, str(e), param=e.param)
            t_start = time.monotonic()
            resp = await self._serve_embeddings(pipe, inputs, ctx)
            self._audit("embeddings", pipe.card.name, ctx, body, resp.status, t_start,
                        error=None if resp.status == 200 else "embeddings failed")
            return resp

    async def _serve_embeddings(
        self, pipe: ModelPipeline, inputs: list, ctx: Context
    ) -> Response:
        vectors = []
        for i, text in enumerate(inputs):
            out = None
            try:
                async for item in pipe.generate(
                    make_embedding_request(pipe.preprocessor.tokenizer.encode(text)),
                    ctx.child(f"{ctx.id}-{i}"),
                ):
                    if isinstance(item, dict) and "embedding" in item:
                        out = item["embedding"]
            except DeadlineExceeded as e:
                # expiry mid-batch is the generation routes' 504
                return _error(504, f"deadline exceeded: {e}", code="deadline_exceeded")
            if out is None:
                return _error(502, "worker returned no embedding")
            vectors.append(out)
        return Response.json(embeddings_response(pipe.card.name, vectors))

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

    async def debug_timeline(self, request: Request) -> Response:
        """Flight-recorder query: fan ``{"op": "timeline"}`` out to every
        worker's admin endpoint and merge the answers: by request id
        (``?request_id=``) one full per-request event timeline (admission,
        phase transitions, finish, with its trace_id), or without it each
        worker's summary view (active, the recent ``n``, the retained
        errors and slowest). The HTTP face of runtime/flight.py."""
        if self._drt is None:
            return _error(501, "admin plane unavailable (no runtime handle)")
        # the admin calls' spans join the caller's trace, never a binding a
        # previous request left on this connection's task
        tracing.bind_trace(request.headers)
        request_id = request.query.get("request_id")
        try:
            n = int(request.query.get("n") or 16)
        except ValueError:
            return _error(400, "n must be an integer")
        results: dict[str, Any] = {}
        for ns, comp in await self._admin_components():
            replies = await self._admin_call(
                ns, comp, {"op": "timeline", "request_id": request_id, "n": n})
            results[f"{ns}/{comp}"] = (
                {"error": "no admin instances"} if replies is None else replies)
        return Response.json({"request_id": request_id, "results": results})

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
