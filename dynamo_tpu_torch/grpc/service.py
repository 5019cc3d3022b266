"""KServe GRPCInferenceService over the model pipeline (the counterpart of
dynamo_tpu/grpc/service.py, on the port's own gRPC server: grpc/server.py
over grpc/h2.py and grpc/hpack.py, messages from grpc/kserve.py).

Service methods (ref lib/llm/src/grpc/service/kserve.rs):
  ServerLive / ServerReady / ServerMetadata
  ModelReady / ModelMetadata        — from the frontend ModelManager
  ModelInfer                        — unary text generation
  ModelStreamInfer                  — server-streaming deltas

Text-generation tensor convention (kserve.rs:449-556): request input
``text_input`` (BYTES) with optional ``streaming`` (BOOL) input and
sampling parameters in ``parameters`` (max_tokens, temperature, top_p,
seed, ignore_eos, min_tokens); responses carry ``text_output`` (BYTES).

End-to-end deadlines (dynalint DL008): every inference RPC mints its root
Context WITH a deadline — the server-wide ``request_timeout_s`` default
(same DYN_REQUEST_TIMEOUT_S contract as the HTTP frontend), tightened
per-request by a ``timeout_ms`` entry in ``parameters`` or by the caller's
own gRPC deadline when that is sooner. DeadlineExceeded maps to
``DEADLINE_EXCEEDED`` (the 504 of this surface).
"""

from __future__ import annotations

import json
import logging
import time
from typing import Any, AsyncIterator

from dynamo_tpu_torch.frontend.protocols import new_request_id
from dynamo_tpu_torch.grpc import kserve as pb
from dynamo_tpu_torch.grpc.kserve import tensor_contents
from dynamo_tpu_torch.grpc.server import Server, StatusCode, unary_stream, unary_unary
from dynamo_tpu_torch.runtime.context import (
    PRIORITY_HEADER,
    TENANT_HEADER,
    Context,
    DeadlineExceeded,
    OverQuota,
    ServiceUnavailable,
    tighten_timeout_s,
)

log = logging.getLogger("dynamo_tpu_torch.grpc")

SERVICE = "inference.GRPCInferenceService"


def _param_value(p: pb.InferParameter):
    which = p.which_oneof("parameter_choice")
    return getattr(p, which) if which else None


def _stamp_retry_after(grpc_ctx, retry_after_s: float) -> None:
    """Retry-After passthrough for the gRPC surface: trailing metadata
    ``retry-after`` in (fractional) seconds on UNAVAILABLE /
    RESOURCE_EXHAUSTED aborts — same live-derived hint the HTTP
    frontend sends as a header, so gRPC clients can back off exactly
    as far instead of guessing."""
    set_md = getattr(grpc_ctx, "set_trailing_metadata", None)
    if callable(set_md):
        try:
            set_md((("retry-after", f"{max(retry_after_s, 0.0):g}"),))
        except (TypeError, ValueError, RuntimeError):  # pragma: no cover
            pass  # metadata is advisory; the abort still carries the code


async def _abort_backpressure(grpc_ctx, e: Exception) -> None:
    """Map a typed backpressure refusal to its gRPC status: quota ->
    RESOURCE_EXHAUSTED (the 429 of this surface), draining/saturated ->
    UNAVAILABLE (the 503); both carry the retry-after trailing hint."""
    _stamp_retry_after(grpc_ctx, getattr(e, "retry_after_s", 1.0))
    code = (
        StatusCode.RESOURCE_EXHAUSTED
        if isinstance(e, OverQuota) else StatusCode.UNAVAILABLE
    )
    await grpc_ctx.abort(code, str(e))


def _text_output_response(
    model: str, request_id: str, text: str, *, final: bool = False,
    tokens: int = 0, token_ids: list[int] | None = None,
) -> pb.ModelInferResponse:
    resp = pb.ModelInferResponse(
        model_name=model,
        id=request_id,
        outputs=[
            pb.ModelInferResponse.InferOutputTensor(
                name="text_output",
                datatype="BYTES",
                shape=[1],
                contents=pb.InferTensorContents(
                    bytes_contents=[text.encode("utf-8")]
                ),
            )
        ],
    )
    if token_ids is not None:
        # tokens-out tensor alongside the text (ref tensor.rs token I/O)
        resp.outputs.append(
            pb.ModelInferResponse.InferOutputTensor(
                name="output_ids",
                datatype="INT32",
                shape=[len(token_ids)],
                contents=pb.InferTensorContents(
                    int_contents=list(token_ids)
                ),
            )
        )
    if final:
        resp.parameters["triton_final_response"] = pb.InferParameter(bool_param=True)
    if tokens:
        resp.parameters["output_tokens"] = pb.InferParameter(int64_param=tokens)
    return resp


def _openai_response(
    model: str, request_id: str, payload: dict, *, final: bool = False
) -> pb.ModelInferResponse:
    """OpenAI-over-gRPC: one JSON body in an ``openai_response`` BYTES
    tensor (ref lib/llm/src/grpc/service/tensor.rs OpenAI passthrough)."""
    resp = pb.ModelInferResponse(
        model_name=model,
        id=request_id,
        outputs=[
            pb.ModelInferResponse.InferOutputTensor(
                name="openai_response",
                datatype="BYTES",
                shape=[1],
                contents=pb.InferTensorContents(
                    bytes_contents=[json.dumps(payload).encode("utf-8")]
                ),
            )
        ],
    )
    if final:
        resp.parameters["triton_final_response"] = pb.InferParameter(bool_param=True)
    return resp


class KserveGrpcFrontend:
    """The port's gRPC server exposing the ModelManager's pipelines."""

    def __init__(
        self, manager, *, host: str = "127.0.0.1", port: int = 0,
        request_timeout_s: float = 600.0,  # end-to-end deadline default
    ):
        self.manager = manager
        self.host = host
        self.port = port
        self.request_timeout_s = request_timeout_s
        self._server: Server | None = None

    # -- lifecycle ---------------------------------------------------------

    async def start(self) -> "KserveGrpcFrontend":
        self._server = Server()
        rpcs = {
            "ServerLive": unary_unary(
                self._server_live, pb.ServerLiveRequest.from_bytes,
                pb.ServerLiveResponse.to_bytes),
            "ServerReady": unary_unary(
                self._server_ready, pb.ServerReadyRequest.from_bytes,
                pb.ServerReadyResponse.to_bytes),
            "ServerMetadata": unary_unary(
                self._server_metadata, pb.ServerMetadataRequest.from_bytes,
                pb.ServerMetadataResponse.to_bytes),
            "ModelReady": unary_unary(
                self._model_ready, pb.ModelReadyRequest.from_bytes,
                pb.ModelReadyResponse.to_bytes),
            "ModelMetadata": unary_unary(
                self._model_metadata, pb.ModelMetadataRequest.from_bytes,
                pb.ModelMetadataResponse.to_bytes),
            "ModelInfer": unary_unary(
                self._model_infer, pb.ModelInferRequest.from_bytes,
                pb.ModelInferResponse.to_bytes),
            "ModelStreamInfer": unary_stream(
                self._model_stream_infer, pb.ModelInferRequest.from_bytes,
                pb.ModelStreamInferResponse.to_bytes),
        }
        self._server.add_service(SERVICE, rpcs)
        self.port = await self._server.start(self.host, self.port)
        log.info("kserve grpc frontend on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None

    # -- probes ------------------------------------------------------------

    async def _server_live(self, _req, _ctx) -> pb.ServerLiveResponse:
        return pb.ServerLiveResponse(live=True)

    async def _server_ready(self, _req, _ctx) -> pb.ServerReadyResponse:
        return pb.ServerReadyResponse(ready=bool(self.manager.names()))

    async def _server_metadata(self, _req, _ctx) -> pb.ServerMetadataResponse:
        return pb.ServerMetadataResponse(
            name="dynamo-tpu", version="0.2", extensions=[]
        )

    async def _model_ready(self, req, _ctx) -> pb.ModelReadyResponse:
        return pb.ModelReadyResponse(
            ready=self.manager.get(req.name) is not None
        )

    async def _model_metadata(self, req, ctx) -> pb.ModelMetadataResponse:
        pipe = self.manager.get(req.name)
        if pipe is None:
            await ctx.abort(
                StatusCode.NOT_FOUND, f"model {req.name!r} not found"
            )
        t = pb.ModelMetadataResponse.TensorMetadata
        return pb.ModelMetadataResponse(
            name=pipe.card.name,
            versions=["1"],
            platform="dynamo-tpu",
            inputs=[
                t(name="text_input", datatype="BYTES", shape=[1]),
                t(name="input_ids", datatype="INT32", shape=[-1]),
                t(name="openai_request", datatype="BYTES", shape=[1]),
                t(name="streaming", datatype="BOOL", shape=[1]),
            ],
            outputs=[
                t(name="text_output", datatype="BYTES", shape=[1]),
                t(name="output_ids", datatype="INT32", shape=[-1]),
                t(name="openai_response", datatype="BYTES", shape=[1]),
            ],
        )

    # -- inference ---------------------------------------------------------

    def _parse_request(self, req: pb.ModelInferRequest):
        """-> (pipe, body, streaming, mode) with mode in
        {"text", "tokens", "openai"}:

        text   — ``text_input`` BYTES prompt (+ sampling in parameters)
        tokens — ``input_ids`` INT32/INT64: tokens-in/tokens-out, the
                 worker wire protocol over KServe (ref tensor.rs)
        openai — ``openai_request`` BYTES holding a chat/completions
                 JSON body; responses carry ``openai_response`` chunks
        """
        pipe = self.manager.get(req.model_name)
        if pipe is None:
            raise KeyError(f"model {req.model_name!r} not found")
        text = None
        token_ids: list[int] | None = None
        openai_body: dict | None = None
        streaming = None  # None = caller's RPC decides the default
        for i, tensor in enumerate(req.inputs):
            if tensor.name == "text_input":
                contents = tensor_contents(tensor)
                if contents.bytes_contents:
                    text = contents.bytes_contents[0].decode("utf-8")
                elif i < len(req.raw_input_contents):
                    raw = req.raw_input_contents[i]
                    # raw BYTES tensors are length-prefixed (u32 LE)
                    text = raw[4:].decode("utf-8") if len(raw) >= 4 else ""
            elif tensor.name == "input_ids":
                contents = tensor_contents(tensor)
                token_ids = list(
                    contents.int_contents or contents.int64_contents
                )
            elif tensor.name == "openai_request":
                contents = tensor_contents(tensor)
                if not contents.bytes_contents:
                    raise ValueError("empty 'openai_request' tensor")
                try:
                    openai_body = json.loads(contents.bytes_contents[0])
                except json.JSONDecodeError as e:
                    raise ValueError(f"malformed openai_request: {e}") from e
                if not isinstance(openai_body, dict):
                    raise ValueError(
                        "openai_request must be a JSON object"
                    )
            elif tensor.name == "streaming":
                contents = tensor_contents(tensor)
                if contents.bool_contents:
                    streaming = bool(contents.bool_contents[0])

        params = {k: _param_value(v) for k, v in req.parameters.items()}
        if openai_body is not None:
            from dynamo_tpu_torch.frontend.validation import validate_request

            openai_body["model"] = req.model_name
            kind = "chat" if "messages" in openai_body else "completions"
            validate_request(openai_body, kind)
            if openai_body.get("stream"):
                streaming = True
            return pipe, openai_body, streaming, "openai"
        if token_ids is not None:
            body: dict[str, Any] = {"token_ids": token_ids}
            return pipe, self._apply_params(body, params), streaming, "tokens"
        if text is None:
            raise ValueError(
                "missing input tensor: one of text_input / input_ids / "
                "openai_request"
            )
        body = {"model": req.model_name, "prompt": text}
        return pipe, self._apply_params(body, params), streaming, "text"

    def _root_context(self, req, grpc_ctx, rid: str) -> Context:
        """Root Context for one inference RPC, WITH the end-to-end budget:
        the server default, tightened (never loosened) by a ``timeout_ms``
        request parameter or the caller's own gRPC deadline."""
        timeout_s = self.request_timeout_s
        raw = req.parameters.get("timeout_ms")
        if raw is not None:
            # one shared clamp rule for every serving surface
            # (runtime/context.py; the HTTP frontend uses the same)
            timeout_s = tighten_timeout_s(timeout_s, _param_value(raw))
        remaining = None
        time_remaining = getattr(grpc_ctx, "time_remaining", None)
        if callable(time_remaining):
            remaining = time_remaining()
        if remaining is not None:
            # an already-expired caller deadline must FAIL FAST, not
            # disable the budget: clamp to a tiny positive remainder so
            # admission raises DeadlineExceeded -> DEADLINE_EXCEEDED
            remaining = max(remaining, 0.001)
            timeout_s = (
                min(remaining, timeout_s) if timeout_s > 0 else remaining
            )
        deadline = time.monotonic() + timeout_s if timeout_s > 0 else None
        # tenancy metadata (same edge contract as the HTTP frontend's
        # validate_tenancy, over gRPC invocation metadata): validated
        # here and stamped into the baggage headers the engine's
        # fair-admission layer reads. Malformed values raise
        # RequestValidationError (a ValueError) -> INVALID_ARGUMENT at
        # the _parse_request call sites' existing mapping.
        headers: dict[str, str] = {}
        meta_fn = getattr(grpc_ctx, "invocation_metadata", None)
        if callable(meta_fn):
            from dynamo_tpu_torch.frontend.validation import validate_tenancy

            meta = {k.lower(): v for k, v in (meta_fn() or ())}
            tenant, priority = validate_tenancy(meta)
            headers[TENANT_HEADER] = tenant
            headers[PRIORITY_HEADER] = priority
        return Context(request_id=rid, headers=headers, deadline=deadline)

    @staticmethod
    def _apply_params(body: dict[str, Any], params: dict) -> dict[str, Any]:
        for key in ("max_tokens", "min_tokens", "top_k", "seed"):
            if params.get(key) is not None:
                body[key] = int(params[key])
        for key in ("temperature", "top_p"):
            if params.get(key) is not None:
                body[key] = float(params[key])
        if params.get("ignore_eos") is not None:
            body["ignore_eos"] = bool(params["ignore_eos"])
        return body

    def _preprocess(self, pipe, body: dict[str, Any], mode: str) -> dict:
        if mode == "tokens":
            from dynamo_tpu_torch.frontend.protocols import (
                make_preprocessed_request,
            )

            token_ids = list(body["token_ids"])
            ctx_len = pipe.preprocessor.context_length
            if len(token_ids) >= ctx_len:
                raise ValueError(
                    f"input_ids ({len(token_ids)} tokens) exceeds context "
                    f"length {ctx_len}"
                )
            max_tokens = min(
                int(body.get("max_tokens") or 256),
                ctx_len - len(token_ids),
            )
            return make_preprocessed_request(
                token_ids,
                max_tokens=max_tokens,
                temperature=body.get("temperature"),
                top_p=body.get("top_p"),
                top_k=body.get("top_k"),
                seed=body.get("seed"),
                ignore_eos=bool(body.get("ignore_eos", False)),
                min_tokens=int(body.get("min_tokens") or 0),
                eos_token_ids=[pipe.preprocessor.tokenizer.eos_token_id],
            )
        return pipe.preprocessor.preprocess(body)

    async def _generate(
        self, pipe, body: dict[str, Any], ctx: Context, mode: str = "text"
    ) -> AsyncIterator[dict[str, Any]]:
        preprocessed = self._preprocess(pipe, body, mode)
        async for d in pipe.generate(preprocessed, ctx):
            yield d

    async def _model_infer(self, req, grpc_ctx) -> pb.ModelInferResponse:
        try:
            pipe, body, streaming, mode = self._parse_request(req)
        except KeyError as e:
            await grpc_ctx.abort(StatusCode.NOT_FOUND, str(e))
        except ValueError as e:
            await grpc_ctx.abort(StatusCode.INVALID_ARGUMENT, str(e))
        if streaming is True:
            # unary RPC cannot stream (ref kserve.rs:225)
            await grpc_ctx.abort(
                StatusCode.INVALID_ARGUMENT,
                "streaming=true requires the ModelStreamInfer RPC",
            )
        rid = req.id or new_request_id()
        try:
            ctx = self._root_context(req, grpc_ctx, rid)
        except ValueError as e:  # malformed tenancy metadata
            await grpc_ctx.abort(StatusCode.INVALID_ARGUMENT, str(e))
        if mode == "openai":
            try:
                pre = pipe.preprocessor.preprocess(body)
            except ValueError as e:
                await grpc_ctx.abort(
                    StatusCode.INVALID_ARGUMENT, str(e)
                )
            prompt_tokens = len(pre["token_ids"])
            deltas = pipe.generate(pre, ctx)
            try:
                if "messages" in body:
                    agg = await pipe.preprocessor.aggregate_chat(
                        deltas, request_id=rid,
                        prompt_tokens=prompt_tokens, request=body,
                    )
                else:
                    agg = await pipe.preprocessor.aggregate_completions(
                        deltas, request_id=rid, prompt_tokens=prompt_tokens,
                    )
            except DeadlineExceeded as e:
                await grpc_ctx.abort(
                    StatusCode.DEADLINE_EXCEEDED, str(e)
                )
            except (ServiceUnavailable, OverQuota) as e:
                # draining/saturated -> UNAVAILABLE (the 503 of this
                # surface), tenant quota -> RESOURCE_EXHAUSTED (the
                # 429); both carry retry-after trailing metadata
                await _abort_backpressure(grpc_ctx, e)
            finally:
                ctx.stop_generating()
            return _openai_response(req.model_name, rid, agg, final=True)
        parts: list[str] = []
        out_ids: list[int] = []
        try:
            async for d in self._generate(pipe, body, ctx, mode):
                if d.get("text"):
                    parts.append(d["text"])
                out_ids.extend(d.get("token_ids") or ())
                if d.get("finish_reason") == "error":
                    await grpc_ctx.abort(
                        StatusCode.INTERNAL,
                        d.get("error") or "generation error",
                    )
        except DeadlineExceeded as e:
            await grpc_ctx.abort(StatusCode.DEADLINE_EXCEEDED, str(e))
        except (ServiceUnavailable, OverQuota) as e:
            await _abort_backpressure(grpc_ctx, e)
        finally:
            ctx.stop_generating()
        return _text_output_response(
            req.model_name, rid, "".join(parts), final=True,
            tokens=len(out_ids),
            token_ids=out_ids if mode == "tokens" else None,
        )

    async def _model_stream_infer(
        self, req, grpc_ctx
    ) -> AsyncIterator[pb.ModelStreamInferResponse]:
        try:
            pipe, body, streaming, mode = self._parse_request(req)
        except (KeyError, ValueError) as e:
            yield pb.ModelStreamInferResponse(error_message=str(e))
            return
        rid = req.id or new_request_id()
        try:
            ctx = self._root_context(req, grpc_ctx, rid)
        except ValueError as e:  # malformed tenancy metadata
            yield pb.ModelStreamInferResponse(error_message=str(e))
            return
        streaming = streaming is not False  # stream RPC defaults to True
        if mode == "openai":
            # OpenAI-over-gRPC streaming: one chunk object per response,
            # exactly the SSE payloads of the HTTP surface
            try:
                pre = pipe.preprocessor.preprocess(body)
            except ValueError as e:
                yield pb.ModelStreamInferResponse(error_message=str(e))
                return
            prompt_tokens = len(pre["token_ids"])
            deltas = pipe.generate(pre, ctx)
            chunks = (
                pipe.preprocessor.postprocess_chat_stream(
                    deltas, request_id=rid,
                    include_usage=bool(
                        (body.get("stream_options") or {}).get(
                            "include_usage"
                        )
                    ),
                    prompt_tokens=prompt_tokens, request=body,
                )
                if "messages" in body
                else pipe.preprocessor.postprocess_completions_stream(
                    deltas, request_id=rid,
                    include_usage=bool(
                        (body.get("stream_options") or {}).get(
                            "include_usage"
                        )
                    ),
                    prompt_tokens=prompt_tokens,
                )
            )
            try:
                # one-chunk lookahead: the final marker must land on the
                # actual LAST message (include_usage appends a usage
                # chunk AFTER the finish-reason chunk)
                prev = None
                async for chunk in chunks:
                    if prev is not None:
                        yield pb.ModelStreamInferResponse(
                            infer_response=_openai_response(
                                req.model_name, rid, prev, final=False
                            )
                        )
                    prev = chunk
                if prev is not None:
                    yield pb.ModelStreamInferResponse(
                        infer_response=_openai_response(
                            req.model_name, rid, prev, final=True
                        )
                    )
            except (DeadlineExceeded, ServiceUnavailable, OverQuota) as e:
                # mid-stream 504/503/429: the stream protocol reports
                # via error_message, mirroring the HTTP SSE error event;
                # backpressure refusals still land their retry hint as
                # trailing metadata
                if isinstance(e, (ServiceUnavailable, OverQuota)):
                    _stamp_retry_after(grpc_ctx, e.retry_after_s)
                yield pb.ModelStreamInferResponse(error_message=str(e))
            finally:
                ctx.stop_generating()
            return
        parts: list[str] = []  # aggregation when streaming=false
        all_ids: list[int] = []
        try:
            async for d in self._generate(pipe, body, ctx, mode):
                if d.get("finish_reason") == "error":
                    yield pb.ModelStreamInferResponse(
                        error_message=d.get("error") or "generation error"
                    )
                    return
                final = d.get("finish_reason") is not None
                if not streaming:
                    # streaming=false on the stream RPC: fold into ONE
                    # final response (ref tensor.rs:43-44)
                    if d.get("text"):
                        parts.append(d["text"])
                    all_ids.extend(d.get("token_ids") or ())
                    if final:
                        yield pb.ModelStreamInferResponse(
                            infer_response=_text_output_response(
                                req.model_name, rid, "".join(parts),
                                final=True, tokens=len(all_ids),
                                token_ids=(
                                    all_ids if mode == "tokens" else None
                                ),
                            )
                        )
                elif d.get("text") or d.get("token_ids") or final:
                    ids = list(d.get("token_ids") or ())
                    yield pb.ModelStreamInferResponse(
                        infer_response=_text_output_response(
                            req.model_name, rid, d.get("text") or "",
                            final=final,
                            tokens=len(ids),
                            token_ids=ids if mode == "tokens" else None,
                        )
                    )
        except (DeadlineExceeded, ServiceUnavailable, OverQuota) as e:
            if isinstance(e, (ServiceUnavailable, OverQuota)):
                _stamp_retry_after(grpc_ctx, e.retry_after_s)
            yield pb.ModelStreamInferResponse(error_message=str(e))
        finally:
            # client disconnect mid-stream cancels the backend request
            ctx.stop_generating()
