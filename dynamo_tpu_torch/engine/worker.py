"""Engine worker: build the torch engine and serve it (the counterpart of
dynamo_tpu/engine/worker.py, aggregated mode).

``launch_engine_worker`` builds ``InferenceEngine(spec, cfg, device=...)``,
optionally captures its decode graphs (``precompile``) off the event loop,
registers the model card (``kv_block_size`` = the page size, the router
mode, the tool-call and reasoning parsers) and the ``generate`` endpoint,
serves the ``admin`` endpoint (``clear_kv_blocks``, ``cache_status``,
``drain``, ``faults``), attaches the KV-event and load-metrics publishers
under the served instance id and starts the engine's step thread on the
calling loop: the step thread posts its tokens, its KV events and its load
to the loop that started it. Given a ``HealthCheckManager``, it canary-probes
the served endpoint and an ``EngineMonitor`` watches the step thread.

``python -m dynamo_tpu_torch.engine.worker --hub HOST:PORT`` (or ``python -m
dynamo_tpu_torch.cli worker``) runs one worker process: it connects to the
hub, serves, prints ``ENGINE_READY``, and on SIGTERM drains (withdraws its
instance key, refuses new requests, finishes the admitted ones, closes the
engine), prints its kernel launch counts and ``ENGINE_DRAINED leftover=N``,
and exits. The engine runs on the GPU; ``--device cpu`` runs it on the CPU.
``--health-port N`` (0 = any free port) serves ``/live``, ``/ready``,
``/health`` and ``/metrics`` there (prints ``SYSTEM_STATUS_PORT=``) and
canary-probes the worker every ``--health-interval`` seconds.

``--model-path DIR`` serves an HF-format checkpoint (``config.json`` and
``*.safetensors``, models/loader.py): the spec comes from its config and
the weights stream to the device. A directory that also holds tokenizer
files is served with that tokenizer (frontend/hf_tokenizer.py, read
without ``transformers``), as the reference does: its card names the
directory, and the guided vocabulary is built from it.

The default router mode is "kv", as the reference's: frontends route by
prefix overlap from this worker's KV events (kv_router/). The reference's
flags for features the port lacks raise NotImplementedError naming their
item: disagg (with its prefill router), KVBM, SPMD and meshes, tenancy,
multimodal. ``--spec ngram`` (or ``DYN_SPEC_MODE``) turns on speculative
decoding, with ``--spec-k-max`` and ``--spec-ngram-min/max``. The admin
``timeline`` op, which reads the flight recorder, answers an error naming item 13.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging

import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.frontend.model_card import register_llm
from dynamo_tpu_torch.frontend.hf_tokenizer import has_tokenizer_files
from dynamo_tpu_torch.frontend.tokenizer import load_tokenizer
from dynamo_tpu_torch.guided.vocab import TokenVocab
from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.parsers import make_reasoning_parser, make_tool_config
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.health import (
    EngineMonitor,
    HealthCheckConfig,
    HealthCheckManager,
    SystemStatusServer,
)
from dynamo_tpu_torch.runtime.hub_client import connect_hub
from dynamo_tpu_torch.runtime.logging_util import setup_logging
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

log = logging.getLogger("dynamo_tpu_torch.engine.worker")

PREFILL_COMPONENT = "prefill"


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
    router_mode: str = "kv",
    tool_call_parser: str | None = None,
    reasoning_parser: str | None = None,
    health=None,  # HealthCheckManager: canary-probe this worker's endpoint
    precompile: bool = False,
    device: str | torch.device | None = None,
    params=None,
    model_path: str | None = None,
) -> tuple[InferenceEngine, object]:
    """Build + register one aggregated engine worker in this process, on
    ``device`` (None = the GPU; no GPU raises), serving ``params`` (default:
    the seeded random init of ``engine_config.seed``), or the checkpoint in
    ``model_path`` (its spec from its config.json). Returns (engine, served
    generate endpoint)."""
    # an unknown parser name fails here, before the engine is built
    make_tool_config(tool_call_parser)
    make_reasoning_parser(reasoning_parser)
    if model_type not in ("chat", "completions"):
        raise NotImplementedError(
            f"model_type {model_type!r}: the port serves chat and completions "
            "models (embeddings are ROADMAP Queue A item 12)"
        )
    cfg = engine_config or EngineConfig()
    if model_path:
        if spec is not None or params is not None:
            raise ValueError(
                "pass either spec=/params= or model_path=, not both: with a "
                "checkpoint the spec comes from its config.json")
        if tokenizer == "mock" and has_tokenizer_files(model_path):
            tokenizer = model_path
    # a tokenizer the frontend cannot load fails here, before the weights
    tok = await asyncio.to_thread(load_tokenizer, tokenizer)
    if model_path:
        from dynamo_tpu_torch.models.loader import load_model_dir

        spec, params = await asyncio.to_thread(load_model_dir, model_path,
                                               device=device)
    spec = spec or ModelSpec.preset(model)
    guided_vocab = None
    if cfg.guided_mode != "off":
        # guided decoding needs the token -> surface-string table, built
        # once from the tokenizer the frontend registers for this model, so
        # the mask automaton and the detokenizer agree
        try:
            guided_vocab = await asyncio.to_thread(
                TokenVocab.from_tokenizer, tok, spec.vocab_size)
        except Exception as e:  # noqa: BLE001
            log.warning("guided decoding disabled: vocab build failed (%s)", e)
    engine = InferenceEngine(spec, cfg, params=params, device=device,
                             guided_vocab=guided_vocab)
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
        tool_call_parser=tool_call_parser,
        reasoning_parser=reasoning_parser,
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
        elif op == "drain":
            # operator-triggered drain: the SIGTERM path's withdraw-and-
            # stop-admitting, but the process stays up (exiting is the
            # operator's call)
            await _withdraw_and_begin_drain(drt, engine, served)
            yield {"ok": True, "inflight": engine.inflight()}
        elif op == "faults":
            # flip the process-wide fault registry live (runtime/faults.py):
            # {"op": "faults", "spec": "...", "seed": N} reconfigures;
            # {"op": "faults"} reports active rules + trip counters
            if "spec" in request:
                try:
                    FAULTS.configure(request.get("spec") or "", request.get("seed"))
                except ValueError as e:
                    yield {"ok": False, "error": str(e)}
                    return
            yield {"ok": True, **FAULTS.snapshot()}
        elif op == "timeline":
            yield {"ok": False, "error": "op 'timeline' needs the flight recorder, "
                                         "not ported (ROADMAP Queue A item 13)"}
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
    # KV events + load metrics under the served instance id: the id every
    # router's radix index and scheduler key this worker by
    wid = served.instance.instance_id
    comp_path = f"{namespace}/{component}"
    engine.events = KvEventPublisher(drt.hub, comp_path, wid).start()
    engine.metrics = WorkerMetricsPublisher(drt.hub, comp_path, wid).start()
    await engine.start()
    if health is not None:
        health.register(served)
        engine.monitor = EngineMonitor(drt, engine)
    engine._publish_metrics()
    log.info(
        "engine worker %x up: model=%s device=%s pages=%d slots=%d",
        served.instance.instance_id, spec.name, engine.device, cfg.num_pages,
        cfg.max_decode_slots,
    )
    return engine, served


def launch_counts() -> dict[str, int]:
    """Kernel launches in this process so far, by kernel and fp8 form
    (ops/cuda/build.py counters; graph replays included)."""
    from dynamo_tpu_torch.ops.cuda.build import KERNELS

    out: dict[str, int] = {}
    for fn in KERNELS:
        out[fn.__name__] = fn.launches
        out[fn.__name__ + "/fp8"] = fn.fp8_launches
    return out


def launch_base(engine: InferenceEngine) -> tuple:
    """The counters to report traffic from: taken after precompile, whose
    warm-up steps launch kernels for real."""
    return launch_counts(), engine.steps, engine._graphs.replays


def engine_launches(engine: InferenceEngine, base: tuple | None) -> dict:
    """Kernel launches, decode steps, graph replays and speculation counters
    since ``base`` (the ENGINE_LAUNCHES line of a worker or ``cli run``)."""
    counts, steps, replays = base or ({}, 0, 0)
    return {
        "launches": {k: v - counts.get(k, 0) for k, v in launch_counts().items()},
        "steps": engine.steps - steps, "replays": engine._graphs.replays - replays,
        "spec": engine.spec_snapshot() if engine._spec_on else None}


def _engine_config(args: argparse.Namespace) -> EngineConfig:
    """The reference's EngineConfig from the worker's flags (CLI beats the
    DYN_* env / DYN_CONFIG layer); flags of unported features raise here or
    in EngineConfig."""
    refused = [
        (args.mode != "aggregated", f"--mode {args.mode}: disaggregated serving "
         "(ROADMAP Queue A item 10)"),
        (args.kvbm_host_mb or args.kvbm_disk_mb or args.kvbm_disk_dir
         or args.kvbm_remote_blocks, "--kvbm-*: KVBM (ROADMAP Queue A item 10)"),
        (args.prefill_component != PREFILL_COMPONENT or args.prefill_router_mode != "kv"
         or args.max_local_prefill_length != 128 or args.always_remote_prefill,
         "--prefill-* / --max-local-prefill-length / --always-remote-prefill: "
         "disaggregated serving (ROADMAP Queue A item 10)"),
        (args.mirror or args.coordinator_address or args.num_processes is not None
         or args.process_id is not None,
         "--mirror / --coordinator-address: SPMD multi-host (ROADMAP Queue A item 11)"),
        (args.mm_tokens_per_image or args.image_token_id or args.mm_video_frames != 8,
         "--mm-*: multimodal (ROADMAP Queue A item 12)"),
    ]
    for hit, what in refused:
        if hit:
            raise NotImplementedError(f"{what} is not ported")
    env_cfg = RuntimeConfig.from_env()
    return EngineConfig(
        page_size=args.page_size,
        num_pages=args.num_pages,
        max_pages_per_seq=args.max_pages_per_seq,
        max_decode_slots=args.max_decode_slots,
        decode_steps_per_dispatch=args.decode_steps_per_dispatch,
        # serving workers ALWAYS pipeline, as the reference's do: burst N+1
        # dispatches with device-chained tokens while burst N's tokens are
        # on their way to the host (stops are detected up to
        # pipeline_depth bursts late, the overshoot discarded)
        pipeline_decode=True,
        max_prefill_chunk_tokens=args.max_prefill_chunk_tokens,
        tp=args.tp,
        sp=args.sp,
        ep=args.ep,
        spec_mode=args.spec if args.spec is not None else (env_cfg.spec_mode or "off"),
        spec_k_max=args.spec_k_max or env_cfg.spec_k_max or 8,
        spec_ngram_min=args.spec_ngram_min,
        spec_ngram_max=args.spec_ngram_max,
        guided_mode=args.guided if args.guided is not None else (
            env_cfg.guided_mode or "auto"),
        tenants=(args.tenant_quotas if args.tenant_quotas is not None
                 else (env_cfg.tenant_quotas or "")),
        max_waiting=args.max_waiting,
        preemption=args.preemption,
    )


async def _amain(args: argparse.Namespace, ecfg: EngineConfig) -> None:
    from dynamo_tpu_torch.models.llama import resolve_device

    device = resolve_device(args.device)  # no GPU and no --device cpu raises here
    rcfg = RuntimeConfig.from_env()
    if args.hub:
        rcfg.override_hub(args.hub)
    drt = DistributedRuntime(await connect_hub(rcfg.hub_target()), rcfg)
    engine = health = status_server = None
    try:
        if args.health_port >= 0:
            health = HealthCheckManager(drt, HealthCheckConfig(
                interval_s=args.health_interval, timeout_s=args.health_timeout))
            # a registry on the status server turns its /metrics on; the
            # exposition also renders every registered global provider
            # (quarantines, fault trips)
            status_server = await SystemStatusServer(
                health=health, metrics=MetricsRegistry(), port=args.health_port,
            ).start()
            print(f"SYSTEM_STATUS_PORT={status_server.port}", flush=True)
        engine, served = await launch_engine_worker(
            drt,
            namespace=args.namespace,
            component=args.component,
            endpoint=args.endpoint,
            model=args.model,
            model_path=args.model_path,
            model_name=args.model_name,
            model_type=args.model_type,
            tokenizer=args.tokenizer,
            engine_config=ecfg,
            router_mode=args.router_mode,
            tool_call_parser=args.tool_call_parser,
            reasoning_parser=args.reasoning_parser,
            health=health,
            precompile=args.precompile,
            device=device,
        )
        # launches from here on: precompile's warm-up steps are not traffic
        base = launch_base(engine)
        print("ENGINE_READY", flush=True)
        drain = _install_drain_handler(drt, engine, served, base)
        await drt.runtime.wait_for_shutdown()
        if drain["task"] is not None:
            await drain["task"]  # it closes the engine, then prints
    finally:
        if health is not None:
            await health.close()
        if status_server is not None:
            await status_server.stop()
        if engine is not None:
            await engine.close()
        await drt.close()


def _install_drain_handler(drt, engine, served, base) -> dict:
    """SIGTERM => graceful drain (k8s preStop / pod deletion path). Returns
    the state holding the drain task once one starts."""
    import signal

    state: dict = {"task": None}

    def on_sigterm() -> None:
        if state["task"] is not None:
            return  # second SIGTERM while draining: let the first finish
        # keep a strong reference: the loop holds tasks only weakly
        state["task"] = asyncio.get_running_loop().create_task(
            graceful_drain(drt, engine, served, base=base)
        )

    try:
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, on_sigterm)
    except (NotImplementedError, RuntimeError):  # pragma: no cover
        pass  # non-unix event loop
    return state


async def _withdraw_and_begin_drain(
    drt, engine, served, deadline_s: float | None = None
) -> None:
    """Steps 1-2 of the drain contract, shared by the SIGTERM path and the
    admin ``drain`` op: WITHDRAW the instance key from the hub (lease kept
    alive, so routers stop picking this worker within one watch event),
    then STOP ADMITTING (new generates refuse with ServiceUnavailable,
    whose Retry-After is the remaining drain window)."""
    try:
        await drt.hub.delete(served.instance.path)
    except (ConnectionError, RuntimeError) as e:
        log.warning("drain: instance withdrawal failed (%s)", e)
    engine.begin_drain(
        drt.config.drain_timeout_s if deadline_s is None else deadline_s
    )


async def graceful_drain(
    drt, engine, served, timeout_s: float | None = None, base=None
) -> None:
    """Worker drain (the k8s preStop contract):

    1. WITHDRAW this worker's instance key from the hub (lease kept alive);
    2. STOP ADMITTING: new generates refuse with ServiceUnavailable
       (retryable: migration re-drives them on a live worker);
    3. FINISH IN-FLIGHT work under the drain deadline;
    4. EXIT: runtime shutdown force-cancels whatever outlived the deadline,
       the engine closes (step thread joined, decode graphs released), the
       kernel launch counts since ``base`` are logged, then
       ``ENGINE_DRAINED leftover=N``.
    """
    timeout_s = drt.config.drain_timeout_s if timeout_s is None else timeout_s
    log.warning("SIGTERM: graceful drain (%d in flight, timeout %.0fs)",
                engine.inflight(), timeout_s)
    await _withdraw_and_begin_drain(drt, engine, served, timeout_s)
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    server = drt._server
    while loop.time() < deadline:
        if engine.inflight() == 0 and (server is None or server.num_inflight == 0):
            break
        await asyncio.sleep(0.1)
    leftover = engine.inflight()
    if leftover:
        log.warning("drain deadline: %d request(s) still in flight", leftover)
    # past the deadline the transport stop force-cancels at once
    await drt.shutdown(drain=True, drain_timeout=5.0 if leftover == 0 else 0.0)
    await engine.close()
    print("ENGINE_LAUNCHES " + json.dumps(engine_launches(engine, base)), flush=True)
    print(f"ENGINE_DRAINED leftover={leftover}", flush=True)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    ecfg = _engine_config(args)  # unported flags raise before any set-up
    setup_logging()
    try:
        asyncio.run(_amain(args, ecfg))
    except KeyboardInterrupt:
        pass


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="dynamo-tpu torch engine worker")
    p.add_argument("--hub", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--model", default="tiny-test", help="model preset name")
    p.add_argument("--model-path", default=None,
                   help="local HF-format checkpoint dir (config.json + "
                        "*.safetensors); the spec comes from its config")
    p.add_argument("--model-name", default=None, help="served model name")
    p.add_argument("--model-type", default="chat",
                   choices=["chat", "completions", "embeddings"])
    p.add_argument("--tokenizer", default="mock")
    p.add_argument("--device", default=None,
                   help="torch device of the engine (default: the GPU)")
    p.add_argument("--page-size", type=int, default=16)
    p.add_argument("--num-pages", type=int, default=2048)
    p.add_argument("--max-pages-per-seq", type=int, default=64)
    p.add_argument("--max-decode-slots", type=int, default=8)
    p.add_argument("--decode-steps-per-dispatch", type=int, default=1)
    p.add_argument("--max-prefill-chunk-tokens", type=int, default=512)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--sp", type=int, default=1)
    p.add_argument("--ep", type=int, default=1)
    p.add_argument("--router-mode", default="kv",
                   choices=["kv", "round_robin", "random"])
    p.add_argument("--tool-call-parser", default=None)
    p.add_argument("--reasoning-parser", default=None)
    p.add_argument("--mm-tokens-per-image", type=int, default=0)
    p.add_argument("--image-token-id", type=int, default=0)
    p.add_argument("--mm-video-frames", type=int, default=8)
    p.add_argument("--mode", default="aggregated",
                   choices=["aggregated", "prefill", "decode"])
    p.add_argument("--prefill-component", default=PREFILL_COMPONENT)
    p.add_argument("--prefill-router-mode", default="kv",
                   choices=["kv", "round_robin", "random"])
    p.add_argument("--max-local-prefill-length", type=int, default=128)
    p.add_argument("--always-remote-prefill", action="store_true")
    p.add_argument("--kvbm-host-mb", type=int, default=0)
    p.add_argument("--kvbm-disk-mb", type=int, default=0)
    p.add_argument("--kvbm-disk-dir", default=None)
    p.add_argument("--kvbm-remote-blocks", type=int, default=0)
    p.add_argument("--spec", default=None, choices=["off", "ngram"])
    p.add_argument("--spec-k-max", type=int, default=0)
    p.add_argument("--spec-ngram-min", type=int, default=1)
    p.add_argument("--spec-ngram-max", type=int, default=4)
    p.add_argument("--tenant-quotas", default=None)
    p.add_argument("--max-waiting", type=int, default=0)
    p.add_argument("--preemption", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--guided", default=None, choices=["auto", "off"],
                   help="guided decoding: 'auto' (default) serves "
                        "response_format / forced tool_choice with "
                        "on-device grammar masks (schema-conformant "
                        "output guaranteed at any temperature); 'off' "
                        "rejects guided requests. Default from "
                        "DYN_GUIDED_MODE, else auto")
    p.add_argument("--precompile", action=argparse.BooleanOptionalAction, default=False,
                   help="capture every decode graph variant before registering")
    p.add_argument("--health-port", type=int, default=-1)
    p.add_argument("--health-interval", type=float, default=5.0)
    p.add_argument("--health-timeout", type=float, default=5.0)
    p.add_argument("--mirror", default=None, choices=["leader", "follower"])
    p.add_argument("--coordinator-address", default=None)
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p.parse_args(argv)


if __name__ == "__main__":
    main()
