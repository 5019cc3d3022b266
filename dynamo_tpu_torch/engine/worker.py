"""Engine worker: build the torch engine and serve it (the counterpart of
dynamo_tpu/engine/worker.py).

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
prefix overlap from this worker's KV events (kv_router/). ``--kvbm-host-mb
N`` (with ``--kvbm-disk-mb`` / ``--kvbm-disk-dir`` and
``--kvbm-remote-blocks``, or ``launch_engine_worker(kvbm_config=)``) gives
the engine the KVBM tiers (kvbm/): host DRAM, local disk, and the hub's
object store under the worker's namespace; the admin ``cache_status``
reports their counters.

``--mode prefill|decode`` (``launch_engine_worker(mode=)``) splits serving
as the reference does (disagg/). A prefill worker gives its engine a
``KvTransferSource``, serves ``PrefillWorkerHandler`` on the prefill
component (``--prefill-component``, no model card) and puts its admin
endpoint there. A decode worker routes remote prefills over that component
(``--prefill-router-mode``: kv by default, round_robin or random), follows
the live policy key (``--max-local-prefill-length``,
``--always-remote-prefill``) and registers its card with a
``DecodeWorkerHandler`` as the front door (``engine.frontdoor``); its admin
``cache_status`` reports the pulls by route and the fallbacks. The
reference's flags for features the port lacks raise NotImplementedError
naming their item.

Tensor, expert, sequence and data parallelism (parallel/): PyTorch drives
one card per process, so a mesh of ``--sp S --ep E --tp T`` (and the
EngineConfig's ``dp``, which has no flag, as in the reference) is N = dp
x S x E x T processes (the reference's reshape order, tp innermost: rank
= (s * E + e) * T + t at dp 1). ``--tp``, ``--ep`` and/or ``--sp`` with no
coordinator starts ranks 1..N-1 on this host (one per ``cuda:<rank>``;
``spawn_local_followers``) and makes this process rank 0: PyTorch's
counterpart of the reference's one-process mesh over local devices. Every
rank but 0 replays, the ep, sp and dp replicas too. Across hosts every rank runs this
module with the reference's ``--coordinator-address``, ``--num-processes``
and ``--process-id`` (or ``DYN_COORDINATOR`` / ``DYN_NUM_PROCESSES`` /
``DYN_PROCESS_ID``). Rank 0 serves; every other rank builds an engine
shell (its shard of the weights and of the KV heads, the leader's
EngineConfig) that never registers, serves or samples, prints
``MULTIHOST_FOLLOWER_READY`` and replays the leader's step descriptors
(parallel/spmd.py, strict: a lost rank fails the engine loudly).
``DYN_TP_BACKEND=gloo`` runs the group on gloo (two ranks on one card, as
NCCL refuses a card twice; ``--no-cuda-graphs`` runs its steps eagerly,
as a capture over gloo raises).
``--mirror leader`` / ``--mirror follower`` is the reference's mirror
topology: each process holds the whole model, the follower
(``MIRROR_FOLLOWER_READY``) replays the leader's descriptors found through
the hub and rejoins through a state sync after a restart. With ``--tp N``
(or ``--ep`` / ``--sp``) each side is a group of N ranks: the mirror
group's rank 0 follows the leader's stream and relays it to its own ranks
(parallel/spmd.py). ``--mode prefill|decode`` runs under every mesh and
under a mirror: each rank of a prefill group exports its KV heads from a
transfer source of its own (its address in the group's store), and a
decode group installs every rank's heads (op ``kv_resume``); the
reference refuses disaggregation on its multi-host path, whose followers
do not replay exports. ``--model-type embeddings`` registers an
embeddings card (the frontend's /v1/embeddings). ``--mm-tokens-per-image``,
``--image-token-id`` and ``--mm-video-frames`` register a multimodal card:
the frontend splices that many placeholder ids per image and resolves the
images at an encode worker (multimodal/worker.py) before routing; an image
prompt must fit one prefill dispatch (``--max-prefill-chunk-tokens`` and the
top prefill bucket at least its length). ``--spec ngram`` (or ``DYN_SPEC_MODE``) turns on speculative
decoding, with ``--spec-k-max`` and ``--spec-ngram-min/max``. The admin
``timeline`` op answers from the flight recorder (runtime/flight.py): one
request's timeline by ``request_id``, or the summary view (active, the
recent ``n``, the retained errors and slowest). An ``EngineCollector``
(engine/telemetry.py) starts with the worker and feeds the
``dynamo_engine_*`` series on every /metrics surface of the process; the
engine closes it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os

import torch

from dynamo_tpu_torch.engine.config import EngineConfig, ModelSpec
from dynamo_tpu_torch.engine.core import InferenceEngine
from dynamo_tpu_torch.engine.telemetry import EngineCollector
from dynamo_tpu_torch.frontend.model_card import register_llm
from dynamo_tpu_torch.frontend.hf_tokenizer import has_tokenizer_files
from dynamo_tpu_torch.frontend.tokenizer import load_tokenizer
from dynamo_tpu_torch.guided.vocab import TokenVocab
from dynamo_tpu_torch.kv_router.publisher import KvEventPublisher, WorkerMetricsPublisher
from dynamo_tpu_torch.parsers import make_reasoning_parser, make_tool_config
from dynamo_tpu_torch.runtime.config import RuntimeConfig
from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.flight import FLIGHT
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
    kvbm_config=None,  # kvbm.KvbmConfig: the KVBM tiers, None = off
    mode: str = "aggregated",
    prefill_component: str = PREFILL_COMPONENT,
    prefill_router_mode: str = "kv",
    max_local_prefill_length: int = 128,
    always_remote_prefill: bool = False,
    mm_tokens_per_image: int = 0,
    image_token_id: int = 0,
    mm_video_frames: int = 8,
    mesh=None,
    spmd=None,
) -> tuple[InferenceEngine, object]:
    """Build + register one engine worker in this process, on ``device``
    (None = the GPU; no GPU raises), serving ``params`` (default: the seeded
    random init of ``engine_config.seed``), or the checkpoint in
    ``model_path`` (its spec from its config.json), in ``mode`` aggregated,
    prefill or decode. The serving front door (the engine or a disagg
    handler) is ``engine.frontdoor``. ``mesh`` / ``spmd``: this process is
    rank 0 of a tp group (``start_tp_group``) or a mirror leader. Returns
    (engine, served generate endpoint)."""
    if mode not in ("aggregated", "prefill", "decode"):
        raise ValueError(f"mode {mode!r}: aggregated, prefill or decode")
    if prefill_router_mode not in ("kv", "round_robin", "random"):
        raise ValueError(f"prefill_router_mode {prefill_router_mode!r}")
    # an unknown parser name fails here, before the engine is built
    make_tool_config(tool_call_parser)
    make_reasoning_parser(reasoning_parser)
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

        spec, params = await asyncio.to_thread(
            load_model_dir, model_path, mesh=mesh,
            device=mesh.device if mesh is not None else device)
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
    kvbm = None
    if kvbm_config is not None:
        from dynamo_tpu_torch.kvbm import KvBlockManager

        # G4 lives in the hub's object store under this namespace, shared
        # with every worker (of either package) in it
        kvbm = KvBlockManager(kvbm_config, hub=drt.hub,
                              loop=asyncio.get_running_loop(), namespace=namespace)
    transfer_source = None
    if mode == "prefill":
        from dynamo_tpu_torch.disagg.transfer import KvTransferSource

        transfer_source = await KvTransferSource(host=drt.config.host).start()
    engine = InferenceEngine(spec, cfg, params=params,
                             device=mesh.device if mesh is not None else device,
                             kvbm=kvbm, guided_vocab=guided_vocab,
                             transfer_source=transfer_source, mesh=mesh, spmd=spmd)
    if transfer_source is not None and engine.kv_shards > 1:
        # the ranks of this tp group export their KV heads from sources of
        # their own: their addresses are in the group's store
        transfer_source.peers = await shard_sources(
            engine.kv_shards, f"{namespace}/{component}/{endpoint}")
    if precompile:
        # capture every decode graph variant before registration, off the
        # event loop: no request waits for a capture
        await asyncio.to_thread(engine.precompile)

    if mode == "prefill":
        from dynamo_tpu_torch.disagg.handlers import PrefillWorkerHandler

        # no model card: only decode workers' prefill routers call it
        handler = PrefillWorkerHandler(engine)
        component = prefill_component
        served = await drt.namespace(namespace).component(component).endpoint(
            endpoint).serve(handler.generate,
                            metadata={"model": model_name or spec.name, "role": "prefill"})
    else:
        handler = engine
        if mode == "decode":
            from dynamo_tpu_torch.disagg.handlers import DecodeWorkerHandler
            from dynamo_tpu_torch.disagg.policy import DisaggPolicy

            prefill_router = await _build_prefill_router(
                drt, namespace, prefill_component, endpoint, prefill_router_mode,
                cfg.page_size)
            policy = await DisaggPolicy(
                max_local_prefill_length=max_local_prefill_length,
                always_remote=always_remote_prefill,
            ).watch(drt.hub, namespace)
            handler = DecodeWorkerHandler(engine, prefill_router=prefill_router,
                                          policy=policy)
        served, _card = await register_llm(
            drt, drt.namespace(namespace).component(component).endpoint(endpoint),
            handler.generate,
            model_name=model_name or spec.name,
            model_type=model_type,
            tokenizer=tokenizer,
            context_length=cfg.max_context,
            kv_block_size=cfg.page_size,
            router_mode=router_mode,
            tool_call_parser=tool_call_parser,
            reasoning_parser=reasoning_parser,
            mm_tokens_per_image=mm_tokens_per_image,
            image_token_id=image_token_id,
            mm_video_frames=(mm_video_frames if mm_tokens_per_image else 0),
            runtime_config={"engine": "torch", "device": str(engine.device),
                            "mode": mode, "tp": cfg.tp},
            metadata={"engine": "torch", "role": mode},
        )
    engine.frontdoor = handler

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
            # one request's event timeline by id, or the summary view; the
            # frontend's GET /debug/timeline fans this out
            try:
                n = int(request.get("n") or 16)
            except (TypeError, ValueError):
                n = 16
            yield {"ok": True, **FLIGHT.snapshot(request.get("request_id"), n=n)}
        elif op == "kv_digest":
            # every rank's digest of the pages in use: the leader's here,
            # each follower's on its stdout (SPMD_KV_DIGEST)
            yield {"ok": True, **(await engine.kv_digest())}
        elif op == "cache_status":
            yield {
                "ok": True,
                "active_pages": engine.allocator.active_pages,
                "cached_pages": engine.allocator.evictable_pages,
                "free_pages": engine.allocator.free_pages,
                # kernel launches and decode steps since the process began:
                # a caller reads them before and after a set of requests
                "launches": launch_counts(), "steps": engine.steps,
                "kvbm": (engine.kvbm.stats.to_dict()
                         if engine.kvbm is not None else None),
                "disagg": disagg_status(engine) if mode != "aggregated" else None,
                "spmd": ({"publishes": engine.spmd.publish_count,
                          "bytes": engine.spmd.publish_bytes,
                          "secs": engine.spmd.publish_secs,
                          "followers": engine.spmd.followers,
                          "healthy": engine.spmd.healthy}
                         if engine.spmd is not None else None),
            }
        else:
            yield {"ok": False, "error": f"unknown op {op!r}"}

    # a prefill worker's admin endpoint is on the prefill component
    await drt.namespace(namespace).component(component).endpoint("admin").serve(
        admin_handler, metadata={"role": "admin"})
    # KV events + load metrics under the served instance id: the id every
    # router's radix index and scheduler key this worker by
    wid = served.instance.instance_id
    comp_path = f"{namespace}/{component}"
    engine.events = KvEventPublisher(drt.hub, comp_path, wid).start()
    engine.metrics = WorkerMetricsPublisher(drt.hub, comp_path, wid).start()
    # the dynamo_engine_* series on every /metrics surface; engine.close()
    # closes the collector
    engine.telemetry = EngineCollector(engine).start()
    await engine.start()
    if health is not None:
        health.register(served)
        engine.monitor = EngineMonitor(drt, engine)
    engine._publish_metrics()
    log.info(
        "engine worker %x up: mode=%s model=%s device=%s pages=%d slots=%d",
        served.instance.instance_id, mode, spec.name, engine.device, cfg.num_pages,
        cfg.max_decode_slots,
    )
    return engine, served


async def _build_prefill_router(drt: DistributedRuntime, namespace: str,
                                prefill_component: str, endpoint: str,
                                router_mode: str, page_size: int):
    """Router over the prefill pool: KV-aware by default (a long prompt with
    a warm prefix lands on the prefill worker that has it cached), else
    round robin or random."""
    from dynamo_tpu_torch.runtime.push import PushRouter, RouterMode

    ep = drt.namespace(namespace).component(prefill_component).endpoint(endpoint)
    if router_mode == "kv":
        from dynamo_tpu_torch.kv_router.protocols import RouterConfig
        from dynamo_tpu_torch.kv_router.router import KvPushRouter, KvRouter

        push = await PushRouter.from_endpoint(ep, RouterMode.DIRECT)
        # the block size must be the engines' page size, or radix overlap
        # never matches
        kv = await KvRouter(drt.hub, f"{namespace}/{prefill_component}",
                            RouterConfig(block_size=page_size)).start()
        return KvPushRouter(push, kv)
    mode = RouterMode.RANDOM if router_mode == "random" else RouterMode.ROUND_ROBIN
    return await PushRouter.from_endpoint(ep, mode)


def disagg_status(engine: InferenceEngine) -> dict:
    """The admin ``cache_status`` disagg entry: this process's pulls by
    route with their times, the device route's fallbacks to TCP, the
    engine's pull fallbacks to a local prefill, its exports (the step
    thread's host ms, the gather's device ms once its events are done, the
    source's serve-time staging ms for TCP) and its resumes (the step
    thread's host ms, pages installed, its split) and its decode bursts'
    (dispatch, tokens on the host, a resume in between) on the monotonic
    clock every process of the host shares."""
    from dynamo_tpu_torch.disagg.transfer import PULLS

    src = engine.transfer_source
    exports = list(engine.export_times)
    return {**PULLS.snapshot(), "fallbacks": engine.disagg_fallbacks,
            "exported": src.exported if src is not None else 0,
            "pending_exports": src.pending if src is not None else 0,
            "stage_ms": list(src.stage_ms) if src is not None else [],
            "export_ms": [ms for _t, ms, _b in exports],
            "gather_ms": [t[0].elapsed_time(t[1]) for t, _ms, _b in exports
                          if t is not None and t[1].query()],
            "resumes": [list(r) for r in engine.resume_times],
            "spans": [list(s) for s in engine.decode_spans]}


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
    since ``base`` (the ENGINE_LAUNCHES line of a worker or ``cli run``);
    the decode dispatch-to-host over the engine's last 4096 dispatches, and
    over those with a disagg resume on the step thread in between."""
    counts, steps, replays = base or ({}, 0, 0)
    return {
        "launches": {k: v - counts.get(k, 0) for k, v in launch_counts().items()},
        "steps": engine.steps - steps, "replays": engine._graphs.replays - replays,
        "spec": engine.spec_snapshot() if engine._spec_on else None,
        "dispatch_ms": _mean_ms(engine.decode_step_times),
        "resume_dispatch_ms": _mean_ms([t1 - t0 for t0, t1, resumed in engine.decode_spans
                                        if resumed])}


def _mean_ms(times) -> list:
    """[count, mean ms] of wall seconds."""
    n = len(times)
    return [n, 1e3 * sum(times) / n if n else None]


def _engine_config(args: argparse.Namespace) -> EngineConfig:
    """The reference's EngineConfig from the worker's flags (CLI beats the
    DYN_* env / DYN_CONFIG layer); flags of unported features raise here or
    in EngineConfig. A rank that a leader started takes the leader's
    EngineConfig whole (``--engine-config-json``)."""
    if args.engine_config_json:
        return config_from_json(EngineConfig, args.engine_config_json)
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
        cuda_graphs=args.cuda_graphs,
    )


def _kvbm_config_from_args(args: argparse.Namespace):
    """The KVBM tiers the ``--kvbm-*`` flags ask for (None: KVBM off)."""
    if args.kvbm_host_mb <= 0:
        return None
    from dynamo_tpu_torch.kvbm import KvbmConfig

    return KvbmConfig(
        host_bytes=args.kvbm_host_mb * 1024 * 1024,
        disk_bytes=args.kvbm_disk_mb * 1024 * 1024,
        disk_dir=args.kvbm_disk_dir,
        remote_max_blocks=args.kvbm_remote_blocks,
    )


async def _amain(args: argparse.Namespace, ecfg: EngineConfig) -> None:
    from dynamo_tpu_torch.models.llama import resolve_device

    group_name = f"{args.namespace}/{args.component}/{args.endpoint}"
    rcfg = RuntimeConfig.from_env()
    if args.hub:
        rcfg.override_hub(args.hub)
    if args.mirror == "follower" and ecfg.dp * ecfg.sp * ecfg.ep * ecfg.tp == 1:
        await _run_mirror_follower(args, ecfg, group_name)
        return
    group = await start_tp_group(
        ecfg, model=args.model, model_path=args.model_path, device=args.device,
        group=group_name, coordinator=args.coordinator_address,
        num_processes=args.num_processes, process_id=args.process_id,
        spec_json=args.spec_json, kvbm_argv=_kvbm_argv(args), host=rcfg.host,
        mode=args.mode)
    if group is not None and not group.leader:
        await _run_tp_follower(args, ecfg, group, rcfg.host)
        return
    if args.mirror == "follower":
        # rank 0 of a mirror group: it follows the leader's stream and
        # relays it to its own ranks
        await _run_mirror_follower(args, ecfg, group_name, group)
        return
    device = (group.mesh.device if group is not None
              else resolve_device(args.device))  # no GPU, no --device cpu: raises
    drt = DistributedRuntime(await connect_hub(rcfg.hub_target()), rcfg)
    spmd = group.spmd if group is not None else None
    if args.mirror == "leader" and spmd is not None:
        # a tp group's leader serves its mirror group over the worker's hub
        await spmd.advertise(drt.hub)
    elif args.mirror == "leader":
        from dynamo_tpu_torch.parallel.spmd import SpmdLeader

        spmd = await SpmdLeader(drt.hub, asyncio.get_running_loop(), group_name,
                                host=drt.config.host, strict=False).start()
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
            kvbm_config=_kvbm_config_from_args(args),
            mode=args.mode,
            prefill_component=args.prefill_component,
            prefill_router_mode=args.prefill_router_mode,
            max_local_prefill_length=args.max_local_prefill_length,
            always_remote_prefill=args.always_remote_prefill,
            mm_tokens_per_image=args.mm_tokens_per_image,
            image_token_id=args.image_token_id,
            mm_video_frames=args.mm_video_frames,
            spec=_spec_from_args(args),
            mesh=group.mesh if group is not None else None,
            spmd=spmd,
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
        elif spmd is not None:
            spmd.stop()
            await spmd.close()
        await drt.close()
        if group is not None:
            await group.close()


# ------------------------------------------------------------ tp groups


def config_from_json(cls, text: str):
    """A config dataclass from its JSON (lists back to tuples)."""
    d = json.loads(text)
    return cls(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def config_json(obj) -> str:
    """A config dataclass as JSON (an EngineConfig without its tenants: a
    follower schedules nothing)."""
    import dataclasses

    d = dataclasses.asdict(obj)
    d.pop("tenants", None)
    return json.dumps(d)


def _spec_from_args(args: argparse.Namespace) -> ModelSpec | None:
    if args.spec_json:
        return config_from_json(ModelSpec, args.spec_json)
    return None


def _spec_json_or_preset(spec_json: str | None, model: str) -> ModelSpec:
    return config_from_json(ModelSpec, spec_json) if spec_json else ModelSpec.preset(model)


def _kvbm_argv(args: argparse.Namespace) -> list[str]:
    if args.kvbm_host_mb <= 0:
        return []
    out = ["--kvbm-host-mb", str(args.kvbm_host_mb)]
    if args.kvbm_disk_mb > 0:
        out += ["--kvbm-disk-mb", str(args.kvbm_disk_mb), "--kvbm-disk-dir",
                args.kvbm_disk_dir]
    return out


class TpGroup:
    """This process's place in a tp group: its ``mesh``, and on rank 0 the
    SPMD leader and the follower processes it started."""

    def __init__(self, mesh, spmd=None, procs=()):
        self.mesh = mesh
        self.spmd = spmd
        self.procs = list(procs)

    @property
    def leader(self) -> bool:
        return self.mesh.rank == 0

    async def close(self, timeout: float = 60.0) -> None:
        """Wait for the started followers (the engine's close sent them
        ``stop``), kill any that outlive ``timeout``, leave the group."""
        import subprocess

        from dynamo_tpu_torch.parallel.multihost import shutdown

        for p in self.procs:
            try:
                await asyncio.to_thread(p.wait, timeout)
            except subprocess.TimeoutExpired:
                log.warning("tp follower pid %d did not stop; killing it", p.pid)
                p.kill()
                await asyncio.to_thread(p.wait)
        shutdown()


async def start_tp_group(
    ecfg: EngineConfig, *, model: str = "tiny-test", model_path: str | None = None,
    spec_json: str | None = None, device=None,
    group: str = "dynamo/backend/generate", coordinator: str | None = None,
    num_processes: int | None = None, process_id: int | None = None,
    kvbm_argv: list[str] = (), host: str = "127.0.0.1", mode: str = "aggregated",
) -> TpGroup | None:
    """Join (or, for ``ecfg.dp * ecfg.sp * ecfg.ep * ecfg.tp`` > 1 with no
    coordinator, start) the group of this worker: None for a single process. With no
    coordinator this process starts ranks 1..N-1 here
    (``spawn_local_followers``:
    worker processes given the model, the device, this EngineConfig and
    the group's rendezvous) and becomes rank 0. Rank 0 gets the group's
    strict ``SpmdLeader``, its address in the group's store
    (``StoreHub``): ``host`` (the runtime config's) when it is routable,
    else the coordinator's host (``multihost.leader_host``)."""
    from dynamo_tpu_torch.parallel import multihost
    from dynamo_tpu_torch.parallel.mesh import make_mesh

    env_coord = coordinator or os.environ.get("DYN_COORDINATOR")
    world = ecfg.dp * ecfg.sp * ecfg.ep * ecfg.tp
    if world == 1 and not env_coord:
        return None  # one process: no group, nothing started
    procs = []
    if world > 1:
        # refuse a model that does not shard before any rank starts
        from dynamo_tpu_torch.models.convert import check_shardable
        from dynamo_tpu_torch.models.loader import spec_from_dir

        check_shardable(spec_from_dir(model_path) if model_path
                        else _spec_json_or_preset(spec_json, model),
                        {"tp": ecfg.tp, "ep": ecfg.ep})
    if world > 1 and not env_coord and not num_processes:
        coordinator = multihost.free_coordinator()
        ns, comp, ep = group.split("/")
        argv = ["--engine-config-json", config_json(ecfg), "--namespace", ns,
                "--component", comp, "--endpoint", ep, "--mode", mode, *kvbm_argv]
        if model_path:
            argv += ["--model-path", model_path]
        else:
            argv += ["--model", model]
            if spec_json:
                argv += ["--spec-json", spec_json]
        if device is not None:
            argv += ["--device", str(device)]
        procs = multihost.spawn_local_followers(world, argv, coordinator)
        num_processes, process_id = world, 0
        env_coord = coordinator
    try:
        joined = await asyncio.to_thread(
            multihost.initialize_multihost, coordinator, num_processes, process_id,
            device=device)
        if not joined:
            if world > 1:
                raise ValueError(f"EngineConfig dp={ecfg.dp} sp={ecfg.sp} ep={ecfg.ep} "
                                 f"tp={ecfg.tp} needs a group of {world} processes "
                                 "(--num-processes)")
            return None
        mesh = make_mesh(tp=ecfg.tp, ep=ecfg.ep, sp=ecfg.sp, dp=ecfg.dp)
        spmd = None
        if mesh.rank == 0:
            from dynamo_tpu_torch.parallel.spmd import SpmdLeader, StoreHub

            spmd = await SpmdLeader(StoreHub(), asyncio.get_running_loop(), group,
                                    host=multihost.leader_host(env_coord, host),
                                    strict=True).start()
        return TpGroup(mesh, spmd, procs)
    except BaseException:
        for p in procs:
            p.kill()
        raise


XFER_KEY_FMT = "spmd/{group}/xfer/{rank}"


async def shard_sources(tp: int, group: str, timeout: float = 120.0) -> list[dict]:
    """The transfer sources of ranks 1..tp-1 of this prefill group, as
    each published it in the group's store (``{addr, uid}``)."""
    from dynamo_tpu_torch.parallel.spmd import StoreHub

    hub, out = StoreHub(), []
    deadline = asyncio.get_running_loop().time() + timeout
    for r in range(1, tp):
        key = XFER_KEY_FMT.format(group=group, rank=r)
        while (raw := await hub.get(key)) is None:
            if asyncio.get_running_loop().time() > deadline:
                raise TimeoutError(f"no transfer source at {key}")
            await asyncio.sleep(0.1)
        out.append(json.loads(raw))
    return out


def build_engine_shell(args: argparse.Namespace, ecfg: EngineConfig, mesh=None,
                       hub=None, loop=None, transfer_source=None) -> InferenceEngine:
    """A follower's engine: the leader's spec and EngineConfig, this rank's
    shard of the same weights (the seeded init, or its slice of the
    checkpoint), its pools; its step loop never starts. With KVBM on it
    holds tiers of its own: the replayed offloads and onboards move this
    rank's shard of each block (G4 under a per-rank namespace)."""
    from dynamo_tpu_torch.models.llama import resolve_device

    dev = mesh.device if mesh is not None else resolve_device(args.device)
    params = None
    if args.model_path:
        from dynamo_tpu_torch.models.loader import load_model_dir

        spec, params = load_model_dir(args.model_path, mesh=mesh, device=dev)
    else:
        spec = _spec_from_args(args) or ModelSpec.preset(args.model)
    kvbm = None
    kvbm_cfg = _kvbm_config_from_args(args)
    if kvbm_cfg is not None:
        from dynamo_tpu_torch.kvbm import KvBlockManager

        rank = mesh.rank if mesh is not None else 0
        kvbm = KvBlockManager(kvbm_cfg, hub=hub, loop=loop,
                              namespace=f"{args.namespace}.s{rank}")
    return InferenceEngine(spec, ecfg, params=params, device=dev, kvbm=kvbm, mesh=mesh,
                           transfer_source=transfer_source)


async def _run_tp_follower(args, ecfg: EngineConfig, group: TpGroup,
                           host: str = "127.0.0.1") -> None:
    """Rank r > 0 of a tp group: replay the leader until its ``stop``. In a
    prefill group, rank r of the leader's tp coordinates exports its KV
    heads from a transfer source of its own, published in the group's
    store for the leader's params."""
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower, StoreHub

    name = f"{args.namespace}/{args.component}/{args.endpoint}"
    src = None
    m = group.mesh
    if args.mode == "prefill" and not any(c for a, c in m.coords.items() if a != "tp"):
        from dynamo_tpu_torch.disagg.transfer import KvTransferSource

        src = await KvTransferSource(host=host).start()
        await StoreHub().put(XFER_KEY_FMT.format(group=name, rank=m.tp_rank),
                             json.dumps({"addr": f"{src.host}:{src.port}", "uid": src.uid}))
    engine = await asyncio.to_thread(build_engine_shell, args, ecfg, m, None, None, src)
    print("MULTIHOST_FOLLOWER_READY", flush=True)
    try:
        await SpmdFollower(StoreHub(), name, engine, rejoin=False).run()
    finally:
        await engine.close()
        await group.close()


async def _run_mirror_follower(args, ecfg: EngineConfig, name: str,
                               group: TpGroup | None = None) -> None:
    """A mirror follower: the leader's model in this process (or, as rank
    0 of a mirror group, this rank's shard of it), replaying the leader's
    descriptors found through the hub, rejoining with a state sync when
    the stream is lost. A mirror group's rank 0 relays every descriptor to
    its ranks through its group's leader."""
    from dynamo_tpu_torch.parallel.spmd import SpmdFollower

    rcfg = RuntimeConfig.from_env()
    if args.hub:
        rcfg.override_hub(args.hub)
    hub = await connect_hub(rcfg.hub_target())
    mesh = group.mesh if group is not None else None
    engine = await asyncio.to_thread(build_engine_shell, args, ecfg, mesh, hub,
                                     asyncio.get_running_loop())
    print("MIRROR_FOLLOWER_READY", flush=True)
    relay = group.spmd if group is not None else None
    try:
        await SpmdFollower(hub, name, engine, rejoin=True, relay=relay).run()
    finally:
        await engine.close()
        if relay is not None:
            relay.stop()
            await relay.close()
            await group.close()
        await hub.close()


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
    p.add_argument("--sp", type=int, default=1,
                   help="sequence parallelism: cold prompts prefill as a ring over "
                        "S x --ep x --tp ranks, started here as --tp does")
    p.add_argument("--ep", type=int, default=1,
                   help="expert parallelism: the experts over E x --tp ranks, "
                        "started here as --tp does")
    p.add_argument("--router-mode", default="kv",
                   choices=["kv", "round_robin", "random"])
    p.add_argument("--tool-call-parser", default=None)
    p.add_argument("--reasoning-parser", default=None)
    p.add_argument("--mm-tokens-per-image", type=int, default=0,
                   help="placeholder tokens per image (0 = text-only); "
                        "requires an encode worker on the namespace")
    p.add_argument("--image-token-id", type=int, default=0)
    p.add_argument("--mm-video-frames", type=int, default=8,
                   help="frames sampled per video attachment (matches the "
                        "encode worker's --video-frames)")
    p.add_argument("--mode", default="aggregated",
                   choices=["aggregated", "prefill", "decode"])
    p.add_argument("--prefill-component", default=PREFILL_COMPONENT)
    p.add_argument("--prefill-router-mode", default="kv",
                   choices=["kv", "round_robin", "random"])
    p.add_argument("--max-local-prefill-length", type=int, default=128)
    p.add_argument("--always-remote-prefill", action="store_true")
    p.add_argument("--kvbm-host-mb", type=int, default=0,
                   help="host-DRAM KV tier budget in MiB (0 = KVBM off)")
    p.add_argument("--kvbm-disk-mb", type=int, default=0,
                   help="disk KV tier budget in MiB (0 = no disk tier)")
    p.add_argument("--kvbm-disk-dir", default=None)
    p.add_argument("--kvbm-remote-blocks", type=int, default=0,
                   help="G4 block cap in the hub object store (0 = off); "
                        "shared across workers")
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
    p.add_argument("--cuda-graphs", action=argparse.BooleanOptionalAction, default=True,
                   help="run decode and verify steps from captured CUDA graphs on a "
                        "card; --no-cuda-graphs runs them eagerly (a gloo tp group "
                        "needs it: its collectives cannot be captured)")
    p.add_argument("--health-port", type=int, default=-1)
    p.add_argument("--health-interval", type=float, default=5.0)
    p.add_argument("--health-timeout", type=float, default=5.0)
    p.add_argument("--mirror", default=None, choices=["leader", "follower"],
                   help="mirror topology: each process holds the whole model; "
                        "followers replay the leader's descriptors and rejoin "
                        "with a state sync after a restart")
    p.add_argument("--coordinator-address", default=None,
                   help="tp group rendezvous host:port (or DYN_COORDINATOR); "
                        "every rank of the group runs this module")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--engine-config-json", default=None,
                   help="the leader's EngineConfig (set on the ranks it starts)")
    p.add_argument("--spec-json", default=None,
                   help="a ModelSpec as JSON instead of a --model preset")
    args = p.parse_args(argv)
    if (args.kvbm_disk_mb > 0 or args.kvbm_disk_dir) and args.kvbm_host_mb <= 0:
        p.error("--kvbm-disk-* requires --kvbm-host-mb > 0 (KVBM is off)")
    if args.kvbm_disk_mb > 0 and not args.kvbm_disk_dir:
        p.error("--kvbm-disk-mb requires --kvbm-disk-dir")
    if args.kvbm_disk_dir and args.kvbm_disk_mb <= 0:
        p.error("--kvbm-disk-dir requires --kvbm-disk-mb > 0")
    return args


if __name__ == "__main__":
    main()
