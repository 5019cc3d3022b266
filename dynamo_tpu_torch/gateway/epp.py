"""Endpoint picker (EPP): cluster-native KV-aware routing decisions for
an inference gateway (the port's copy of dynamo_tpu/gateway/epp.py, on
frontend/http_server.py in place of aiohttp).

The reference integrates with the Kubernetes Gateway API inference
extension by patching the upstream EPP with a ``dyn-kv`` plugin whose
decision comes from the dynamo router (ref
deploy/inference-gateway/README.md + epp-patches/ — the plugin's selling
point over the stock EPP is MODEL-AWARE tokenization: the router runs
the deployed model's tokenizer inline instead of a generic
approximation). Here the picker IS the router, served over HTTP:

  POST /pick   {"model": ..., "prompt": ...}        (or "token_ids")
        -> 200 {"worker_id": ..., "endpoint": "host:port",
                "overlap_blocks": N}
           + x-gateway-destination-endpoint: host:port   (GIE header
           convention — ext-proc based gateways copy it onto the
           upstream route)
  GET  /healthz -> 200

The prompt tokenizes with the TARGET MODEL's tokenizer (discovered from
its model card), the KV router scores workers by radix overlap + load,
and the instance registry resolves the winner's serving address. Run as
``python -m dynamo_tpu_torch.gateway --hub ... --component backend``;
deploy/inference-gateway/ has the manifests wiring it behind an
HTTPRoute/InferencePool. The routes, payloads, headers, metrics, the
pickline fast path and the shard fan-out are the reference's; a
request's headers arrive lower-cased (HTTP header names are
case-insensitive).
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import time
from typing import Any

from dynamo_tpu_torch.frontend.http_server import HttpServer, Request, Response
from dynamo_tpu_torch.gateway.breaker import BreakerBoard, BreakerConfig
from dynamo_tpu_torch.kv_router.protocols import RouterConfig
from dynamo_tpu_torch.kv_router.router import KvRouter
from dynamo_tpu_torch.kv_router.sharding import shards_from_env
from dynamo_tpu_torch.runtime import tracing
from dynamo_tpu_torch.runtime.context import TENANT_HEADER
from dynamo_tpu_torch.runtime.component import INSTANCE_ROOT, Instance
from dynamo_tpu_torch.runtime.faults import FAULTS
from dynamo_tpu_torch.runtime.health import DegradationDetector, is_quarantined
from dynamo_tpu_torch.runtime.metrics import MetricsRegistry

log = logging.getLogger("dynamo_tpu_torch.gateway.epp")


class _PrefixCache:
    """Hub-watch-invalidated snapshot of one key prefix, with a TTL
    backstop (ROADMAP #7 EPP slice: steady-state picks must do ZERO hub
    round-trips — at 100s of instances the per-pick ``get_prefix`` scan
    was the pick-latency floor). A watch event clears the snapshot
    immediately (new/removed cards and instances land within one hub
    watch delivery); the TTL bounds staleness when the watch stream is
    down and the hub only answers plain RPCs."""

    def __init__(self, hub, prefix: str, ttl_s: float, on_lookup=None):
        self.hub = hub
        self.prefix = prefix
        self.ttl_s = ttl_s
        # observability hook: called with "hit" | "miss" per get() (the
        # EPP bridges it into dynamo_epp_cache_lookups_total)
        self.on_lookup = on_lookup
        self._snap: dict[str, Any] | None = None
        self._expiry = 0.0
        # invalidation generation: a watch event arriving WHILE a scan
        # is in flight must not be overwritten by that scan's (pre-event)
        # result — the refill only installs its snapshot if no
        # invalidate() happened since it started
        self._gen = 0
        # single-flight refill: N concurrent picks missing the cache
        # share ONE hub scan instead of issuing a burst of N
        self._refill: asyncio.Task | None = None
        self.scans = 0  # hub round-trips actually paid (observability)

    async def get(self) -> dict[str, Any]:
        hit = self._snap is not None and time.monotonic() < self._expiry
        if self.on_lookup is not None:
            self.on_lookup("hit" if hit else "miss")
        if hit:
            return self._snap
        if self._refill is None or self._refill.done():
            self._refill = asyncio.get_running_loop().create_task(
                self._do_refill()
            )
        return await self._refill

    async def _do_refill(self) -> dict[str, Any]:
        gen = self._gen
        snap = await self.hub.get_prefix(self.prefix)
        self.scans += 1
        if gen == self._gen:
            self._snap = snap
            self._expiry = time.monotonic() + self.ttl_s
        # an invalidation raced the scan: serve this (possibly pre-event)
        # snapshot to the waiters but do NOT cache it — the next get()
        # re-scans and sees the post-event state
        return snap

    def invalidate(self) -> None:
        self._gen += 1
        self._snap = None

    async def watch(self) -> None:
        """Invalidation loop (spawned by start()): any event under the
        prefix drops the snapshot. A dead hub ends the loop — the TTL
        keeps answers bounded-stale until the process is restarted or
        the hub returns on the RPC path."""
        try:
            async for _ev in self.hub.watch_prefix(
                self.prefix, initial=False
            ):
                self.invalidate()
        except (ConnectionError, RuntimeError) as e:
            log.warning(
                "EPP watch on %r ended (%s); falling back to the %.1fs "
                "TTL", self.prefix, e, self.ttl_s,
            )


class EndpointPicker:
    def __init__(
        self,
        drt,
        *,
        namespace: str = "dynamo",
        target_component: str = "backend",
        target_endpoint: str = "generate",
        config: RouterConfig | None = None,
        host: str = "0.0.0.0",
        port: int = 9002,
        card_ttl_s: float = 2.0,
        breaker_config: "BreakerConfig | None" = None,
        pick_port: int | None = None,
        shard_id: int = 0,
        shards: int = 1,
    ):
        self.drt = drt
        self.namespace = namespace
        self.target_component = target_component
        self.target_endpoint = target_endpoint
        self.config = config
        self.host = host
        self.port = port
        # pickline fast path: persistent-connection newline-JSON picks
        # (gateway/pickline.py); None = disabled, 0 = ephemeral port
        self.pick_port = pick_port
        self._pickline = None
        # prefix-hash sharding (kv_router/sharding.py ShardMap): which
        # shard of the routing data plane this process serves — purely
        # observational here (the map lives at the dispatcher), exported
        # as the dynamo_router_shard_id gauge
        self.shard_id = shard_id
        self.shards = shards
        self.kv: KvRouter | None = None
        self._tokenizers: dict[str, Any] = {}
        self._http: HttpServer | None = None
        self.picks = 0
        # pick-path telemetry (complements the hub_scans healthz
        # field): pick latency histogram + per-cache hit/miss counters,
        # served on this process's /metrics route
        self.metrics = MetricsRegistry()
        self._m_pick = self.metrics.histogram(
            "epp_pick_seconds", "EPP pick-path latency",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0),
        )
        self._m_cache = self.metrics.counter(
            "epp_cache_lookups_total",
            "pick-path prefix-cache lookups", ["cache", "outcome"],
        )
        # per-instance circuit breakers (gateway/breaker.py): rolling
        # error/latency scoring over reported pick outcomes; OPEN
        # instances are excluded from picks, half-open probes re-admit
        # recovered workers. State gauge: 0 closed / 1 half-open / 2 open.
        self._m_breaker = self.metrics.gauge(
            "epp_breaker_state",
            "per-instance circuit-breaker state "
            "(0 closed, 1 half-open, 2 open)", ["instance"],
        )
        self.breakers = BreakerBoard(
            breaker_config or BreakerConfig(),
            on_state=lambda iid, st: self._m_breaker.labels(
                f"{iid:x}"
            ).set(st),
            on_forget=self._drop_breaker_series,
        )
        # pick-path caches: model cards (tokenizer resolution) and
        # instance records (winner address) — both watch-invalidated
        # with a TTL backstop, so a steady-state pick touches the hub
        # zero times (tests/test_gateway_epp.py micro-benchmark)
        from dynamo_tpu_torch.frontend.model_card import MDC_ROOT

        self._cards = _PrefixCache(
            drt.hub, MDC_ROOT + "/", card_ttl_s,
            on_lookup=lambda o: self._m_cache.labels("cards", o).inc(),
        )
        self._instances = _PrefixCache(
            drt.hub,
            f"{INSTANCE_ROOT}/{namespace}/{target_component}/"
            f"{target_endpoint}/",
            card_ttl_s,
            on_lookup=lambda o: self._m_cache.labels("instances", o).inc(),
        )
        # per-snapshot endpoint memo (see _endpoint_of)
        self._ep_snapshot: dict | None = None
        self._ep_map: dict[int, str] = {}
        # gray-failure plane: quarantined instance ids (from the card
        # metadata the health plane flips) and peer-relative straggler
        # scoring over the step_time_ms fingerprints workers publish —
        # both join the breaker exclude= set, inheriting its fail-open
        self._quarantined_ids: set[int] = set()
        self.degradation = DegradationDetector()
        self.degradation.export_metrics()
        self._watch_tasks: list[asyncio.Task] = []

    async def start(self) -> "EndpointPicker":
        from dynamo_tpu_torch.kv_router.router import ROUTER_SHARD_GAUGE
        from dynamo_tpu_torch.runtime.context import spawn

        self.kv = await KvRouter(
            self.drt.hub,
            f"{self.namespace}/{self.target_component}",
            self.config,
        ).start()
        ROUTER_SHARD_GAUGE.set(self.shard_id)
        self._watch_tasks = [
            spawn(self._cards.watch(), name="epp-cards-watch"),
            spawn(self._instances.watch(), name="epp-instances-watch"),
        ]
        if self.pick_port is not None:
            from dynamo_tpu_torch.gateway.pickline import PickLineServer

            self._pickline = await PickLineServer(
                self, host=self.host, port=self.pick_port,
            ).start()
            self.pick_port = self._pickline.port
        http = HttpServer()
        http.add_route("POST", "/pick", self._pick)
        http.add_route("POST", "/report", self._report)
        http.add_route("GET", "/healthz", self._healthz)
        http.add_route("GET", "/metrics", self._metrics)
        self.port = await http.start(self.host, self.port)
        self._http = http
        log.info("EPP listening on %s:%d (target %s/%s)",
                 self.host, self.port, self.namespace,
                 self.target_component)
        return self

    # -- helpers -----------------------------------------------------------

    async def _tokenizer_for(self, model: str | None):
        """The deployed model's OWN tokenizer, from its model card — the
        dyn-kv plugin's advantage over generic-tokenizer EPPs. A NAMED
        model with no matching card returns None (the route 404s): a
        typo'd name must not silently tokenize with the mock fallback
        and return confidently wrong block hashes/overlap estimates.
        Only an OMITTED model may fall back to the first card (or the
        mock tokenizer when no cards exist yet).

        The card scan is served from the watch-invalidated cache: a new
        or removed card lands within one watch delivery (TTL-bounded
        when the watch is down), and a steady-state pick pays zero hub
        round-trips here."""
        from dynamo_tpu_torch.frontend.tokenizer import load_tokenizer

        cards = await self._cards.get()
        card = None
        for _key, value in sorted(cards.items()):
            if model is None or value.get("name") == model:
                card = value
                break
        if model is not None and card is None:
            return None  # unknown model: the caller 404s
        tok_name = (card or {}).get("tokenizer", "mock")
        if tok_name not in self._tokenizers:
            self._tokenizers[tok_name] = load_tokenizer(tok_name)
        return self._tokenizers[tok_name]

    def _refresh_instance_memo(self, entries: dict) -> None:
        # memoized per snapshot object: re-parsing every Instance dict on
        # every pick made endpoint resolution an O(instances) tax on the
        # decision hot path. The same parse harvests quarantine flags.
        if entries is self._ep_snapshot:
            return
        self._ep_map = {}
        self._quarantined_ids = set()
        for raw in entries.values():
            inst = Instance.from_dict(raw)
            self._ep_map[inst.instance_id] = f"{inst.host}:{inst.port}"
            if is_quarantined(inst):
                self._quarantined_ids.add(inst.instance_id)
        self._ep_snapshot = entries

    async def _gray_excluded(self) -> set[int]:
        """Soft-withdrawn capacity: quarantined instance cards plus
        workers the DegradationDetector scores as stragglers. Joined to
        the breaker exclusions, so the scheduler's fail-open (serve
        SOMEONE rather than no one) covers gray failures too."""
        self._refresh_instance_memo(await self._instances.get())
        if self.kv is not None:
            for w in self.kv.scheduler.workers():
                self.degradation.observe(w.worker_id, w.metrics.step_time_ms)
        return self._quarantined_ids | set(self.degradation.degraded())

    async def _endpoint_of(self, worker_id: int) -> str | None:
        # second attempt after a forced re-scan: the router may know a
        # winner the cached snapshot predates (fresh worker between
        # watch deliveries) — one refetch before answering 503
        for attempt in range(2):
            self._refresh_instance_memo(await self._instances.get())
            endpoint = self._ep_map.get(worker_id)
            if endpoint is not None:
                return endpoint
            if attempt == 0:
                self._instances.invalidate()
        return None

    # -- routes ------------------------------------------------------------

    async def _healthz(self, _req: Request) -> Response:
        return Response.json({
            "status": "ok",
            "picks": self.picks,
            # hub round-trips actually paid for cards/instances: with
            # the pick-path caches warm this stays flat while picks grow
            "hub_scans": self._cards.scans + self._instances.scans,
            "shard": self.shard_id,
            "shards": self.shards,
            "pick_port": self.pick_port,
        })

    async def _metrics(self, _req: Request) -> Response:
        return Response(200, self.metrics.exposition(),
                        content_type="text/plain; charset=utf-8")

    def observe_pick(self, seconds: float) -> None:
        """Record one pick-path latency (shared with the pickline
        transport, which has no HTTP route to hook)."""
        self._m_pick.observe(seconds)

    async def _pick(self, req: Request) -> Response:
        """One routing decision. Joined to the caller's W3C trace when a
        ``traceparent`` header rides along (the GIE ext-proc forwards
        request headers), so the pick shows up in the same trace as the
        completion it routed; latency lands in dynamo_epp_pick_seconds
        either way."""
        t0 = time.monotonic()
        tracing.bind_trace(req.headers)
        with tracing.span("epp.pick"):
            try:
                return await self._pick_inner(req)
            finally:
                self._m_pick.observe(time.monotonic() - t0)

    async def _pick_inner(self, req: Request) -> Response:
        try:
            body = req.json()
        except ValueError:
            # mapped to a typed 400 response: the client sees what failed
            return Response.json({"error": "body must be JSON"}, status=400)
        status, payload, headers = await self.pick_decision(body)
        return Response.json(payload, status=status, headers=headers)

    async def pick_decision(
        self, body: dict
    ) -> tuple[int, dict, dict]:
        """ONE routing decision from a parsed /pick body — the shared
        core of the HTTP route and the pickline fast path. Returns
        (http_status, response_payload, response_headers)."""
        token_ids = body.get("token_ids")
        if token_ids is None:
            prompt = body.get("prompt")
            if not isinstance(prompt, str):
                return 400, {
                    "error": "one of token_ids or prompt is required"
                }, {}
            tok = await self._tokenizer_for(body.get("model"))
            if tok is None:
                return 404, {
                    "error": f"no model card named {body.get('model')!r}"
                }, {}
            token_ids = tok.encode(prompt)
        rid = body.get("request_id", "epp")
        try:
            # decision-only probe: find + free, like the router service's
            # best_worker endpoint (kv_router/service.py). Breaker-
            # ejected instances are excluded from the candidate set;
            # a HALF-OPEN winner consumes a probe slot via allow() and,
            # when its probe budget is spent, the pick re-runs with it
            # excluded too (fail open when exclusions empty the pool).
            if self.picks and self.picks % 256 == 0:
                # periodic breaker GC: drop state (and gauge series) for
                # instances that left the fleet, so worker churn cannot
                # grow the board without bound
                self.breakers.forget(self._live_instance_ids())
            excluded = set(self.breakers.ejected()) | (
                await self._gray_excluded()
            )
            # enough attempts to walk past every breaker-limited
            # instance before fail-open kicks in — a constant cap would
            # route to a disallowed worker while healthy ones remain
            attempts = max(3, len(self._live_instance_ids()) + 1)
            # tenant tag for cluster-level steering: an explicit body
            # field wins, else the forwarded request headers (the GIE
            # ext-proc sends them along). Absent tag = no steering.
            tenant = (
                body.get("tenant")
                or (body.get("headers") or {}).get(TENANT_HEADER)
                or None
            )
            for _attempt in range(attempts):
                worker_id, overlap = self.kv.find_best_match(
                    rid, list(token_ids), exclude=excluded or None,
                    tenant=tenant,
                )
                self.kv.free(rid)
                if worker_id in excluded or self.breakers.allow(worker_id):
                    # in `excluded` means the exclusion was overridden
                    # (it would have emptied the pool): serve fail-open
                    break
                excluded = set(excluded) | {worker_id}
        except Exception as e:  # noqa: BLE001 — no workers yet
            return 503, {"error": f"no routable worker: {e}"}, {}
        if FAULTS.enabled:
            try:
                # chaos hook: an injected error at epp.breaker records a
                # FAILURE outcome against the picked instance — a sick
                # worker simulated at the scoring layer, so schedules can
                # prove eject -> brownout -> half-open -> recovery
                # without a genuinely broken engine
                await FAULTS.fire("epp.breaker")
            except Exception as e:  # noqa: BLE001 - injected outcome
                log.warning(
                    "epp.breaker fault: recording failure against %x "
                    "(%s)", worker_id, e,
                )
                self.breakers.record(worker_id, ok=False)
        endpoint = await self._endpoint_of(worker_id)
        if endpoint is None:
            return 503, {
                "error": f"worker {worker_id:x} has no registered "
                         "instance"
            }, {}
        self.picks += 1
        payload = {
            "worker_id": worker_id,
            "endpoint": endpoint,
            "overlap_blocks": overlap,
        }
        if self.shards > 1:
            payload["shard"] = self.shard_id
        return 200, payload, {"x-gateway-destination-endpoint": endpoint}

    def _drop_breaker_series(self, iid: int) -> None:
        """Remove a departed instance's epp_breaker_state series — a
        phantom 'open' gauge for a worker that no longer exists would
        mislead every dashboard built on it."""
        try:
            self._m_breaker.remove(f"{iid:x}")
        except KeyError:
            pass  # series never materialized for this instance

    def _live_instance_ids(self) -> set[int]:
        """Worker ids the router currently schedules over (its instance
        watch keeps this current) — the breaker board's membership."""
        if self.kv is None:
            return set()
        return {w.worker_id for w in self.kv.scheduler.workers()}

    async def _report(self, req: Request) -> Response:
        """Outcome feedback for the circuit breakers: the gateway (or
        any caller that acted on a /pick) posts what actually happened
        to the routed request::

            POST /report {"worker_id": N | "hex", "ok": bool,
                          "latency_ms": float}

        Errors and over-SLO latencies push the instance toward OPEN
        (ejected from picks); successes close a half-open breaker."""
        try:
            body = req.json()
        except ValueError:  # mapped to a typed 400 response
            return Response.json({"error": "body must be JSON"}, status=400)
        raw = body.get("worker_id")
        try:
            worker_id = int(raw, 16) if isinstance(raw, str) else int(raw)
        except (TypeError, ValueError):
            return Response.json(
                {"error": "worker_id must be an int or hex string"},
                status=400,
            )
        ok = body.get("ok")
        if not isinstance(ok, bool):
            return Response.json({"error": "ok must be a boolean"}, status=400)
        try:
            latency_s = float(body.get("latency_ms") or 0.0) / 1000.0
        except (TypeError, ValueError):
            return Response.json({"error": "latency_ms must be a number"},
                                 status=400)
        if (
            worker_id not in self._live_instance_ids()
            and not self.breakers.knows(worker_id)
        ):
            # reports only mint breaker state for instances the router
            # actually knows (or already-tracked ones mid-deregistration)
            # — arbitrary caller-supplied ids must not grow the board
            return Response.json({"error": f"unknown worker {worker_id:x}"},
                                 status=404)
        self.breakers.record(worker_id, ok, latency_s)
        return Response.json({
            "worker_id": worker_id,
            "state": self.breakers.state_name(worker_id),
        })

    async def close(self) -> None:
        for t in self._watch_tasks:
            t.cancel()
        if self._pickline is not None:
            await self._pickline.close()
        if self.kv is not None:
            await self.kv.save_snapshot()
            await self.kv.close()
        if self._http is not None:
            await self._http.stop()


async def _amain(args: argparse.Namespace) -> None:
    from dynamo_tpu_torch.runtime.config import RuntimeConfig
    from dynamo_tpu_torch.runtime.distributed import DistributedRuntime
    from dynamo_tpu_torch.runtime.hub_client import connect_hub

    rcfg = RuntimeConfig.from_env()
    if args.hub:
        rcfg.override_hub(args.hub)
    drt = DistributedRuntime(await connect_hub(rcfg.hub_target()), rcfg)
    epp = await EndpointPicker(
        drt,
        namespace=args.namespace,
        target_component=args.component,
        target_endpoint=args.endpoint,
        config=RouterConfig(block_size=args.block_size),
        host=args.host,
        port=args.port,
        pick_port=args.pick_port if args.pick_port >= 0 else None,
        shard_id=args.shard_id or 0,
        shards=args.shards,
    ).start()
    print(f"DYNAMO_EPP={epp.host}:{epp.port}", flush=True)
    if epp.pick_port is not None:
        print(f"DYNAMO_EPP_PICK={epp.host}:{epp.pick_port}", flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await epp.close()
        await drt.close()


def shard_child_argv(args: argparse.Namespace, shard_id: int) -> list[str]:
    """argv for one spawned shard sibling: same deployment knobs, its
    own --shard-id, and ports offset by shard id (0 stays 0 =
    ephemeral). Split out so the supervisor's fan-out is unit-testable
    without spawning anything."""
    import sys

    argv = [
        sys.executable, "-m", "dynamo_tpu_torch.gateway",
        "--namespace", args.namespace,
        "--component", args.component,
        "--endpoint", args.endpoint,
        "--block-size", str(args.block_size),
        "--host", args.host,
        "--port", str(args.port + shard_id if args.port else 0),
        "--shards", str(args.shards),
        "--shard-id", str(shard_id),
    ]
    if args.hub:
        argv += ["--hub", args.hub]
    if args.pick_port >= 0:
        argv += ["--pick-port",
                 str(args.pick_port + shard_id if args.pick_port else 0)]
    return argv


def _run_shard_supervisor(args: argparse.Namespace) -> int:
    """``--shards N`` with no explicit --shard-id: spawn one EPP process
    per shard (each running the FULL router state off the same hub
    watch; dispatchers map picks to shards with
    kv_router.sharding.ShardMap) and babysit them — one dying takes the
    set down so the deployment restarts it whole. SIGTERM/SIGINT tear
    the children down too: SIGTERM's default disposition would kill
    only the supervisor and orphan the shards (observed live — orphans
    held the ports and wedged the next deployment)."""
    import signal
    import subprocess

    def _bail(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _bail)
    signal.signal(signal.SIGINT, _bail)
    # spawn INSIDE the try: a Popen failing mid-fan-out (ENOMEM, exec
    # error) must still tear down the shards already started, or they
    # orphan holding the ports — the exact wedge this supervisor's
    # SIGTERM handling exists to prevent
    procs: list = []
    rc = 0
    try:
        for i in range(args.shards):
            procs.append(subprocess.Popen(shard_child_argv(args, i)))
        while True:
            for p in procs:
                code = p.poll()
                if code is not None:
                    rc = code or 1
                    raise KeyboardInterrupt
            # the supervisor runs instead of an event loop: it only
            # babysits the shard processes
            time.sleep(0.5)
    except KeyboardInterrupt:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            # last-resort teardown: a shard that ignores SIGTERM for 10 s
            # is killed
            except Exception:  # noqa: BLE001
                p.kill()
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser("dynamo-tpu torch endpoint picker (EPP)")
    p.add_argument("--hub", default=None)
    p.add_argument("--namespace", default="dynamo")
    p.add_argument("--component", default="backend")
    p.add_argument("--endpoint", default="generate")
    p.add_argument("--block-size", type=int, default=16)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=9002)
    p.add_argument("--pick-port", type=int, default=-1,
                   help="pickline fast-path port (0 = ephemeral; "
                        "omit to disable)")
    p.add_argument("--shards", type=int,
                   default=shards_from_env(),
                   help="prefix-hash shard count (DYN_ROUTER_SHARDS); "
                        ">1 without --shard-id spawns one EPP process "
                        "per shard")
    p.add_argument("--shard-id", type=int, default=None,
                   help="which shard THIS process serves (0-based)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.shards > 1 and args.shard_id is None:
        return _run_shard_supervisor(args)
    try:
        asyncio.run(_amain(args))
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
