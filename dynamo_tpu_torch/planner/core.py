"""SLA planner core loop (the counterpart of dynamo_tpu/planner/core.py).

The port reads the frontend's exposition with its own stdlib parser
(``parse_prometheus_text``) and fetches it with an asyncio GET
(runtime/http_client.py ``http_get``): prometheus_client and aiohttp are
not dependencies of the port. Everything else is the reference's
arithmetic.

Behavioral parity with the upstream planner
(components/src/dynamo/planner/utils/planner_core.py:61-472):

  observe_metrics (:241)  -> scrape the frontend's Prometheus exposition
                             and form interval averages (TTFT, ITL, req
                             rate, ISL, OSL, request duration)
  correction factors      -> observed TTFT / interpolated TTFT (queueing
                             shows up here), observed ITL / interpolated
                             ITL at current concurrency
  predict_load (:294)     -> per-signal one-step forecasts (predictor.py)
  _compute_replica_requirements (:313)
                          -> prefill: predicted prefill tokens/s divided
                             by profiled per-chip prefill throughput,
                             dampened by min(1, p_correction);
                             decode: invert the profiled (ITL, context) ->
                             throughput surface at the corrected ITL SLA
                          -> clamp to min endpoints, scale into the chip
                             budget
  make_adjustments (:409) -> connector.set_replicas

Differences by design: metrics come straight from the frontend ``/metrics``
endpoint (no external Prometheus server), and the interpolators run on
regular grids emitted by our own profiler. ``dryrun`` replays a recorded
trace of (num_req, isl, osl) without any cluster, mirroring
``planner_sla_dryrun`` testing.
"""

from __future__ import annotations

import asyncio
import logging
import math
import re
from dataclasses import dataclass
from typing import Any, Awaitable, Callable

from dynamo_tpu_torch.planner.connector import DesiredReplicas, LoggingConnector
from dynamo_tpu_torch.planner.interpolation import (
    DecodeInterpolator,
    PrefillInterpolator,
)
from dynamo_tpu_torch.planner.predictor import make_predictor
from dynamo_tpu_torch.runtime.http_client import http_get

log = logging.getLogger("dynamo.planner")


@dataclass
class Metrics:
    """Interval averages observed from the serving frontend."""

    ttft: float | None = None  # seconds
    itl: float | None = None  # seconds
    num_req: float | None = None  # requests in the interval
    isl: float | None = None  # avg input tokens
    osl: float | None = None  # avg output tokens
    request_duration: float | None = None  # seconds

    def is_valid(self) -> bool:
        need = (self.ttft, self.itl, self.isl, self.osl)
        return all(v is not None and not math.isnan(v) for v in need)


@dataclass
class PlannerConfig:
    namespace: str = "dynamo"
    model: str | None = None  # None = aggregate over all models
    ttft_sla_s: float = 0.5
    itl_sla_s: float = 0.05
    adjustment_interval_s: float = 60.0
    predictor: str = "ar"
    prediction_window: int = 128
    min_endpoint: int = 1
    max_chip_budget: int = 64
    prefill_engine_num_chips: int = 1
    decode_engine_num_chips: int = 1
    no_correction: bool = False
    decode_component: str = "backend"
    prefill_component: str = "prefill"


# ---------------------------------------------------------------- scraping


_METRIC_NAME = re.compile(r"[a-zA-Z_:][a-zA-Z0-9_:]*")
_LABEL_NAME = re.compile(r"[a-zA-Z_][a-zA-Z0-9_]*")
_ESCAPES = {"\\\\": "\\", "\\n": "\n", '\\"': '"'}
_ESCAPE = re.compile(r'\\[\\n"]')
# the sample names a typed family owns (any other name is a family of its own)
_FAMILY_SUFFIXES = {"counter": ("",), "gauge": ("",), "summary": ("_count", "_sum", ""),
                    "histogram": ("_count", "_sum", "_bucket")}


def _unescape(text: str) -> str:
    return _ESCAPE.sub(lambda m: _ESCAPES[m.group(0)], text)


def _quoted_end(text: str, start: int) -> int:
    """Index of the quote closing the string opened at ``text[start]``."""
    i = start + 1
    while i < len(text):
        if text[i] == "\\":
            i += 2
            continue
        if text[i] == '"':
            return i
        i += 1
    raise ValueError(f"unterminated quote: {text!r}")


def _parse_labels(body: str) -> dict[str, str]:
    """``k="v",...`` (the text between the braces; a trailing comma and
    blanks allowed, a label name may be quoted)."""
    labels: dict[str, str] = {}
    i, n = 0, len(body)
    while True:
        while i < n and body[i] in " \t":
            i += 1
        if i == n:
            return labels
        if body[i] == '"':
            j = _quoted_end(body, i)
            name, i = _unescape(body[i + 1:j]), j + 1
        else:
            m = _LABEL_NAME.match(body, i)
            if m is None:
                raise ValueError(f"invalid labels: {body!r}")
            name, i = m.group(0), m.end()
        while i < n and body[i] in " \t":
            i += 1
        if i >= n or body[i] != "=":
            raise ValueError(f"invalid labels: {body!r}")
        i += 1
        while i < n and body[i] in " \t":
            i += 1
        if i >= n or body[i] != '"':
            raise ValueError(f"invalid labels: {body!r}")
        j = _quoted_end(body, i)
        if name.startswith("__") or name in labels:
            raise ValueError(f"invalid label name {name!r}: {body!r}")
        labels[name] = _unescape(body[i + 1:j])
        i = j + 1
        while i < n and body[i] in " \t":
            i += 1
        if i < n:
            if body[i] != ",":
                raise ValueError(f"invalid labels: {body!r}")
            i += 1


def _parse_value(text: str) -> float:
    """A sample value as prometheus_client reads it: an int where the text
    is one, else a float (``NaN``, ``+Inf``, ``-Inf`` included); the
    timestamp after it is dropped."""
    fields = text.split(" " if " " in text else "\t")
    value = next((f.strip() for f in fields if f.strip()), None)
    if value is None or "_" in value:
        raise ValueError(f"invalid value: {text!r}")
    try:
        return int(value)
    except ValueError:
        return float(value)


def _parse_sample(line: str) -> tuple[str, dict[str, str], float]:
    m = _METRIC_NAME.match(line)
    if m is None:
        raise ValueError(f"invalid metric name: {line!r}")
    name, i = m.group(0), m.end()
    while i < len(line) and line[i] in " \t":
        i += 1
    labels: dict[str, str] = {}
    if i < len(line) and line[i] == "{":
        j, k = i + 1, i + 1
        while True:  # the closing brace outside every quoted value
            if k >= len(line):
                raise ValueError(f"unterminated labels: {line!r}")
            if line[k] == '"':
                k = _quoted_end(line, k)
            elif line[k] == "}":
                break
            k += 1
        labels, i = _parse_labels(line[j:k]), k + 1
    return name, labels, _parse_value(line[i:].lstrip())


def parse_prometheus_text(text: str) -> dict[tuple[str, tuple], float]:
    """Prometheus exposition text (format 0.0.4) -> {(sample name, sorted
    label items): value}, the dict that prometheus_client's
    ``text_string_to_metric_families`` gives the reference: ``# HELP`` /
    ``# TYPE`` lines open a family, other comments and blank lines are
    skipped, label values unescaped (backslash, quote, newline), NaN and
    +-Inf read, timestamps dropped, and a counter family declared without
    ``_total`` names its samples with it, as that parser does. The library
    is not a dependency of the port."""
    out: dict[tuple[str, tuple], float] = {}
    family, counter_total, owned = "", False, ()
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) < 2 or parts[1] not in ("HELP", "TYPE"):
                continue
            name = parts[2] if len(parts) > 2 else ""
            if parts[1] == "HELP":
                if name != family:
                    family, counter_total, owned = name, False, (name,)
                continue
            if len(parts) < 4:
                raise ValueError(f"invalid TYPE line: {line!r}")
            family = name
            counter_total = parts[3] == "counter" and not name.endswith("_total")
            owned = tuple(name + s for s in _FAMILY_SUFFIXES.get(parts[3], ("",)))
            continue
        name, labels, value = _parse_sample(line)
        if name not in owned:  # a family of its own, untyped
            family, counter_total, owned = "", False, ()
        elif counter_total:
            name += "_total"
        out[(name, tuple(sorted(labels.items())))] = value
    return out


class FrontendMetricsSource:
    """Interval averages from successive scrapes of a frontend /metrics URL.

    Counters/histogram sums are cumulative; the interval view is the delta
    between consecutive scrapes (the same windowing the reference gets
    from PromQL range queries)."""

    SUMS = {
        "ttft": "dynamo_time_to_first_token_seconds",
        "itl": "dynamo_inter_token_latency_seconds",
        "duration": "dynamo_request_duration_seconds",
    }

    def __init__(self, url: str, model: str | None = None):
        self.url = url
        self.model = model
        self._prev: dict[tuple[str, tuple], float] | None = None

    async def fetch_text(self) -> str:
        return await http_get(self.url)

    def _sum(self, snap: dict, name: str) -> float:
        total = 0.0
        for (metric, labels), v in snap.items():
            if metric != name:
                continue
            if self.model is not None and ("model", self.model) not in labels:
                continue
            total += v
        return total

    def _delta(self, snap: dict, name: str) -> float:
        prev = self._sum(self._prev, name) if self._prev else 0.0
        return self._sum(snap, name) - prev

    async def observe(self) -> Metrics:
        snap = parse_prometheus_text(await self.fetch_text())
        m = Metrics()
        if self._prev is not None:
            def ratio(num, den):
                return num / den if den > 0 else float("nan")

            n_completed = self._delta(snap, "dynamo_requests_completed_total")
            m.num_req = n_completed
            m.isl = ratio(
                self._delta(snap, "dynamo_input_tokens_total"), n_completed
            )
            m.osl = ratio(
                self._delta(snap, "dynamo_output_tokens_total"), n_completed
            )
            for attr, base in self.SUMS.items():
                s = self._delta(snap, base + "_sum")
                c = self._delta(snap, base + "_count")
                val = ratio(s, c)
                if attr == "duration":
                    m.request_duration = val
                else:
                    setattr(m, attr, val)
        self._prev = snap
        return m


# ------------------------------------------------------------------ planner


class SlaPlanner:
    def __init__(
        self,
        config: PlannerConfig,
        prefill_interpolator: PrefillInterpolator,
        decode_interpolator: DecodeInterpolator,
        *,
        connector=None,
        metrics_source=None,
        worker_counts: Callable[[], Awaitable[tuple[int, int]]] | None = None,
    ):
        self.cfg = config
        self.prefill = prefill_interpolator
        self.decode = decode_interpolator
        self.connector = connector or LoggingConnector()
        self.metrics_source = metrics_source
        self.worker_counts = worker_counts
        self.p_correction = 1.0
        self.d_correction = 1.0
        self.last_metrics = Metrics()
        w = config.prediction_window
        self.pred_num_req = make_predictor(config.predictor, w)
        self.pred_isl = make_predictor(config.predictor, w)
        self.pred_osl = make_predictor(config.predictor, w)
        self.decisions: list[DesiredReplicas] = []
        self._task: asyncio.Task | None = None

    # -- observation -------------------------------------------------------

    def ingest(self, m: Metrics) -> None:
        """Feed one interval of observed metrics (live scrape or dryrun)."""
        self.last_metrics = m
        self.pred_num_req.observe(m.num_req if m.num_req is not None else 0.0)
        self.pred_isl.observe(m.isl if m.isl is not None else 0.0)
        self.pred_osl.observe(m.osl if m.osl is not None else 0.0)

    async def observe_metrics(self) -> None:
        if self.metrics_source is None:
            raise RuntimeError("no metrics source configured")
        self.ingest(await self.metrics_source.observe())

    # -- correction --------------------------------------------------------

    def update_corrections(self, num_decode_workers: int) -> None:
        """observed/expected ratios (ref planner_core.py make_adjustments):
        p >> 1 means TTFT blows past the profile (queueing) -> scale
        prefill pessimistically; d near 1 means the decode profile holds."""
        m = self.last_metrics
        if not m.is_valid() or self.cfg.no_correction:
            return
        expect_ttft = self.prefill.interpolate_ttft(m.isl)
        if expect_ttft > 0:
            self.p_correction = m.ttft / expect_ttft
        duration = m.request_duration or self.cfg.adjustment_interval_s
        concurrency = (
            (m.num_req or 0.0)
            / max(1, num_decode_workers)
            * duration
            / self.cfg.adjustment_interval_s
        )
        expect_itl = self.decode.interpolate_itl(
            concurrency=concurrency, context_length=m.isl + m.osl / 2
        )
        if expect_itl > 0:
            self.d_correction = m.itl / expect_itl
        log.info(
            "correction factors: ttft %.3f itl %.3f",
            self.p_correction, self.d_correction,
        )

    # -- decision ----------------------------------------------------------

    def predict_load(self) -> tuple[float, float, float]:
        return (
            self.pred_num_req.predict(),
            self.pred_isl.predict(),
            self.pred_osl.predict(),
        )

    def compute_replicas(
        self, num_req: float, isl: float, osl: float
    ) -> tuple[int, int]:
        cfg = self.cfg
        interval = cfg.adjustment_interval_s

        # prefill: predicted prompt tokens/s over profiled per-chip
        # throughput; TTFT overshoot (p_correction > 1 from queueing) only
        # ever shrinks the denominator via min(1, .) on the demand side
        pred_prefill_thpt = (
            num_req * isl / interval * min(1.0, self.p_correction)
        )
        per_replica_prefill = (
            self.prefill.interpolate_thpt_per_chip(isl)
            * cfg.prefill_engine_num_chips
        )
        n_p = math.ceil(pred_prefill_thpt / max(per_replica_prefill, 1e-9))

        # decode: tighten the ITL target by the observed correction, then
        # invert the profiled surface for the best sustainable thpt/chip
        corrected_itl = (
            cfg.itl_sla_s / self.d_correction
            if self.d_correction > 0
            else cfg.itl_sla_s
        )
        thpt_per_chip, _, _ = self.decode.find_best_throughput_per_chip(
            itl=corrected_itl, context_length=isl + osl / 2
        )
        pred_decode_thpt = num_req * osl / interval
        n_d = math.ceil(
            pred_decode_thpt
            / max(thpt_per_chip * cfg.decode_engine_num_chips, 1e-9)
        )

        n_p = max(n_p, cfg.min_endpoint)
        n_d = max(n_d, cfg.min_endpoint)

        total = (
            n_p * cfg.prefill_engine_num_chips
            + n_d * cfg.decode_engine_num_chips
        )
        if total > cfg.max_chip_budget:
            scale = cfg.max_chip_budget / total
            n_p = max(cfg.min_endpoint, round(n_p * scale))
            n_d = max(
                cfg.min_endpoint,
                round(
                    (cfg.max_chip_budget - n_p * cfg.prefill_engine_num_chips)
                    / cfg.decode_engine_num_chips
                ),
            )
            log.warning(
                "chip budget %d exceeded (%d needed); scaled to p=%d d=%d",
                cfg.max_chip_budget, total, n_p, n_d,
            )
        return n_p, n_d

    async def make_adjustments(self) -> DesiredReplicas | None:
        if not self.last_metrics.is_valid():
            log.info("metrics invalid/idle; skipping adjustment")
            return None
        if self.worker_counts is not None:
            _, n_decode = await self.worker_counts()
            self.update_corrections(max(1, n_decode))
        num_req, isl, osl = self.predict_load()
        if isl <= 0 or osl <= 0:
            return None
        n_p, n_d = self.compute_replicas(num_req, isl, osl)
        desired = DesiredReplicas(prefill=n_p, decode=n_d, model=self.cfg.model)
        self.decisions.append(desired)
        await self.connector.set_replicas(desired)
        return desired

    # -- loops -------------------------------------------------------------

    async def run(self) -> None:
        """Live loop: scrape -> adjust, every adjustment interval."""
        while True:
            await asyncio.sleep(self.cfg.adjustment_interval_s)
            try:
                await self.observe_metrics()
                await self.make_adjustments()
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001
                log.exception("planner iteration failed")

    def start(self) -> "SlaPlanner":
        self._task = asyncio.get_running_loop().create_task(self.run())
        return self

    async def close(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def dryrun(self, trace: list[dict[str, Any]]) -> list[tuple[int, int]]:
        """Replay recorded intervals without a cluster (ref
        planner_sla_dryrun): each record needs num_req/isl/osl (ttft/itl
        optional — corrections need them; otherwise no_correction
        behavior). Returns the (prefill, decode) decision per interval."""
        out: list[tuple[int, int]] = []
        for rec in trace:
            m = Metrics(
                ttft=rec.get("ttft", self.cfg.ttft_sla_s / 2),
                itl=rec.get("itl", self.cfg.itl_sla_s / 2),
                num_req=rec["num_req"],
                isl=rec["isl"],
                osl=rec["osl"],
                request_duration=rec.get("request_duration"),
            )
            self.ingest(m)
            desired = await self.make_adjustments()
            if desired is not None:
                out.append((desired.prefill, desired.decode))
            else:
                out.append((0, 0))
        return out
