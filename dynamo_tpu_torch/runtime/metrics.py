"""Hierarchical metrics registry (the counterpart of
dynamo_tpu/runtime/metrics.py).

The reference is a thin layer over prometheus_client, which the GPU machine
lacks. This module carries its own Counter, Gauge and Histogram, with
labels, and writes the Prometheus text format 0.0.4 as prometheus_client
does: the same metric names, ``# HELP`` / ``# TYPE`` lines and
``_total`` / ``_bucket{le=...}`` / ``_count`` / ``_sum`` samples, label
names sorted, label values and help text escaped, floats in Go's format.
The per-child ``_created`` samples are left out.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, Iterable

PREFIX = "dynamo_"

# Process-global exposition providers: named callables returning Prometheus
# text appended to EVERY MetricsRegistry exposition (e.g. the migration
# operator's recovery counters).
_GLOBAL_PROVIDERS: dict[str, Callable[[], str]] = {}


def register_global_provider(name: str, fn: Callable[[], str]) -> None:
    _GLOBAL_PROVIDERS[name] = fn


def register_registry(name: str, registry: "MetricsRegistry") -> None:
    """Expose a module-level MetricsRegistry on every /metrics surface. Renders
    the registry's own metrics only (its exposition() would recurse into the
    global providers)."""
    register_global_provider(name, registry.render)


# Buckets tuned for LLM serving latencies (seconds).
LATENCY_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _go_float(d: float) -> str:
    """A float as Go prints it (prometheus_client's floatToGoString)."""
    d = float(d)
    if d == math.inf:
        return "+Inf"
    if d == -math.inf:
        return "-Inf"
    if math.isnan(d):
        return "NaN"
    s = repr(d)
    dot = s.find(".")
    # Go switches to exponents sooner than Python
    if d > 0 and dot > 6:
        mantissa = f"{s[0]}.{s[1:dot]}{s[dot + 1:]}".rstrip("0.")
        return f"{mantissa}e+0{dot - 1}"
    return s


def _escape_help(text: str) -> str:
    return text.replace("\\", r"\\").replace("\n", r"\n")


def _escape_label(value: str) -> str:
    return value.replace("\\", r"\\").replace("\n", r"\n").replace('"', r"\"")


def _labels_text(labels: dict[str, str]) -> str:
    if not labels:
        return ""
    return "{" + ",".join(
        f'{k}="{_escape_label(v)}"' for k, v in sorted(labels.items())) + "}"


class _Child:
    """One labelled series' value (counter or gauge)."""

    def __init__(self, lock: threading.Lock, counter: bool):
        self._lock = lock
        self._counter = counter
        self.value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if self._counter and amount < 0:
            raise ValueError("counters can only be incremented by non-negative amounts")
        with self._lock:
            self.value += amount

    def dec(self, amount: float = 1.0) -> None:
        if self._counter:
            raise AttributeError("a counter cannot decrease")
        with self._lock:
            self.value -= amount

    def set(self, value: float) -> None:
        if self._counter:
            raise AttributeError("a counter cannot be set")
        with self._lock:
            self.value = float(value)


class _HistogramChild:
    def __init__(self, lock: threading.Lock, buckets: tuple[float, ...]):
        self._lock = lock
        self._upper = buckets
        self.counts = [0.0] * len(buckets)  # per bucket, not cumulative
        self.sum = 0.0

    def observe(self, amount: float) -> None:
        with self._lock:
            self.sum += amount
            for i, bound in enumerate(self._upper):
                if amount <= bound:
                    self.counts[i] += 1
                    break


class _Metric:
    """A metric family: children by label values. With no label names the
    family is its own single child (``.inc()`` etc. on the family)."""

    kind = ""

    def __init__(self, name: str, doc: str, labelnames: Iterable[str]):
        self.name = name
        self.doc = doc
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._children: dict[tuple[str, ...], object] = {}
        if not self.labelnames:
            self._children[()] = self._new_child()

    def _new_child(self):
        raise NotImplementedError

    def labels(self, *values, **kw):
        if kw:
            if values:
                raise ValueError("labels: pass values by position or by name, not both")
            values = tuple(kw[n] for n in self.labelnames)
        if len(values) != len(self.labelnames) or not self.labelnames:
            raise ValueError(f"{self.name}: expected labels {self.labelnames}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _only(self):
        if self.labelnames:
            raise ValueError(f"{self.name} has labels {self.labelnames}: use .labels()")
        return self._children[()]

    def _series(self):
        with self._lock:
            items = list(self._children.items())
        for key, child in items:
            yield dict(zip(self.labelnames, key)), child


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, doc: str, labelnames: Iterable[str] = ()):
        # prometheus_client's convention: the family drops a "_total"
        # suffix and the sample carries it
        base = name[:-len("_total")] if name.endswith("_total") else name
        super().__init__(base, doc, labelnames)

    def _new_child(self):
        return _Child(self._lock, counter=True)

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def render(self) -> list[str]:
        total = self.name + "_total"
        out = [f"# HELP {total} {_escape_help(self.doc)}", f"# TYPE {total} counter"]
        out += [f"{total}{_labels_text(lab)} {_go_float(c.value)}"
                for lab, c in self._series()]
        return out


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _Child(self._lock, counter=False)

    def inc(self, amount: float = 1.0) -> None:
        self._only().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._only().dec(amount)

    def set(self, value: float) -> None:
        self._only().set(value)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.doc)}", f"# TYPE {self.name} gauge"]
        out += [f"{self.name}{_labels_text(lab)} {_go_float(c.value)}"
                for lab, c in self._series()]
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name: str, doc: str, labelnames: Iterable[str] = (),
                 buckets: tuple = LATENCY_BUCKETS):
        upper = [float(b) for b in buckets]
        if upper != sorted(upper):
            raise ValueError("histogram buckets must be sorted")
        if not upper or upper[-1] != math.inf:
            upper.append(math.inf)
        self.buckets = tuple(upper)
        super().__init__(name, doc, labelnames)

    def _new_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, amount: float) -> None:
        self._only().observe(amount)

    def render(self) -> list[str]:
        out = [f"# HELP {self.name} {_escape_help(self.doc)}",
               f"# TYPE {self.name} histogram"]
        for lab, c in self._series():
            with self._lock:
                counts, total = list(c.counts), c.sum
            acc = 0.0
            for bound, n in zip(self.buckets, counts):
                acc += n
                out.append(f"{self.name}_bucket"
                           f"{_labels_text({**lab, 'le': _go_float(bound)})} "
                           f"{_go_float(acc)}")
            out.append(f"{self.name}_count{_labels_text(lab)} {_go_float(acc)}")
            out.append(f"{self.name}_sum{_labels_text(lab)} {_go_float(total)}")
        return out


class MetricsRegistry:
    def __init__(self) -> None:
        self._metrics: dict[str, _Metric] = {}

    def _full(self, name: str) -> str:
        return name if name.startswith(PREFIX) else PREFIX + name

    def counter(self, name: str, doc: str, labelnames: Iterable[str] = ()) -> Counter:
        key = "c:" + name
        if key not in self._metrics:
            self._metrics[key] = Counter(self._full(name), doc, labelnames)
        return self._metrics[key]  # type: ignore[return-value]

    def gauge(self, name: str, doc: str, labelnames: Iterable[str] = ()) -> Gauge:
        key = "g:" + name
        if key not in self._metrics:
            self._metrics[key] = Gauge(self._full(name), doc, labelnames)
        return self._metrics[key]  # type: ignore[return-value]

    def histogram(
        self,
        name: str,
        doc: str,
        labelnames: Iterable[str] = (),
        buckets: tuple = LATENCY_BUCKETS,
    ) -> Histogram:
        key = "h:" + name
        if key not in self._metrics:
            self._metrics[key] = Histogram(self._full(name), doc, labelnames, buckets)
        return self._metrics[key]  # type: ignore[return-value]

    def render(self) -> str:
        """This registry's metrics as Prometheus text (no global providers)."""
        lines = [line for m in self._metrics.values() for line in m.render()]
        return "".join(line + "\n" for line in lines)

    def exposition(self) -> bytes:
        out = self.render().encode()
        for fn in _GLOBAL_PROVIDERS.values():
            try:
                extra = fn()
            # /metrics must never 500 because one provider is broken; the
            # other providers still render
            except Exception:  # noqa: BLE001
                continue
            if extra:
                out += extra.encode()
        return out
