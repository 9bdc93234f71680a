"""Process-wide metrics registry: counters, gauges, histograms.

Port of ``horovod_tpu/utils/metrics.py`` (stdlib only, as there): a
thread-safe registry of Counter / Gauge / bounded-bucket Histogram
families with a Prometheus text exporter and a JSON snapshot, fed by the
port's layers under the reference's family, label and bucket names
(docs/metrics.md):

- eager collectives (``ops/eager.py``): per-op counts, latency and bytes;
- the native core's counters (``core/session.py`` bridges
  ``CoreSession.counters()`` through a collector, as deltas);
- elastic events (``elastic/state.py``, ``elastic/worker.py``);
- the data loader (``data/data_loader.py``);
- health: ``hvd_seconds_since_last_collective`` and
  ``hvd_stalled_tensors``, so a wedged negotiation shows in a scrape.

Exposition: ``GET /metrics`` (``/metrics.json``) on a
``runner.http_server.KVStoreServer``, or ``hvd.metrics_snapshot()`` /
``hvd.start_metrics_server(port)`` (``common/basics.py``).

Names follow ``hvd_[a-z_]+``, enforced at registration. The registry
survives ``hvd.shutdown()``: elastic resets tear the core down and bring
it back, and ``hvd_elastic_resets_total`` counts across them.
"""

from __future__ import annotations

import bisect
import json
import math
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_NAME_RE = re.compile(r"hvd_[a-z_]+")

# Eager collectives ride a TCP control plane with ~ms cycle time; the
# ladder spans sub-ms local completions to multi-second stalls.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0)
# Powers of four from 256 B to the 128 MB reference fusion threshold.
DEFAULT_BYTES_BUCKETS = (
    256.0, 1024.0, 4096.0, 16384.0, 65536.0, 262144.0, 1048576.0,
    4194304.0, 16777216.0, 67108864.0, 134217728.0, 536870912.0)


def _escape_label(value: str) -> str:
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_value(v) -> str:
    # Non-finite values are legal metric states (a diverged loss gauge
    # is exactly when the operator needs the scrape to keep working):
    # Prometheus text format spells them NaN / +Inf / -Inf.
    f = float(v)
    if not math.isfinite(f):
        return "NaN" if math.isnan(f) else ("+Inf" if f > 0 else "-Inf")
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _fmt_bound(b: float) -> str:
    # Lossless: %g's 6 significant digits would both misreport large
    # bounds (1048576 -> "1.04858e+06") and merge distinct buckets
    # that agree to 6 sig figs (the cumulative dict is keyed by this
    # string). Integral bounds print exact; repr round-trips the rest.
    if b == float("inf"):
        return "+Inf"
    if b == int(b) and abs(b) < 1e15:
        return str(int(b))
    return repr(float(b))


def _render_labels(names: Sequence[str], values: Sequence[str],
                   extra: Optional[Tuple[str, str]] = None) -> str:
    pairs = ['%s="%s"' % (n, _escape_label(v))
             for n, v in zip(names, values)]
    if extra is not None:
        pairs.append('%s="%s"' % (extra[0], _escape_label(extra[1])))
    if not pairs:
        return ""
    return "{%s}" % ",".join(pairs)


class _CounterValue:
    """Monotonically increasing value (one labelset of a Counter)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def inc(self, amount: float = 1.0):
        if amount < 0:
            raise ValueError("counters can only increase (got %r)" % amount)
        with self._lock:
            self._value += amount

    def get(self) -> float:
        with self._lock:
            return self._value


class _GaugeValue:
    """Arbitrary settable value (one labelset of a Gauge)."""

    __slots__ = ("_lock", "_value")

    def __init__(self, lock):
        self._lock = lock
        self._value = 0.0

    def set(self, value: float):
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0):
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0):
        self.inc(-amount)

    def get(self) -> float:
        with self._lock:
            return self._value


def quantile_from_buckets(bounds: Sequence[float],
                          counts: Sequence[int],
                          q: float) -> Optional[float]:
    """Derive the ``q``-quantile (0 < q <= 1) from per-bucket counts
    (``counts[i]`` observations in ``(bounds[i-1], bounds[i]]``, with
    ``counts[-1]`` the +Inf overflow slot), Prometheus
    ``histogram_quantile`` semantics:

    - linear interpolation inside the bucket the quantile lands in
      (the first finite bucket interpolates from 0 — our ladders are
      positive-valued latencies/bytes/sizes);
    - a quantile landing in the +Inf slot reports the highest finite
      bound (the honest answer "at least this much");
    - ``None`` when the histogram is empty — there is no p99 of
      nothing, and exporting 0 would fake a perfect SLO.
    """
    total = sum(counts)
    if total == 0:
        return None
    rank = q * total
    cum = 0
    lower = 0.0
    for bound, n in zip(bounds, counts):
        prev = cum
        cum += n
        if cum >= rank:
            if n == 0:
                return bound
            return lower + (bound - lower) * (rank - prev) / n
        lower = bound
    return float(bounds[-1])  # +Inf slot


class _HistogramValue:
    """Bounded-bucket distribution (one labelset of a Histogram)."""

    __slots__ = ("_lock", "_bounds", "_counts", "_sum")

    def __init__(self, lock, bounds):
        self._lock = lock
        self._bounds = bounds
        # One slot per finite bound plus the +Inf overflow slot.
        self._counts = [0] * (len(bounds) + 1)
        self._sum = 0.0

    def observe(self, value: float):
        value = float(value)
        # Upper-inclusive bounds, Prometheus semantics: v <= bound.
        i = bisect.bisect_left(self._bounds, value)
        with self._lock:
            self._counts[i] += 1
            self._sum += value

    def get(self) -> Dict[str, object]:
        """Cumulative bucket counts keyed by formatted upper bound,
        plus derived p50/p99 (docs/metrics.md#histogram-quantiles) so
        the JSON exporter is SLO-readable without a Prometheus server
        doing the ``histogram_quantile`` math."""
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
        cumulative: Dict[str, int] = {}
        running = 0
        for bound, n in zip(self._bounds, counts):
            running += n
            cumulative[_fmt_bound(bound)] = running
        running += counts[-1]
        cumulative["+Inf"] = running
        return {"count": running, "sum": total_sum, "buckets": cumulative,
                "p50": quantile_from_buckets(self._bounds, counts, 0.50),
                "p99": quantile_from_buckets(self._bounds, counts, 0.99)}


class Metric:
    """A metric family: one name/type/help plus per-labelset children."""

    kind = "untyped"
    _value_cls = _CounterValue

    def __init__(self, name: str, documentation: str,
                 labelnames: Sequence[str] = (), *, _lock=None):
        self.name = name
        self.documentation = documentation
        self.labelnames = tuple(labelnames)
        self._lock = _lock if _lock is not None else threading.RLock()
        self._children: Dict[Tuple[str, ...], object] = {}

    def _new_value(self):
        return self._value_cls(self._lock)

    def labels(self, *values, **labelkw):
        if labelkw:
            if values:
                raise ValueError("pass labels positionally or by name, "
                                 "not both")
            try:
                values = tuple(str(labelkw[n]) for n in self.labelnames)
            except KeyError as e:
                raise ValueError("missing label %s for %s"
                                 % (e, self.name)) from e
        else:
            values = tuple(str(v) for v in values)
        if len(values) != len(self.labelnames):
            raise ValueError(
                "%s takes labels %r, got %r"
                % (self.name, self.labelnames, values))
        with self._lock:
            child = self._children.get(values)
            if child is None:
                child = self._new_value()
                self._children[values] = child
        return child

    def _items(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    # Unlabeled convenience: Counter().inc(), Gauge().set(), ...
    # delegate to the single ()-labeled child.

    def snapshot_values(self) -> List[Dict[str, object]]:
        out = []
        for labelvalues, child in self._items():
            entry: Dict[str, object] = {
                "labels": dict(zip(self.labelnames, labelvalues))}
            got = child.get()
            if isinstance(got, dict):
                entry.update(got)
            else:
                entry["value"] = got
            out.append(entry)
        return out

    def render(self) -> List[str]:
        lines = [
            "# HELP %s %s" % (self.name,
                              self.documentation.replace("\n", " ")),
            "# TYPE %s %s" % (self.name, self.kind),
        ]
        for labelvalues, child in self._items():
            lines.append("%s%s %s" % (
                self.name,
                _render_labels(self.labelnames, labelvalues),
                _fmt_value(child.get())))
        return lines


class Counter(Metric):
    kind = "counter"
    _value_cls = _CounterValue

    def inc(self, amount: float = 1.0):
        self.labels().inc(amount)

    def get(self) -> float:
        return self.labels().get()


class Gauge(Metric):
    kind = "gauge"
    _value_cls = _GaugeValue

    def set(self, value: float):
        self.labels().set(value)

    def inc(self, amount: float = 1.0):
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0):
        self.labels().dec(amount)

    def get(self) -> float:
        return self.labels().get()


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name, documentation, labelnames=(), *,
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                 _lock=None):
        super().__init__(name, documentation, labelnames, _lock=_lock)
        bounds = tuple(float(b) for b in buckets if b != float("inf"))
        if not bounds:
            raise ValueError("histogram needs at least one finite bucket")
        if list(bounds) != sorted(set(bounds)):
            raise ValueError(
                "histogram buckets must be strictly increasing: %r"
                % (buckets,))
        self.buckets = bounds

    def _new_value(self):
        return _HistogramValue(self._lock, self.buckets)

    def observe(self, value: float):
        self.labels().observe(value)

    def get(self) -> Dict[str, object]:
        return self.labels().get()

    def render(self) -> List[str]:
        lines = [
            "# HELP %s %s" % (self.name,
                              self.documentation.replace("\n", " ")),
            "# TYPE %s histogram" % self.name,
        ]
        for labelvalues, child in self._items():
            state = child.get()
            for bound, cum in state["buckets"].items():
                lines.append("%s_bucket%s %s" % (
                    self.name,
                    _render_labels(self.labelnames, labelvalues,
                                   extra=("le", bound)),
                    _fmt_value(cum)))
            label_str = _render_labels(self.labelnames, labelvalues)
            lines.append("%s_sum%s %s" % (self.name, label_str,
                                          _fmt_value(state["sum"])))
            lines.append("%s_count%s %s" % (self.name, label_str,
                                            _fmt_value(state["count"])))
        return lines


class MetricsRegistry:
    """Thread-safe name -> metric-family table with pluggable collectors.

    Collectors are zero-argument callables run before every export;
    they pull external state into the registry (e.g. the native core's
    counters). Keyed by name so a re-registration (elastic reset
    creating a new CoreSession) replaces rather than accumulates.
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._metrics: Dict[str, Metric] = {}
        self._collectors: Dict[str, Callable[[], None]] = {}

    # --- registration ------------------------------------------------------

    def _register(self, cls, name, documentation, labelnames, **kwargs):
        if not _NAME_RE.fullmatch(name):
            raise ValueError(
                "metric name %r does not match the hvd_[a-z_]+ "
                "convention (see docs/metrics.md)" % name)
        with self._lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if (type(existing) is not cls
                        or existing.labelnames != tuple(labelnames)):
                    raise ValueError(
                        "metric %r already registered as %s%r"
                        % (name, type(existing).__name__,
                           existing.labelnames))
                buckets = kwargs.get("buckets")
                if buckets is not None and tuple(
                        float(b) for b in buckets
                        if b != float("inf")) != existing.buckets:
                    # Silent reuse would land the second caller's
                    # observations in the first caller's ladder.
                    raise ValueError(
                        "histogram %r already registered with buckets "
                        "%r" % (name, existing.buckets))
                return existing
            metric = cls(name, documentation, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, documentation: str,
                labelnames: Sequence[str] = ()) -> Counter:
        return self._register(Counter, name, documentation, labelnames)

    def gauge(self, name: str, documentation: str,
              labelnames: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge, name, documentation, labelnames)

    def histogram(self, name: str, documentation: str,
                  labelnames: Sequence[str] = (), *,
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS,
                  ) -> Histogram:
        return self._register(Histogram, name, documentation, labelnames,
                              buckets=buckets)

    def unregister(self, name: str):
        with self._lock:
            self._metrics.pop(name, None)

    def get(self, name: str) -> Optional[Metric]:
        with self._lock:
            return self._metrics.get(name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._metrics)

    # --- collectors --------------------------------------------------------

    def register_collector(self, name: str, fn: Callable[[], None]):
        with self._lock:
            self._collectors[name] = fn

    def unregister_collector(self, name: str):
        with self._lock:
            self._collectors.pop(name, None)

    def run_collectors(self):
        with self._lock:
            collectors = list(self._collectors.values())
        for fn in collectors:
            try:
                fn()
            except Exception:  # noqa: BLE001
                # A broken bridge must never take the scrape down.
                pass

    # --- export ------------------------------------------------------------

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """JSON-able view of every family (collectors run first)."""
        self.run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        return {
            m.name: {
                "type": m.kind,
                "help": m.documentation,
                "values": m.snapshot_values(),
            }
            for m in metrics
        }

    def value(self, name: str, **labels) -> Optional[object]:
        """Scalar value of a counter/gauge child (histograms return the
        cumulative-bucket dict); None when the family or labelset does
        not exist yet. Collectors run first, so core-bridged counters
        are fresh."""
        self.run_collectors()
        metric = self.get(name)
        if metric is None:
            return None
        key = tuple(str(labels[n]) for n in metric.labelnames
                    if n in labels)
        if len(key) != len(metric.labelnames):
            return None
        with metric._lock:
            child = metric._children.get(key)
        return None if child is None else child.get()

    def render_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        self.run_collectors()
        with self._lock:
            metrics = sorted(self._metrics.values(), key=lambda m: m.name)
        lines: List[str] = []
        for m in metrics:
            lines.extend(m.render())
        return "\n".join(lines) + "\n"


# --- process-wide default registry ------------------------------------------

REGISTRY = MetricsRegistry()

PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def counter(name, documentation, labelnames=()):
    return REGISTRY.counter(name, documentation, labelnames)


def gauge(name, documentation, labelnames=()):
    return REGISTRY.gauge(name, documentation, labelnames)


def histogram(name, documentation, labelnames=(), *,
              buckets=DEFAULT_LATENCY_BUCKETS):
    return REGISTRY.histogram(name, documentation, labelnames,
                              buckets=buckets)


def register_collector(name, fn):
    REGISTRY.register_collector(name, fn)


def unregister_collector(name):
    REGISTRY.unregister_collector(name)


def snapshot():
    return REGISTRY.snapshot()


def _json_sanitize(obj):
    """Replace non-finite floats (legal gauge states, illegal JSON
    tokens under the spec) with their string spellings so the
    serialized snapshot parses in every consumer, not just Python."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return "NaN" if math.isnan(obj) else ("+Inf" if obj > 0 else "-Inf")
    if isinstance(obj, dict):
        return {k: _json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_json_sanitize(v) for v in obj]
    return obj


def render_json() -> str:
    """Spec-valid JSON serialization of ``snapshot()``."""
    return json.dumps(_json_sanitize(REGISTRY.snapshot())) + "\n"


def value(name, **labels):
    return REGISTRY.value(name, **labels)


def render_prometheus():
    return REGISTRY.render_prometheus()


# --- stall / health gauges ---------------------------------------------------

_G_SECONDS_SINCE = gauge(
    "hvd_seconds_since_last_collective",
    "Seconds since an eager collective completed SUCCESSFULLY on this "
    "process (-1 before the first one; errored collectives do not "
    "reset it). A value growing past the stall window during training "
    "means the negotiation is wedged or every collective is failing.")
_G_STALLED = gauge(
    "hvd_stalled_tensors",
    "In-flight eager tensors older than HOROVOD_STALL_CHECK_TIME_SECONDS "
    "on this process.")
_G_PENDING = gauge(
    "hvd_pending_tensors",
    "Eager tensors currently in flight through the native core.")

_last_collective_lock = threading.Lock()
_last_collective: List[Optional[float]] = [None]


def mark_collective():
    """Stamp the completion of an eager collective (ops/eager.py)."""
    with _last_collective_lock:
        _last_collective[0] = time.monotonic()


def set_pending_tensors(pending: int, stalled: int):
    """Publish the in-flight/stalled tensor view (core/session.py)."""
    _G_PENDING.set(pending)
    _G_STALLED.set(stalled)


def _update_health():
    with _last_collective_lock:
        last = _last_collective[0]
    _G_SECONDS_SINCE.set(-1.0 if last is None
                         else time.monotonic() - last)


REGISTRY.register_collector("health", _update_health)


class HealthReporter:
    """Periodically refreshes collector-fed gauges so a passive scrape
    of a wedged process still shows fresh stall data (every export also
    runs collectors; this thread covers pull paths that bypass the
    registry, e.g. a debugger reading gauge objects directly, and keeps
    the gauges warm between scrapes)."""

    def __init__(self, registry: MetricsRegistry = REGISTRY,
                 interval: Optional[float] = None):
        if interval is None:
            # A malformed knob must not take hvd.init() down — fall
            # back to the default and keep reporting.
            try:
                interval = float(os.environ.get(
                    "HVD_METRICS_HEALTH_INTERVAL", "10"))
            except ValueError:
                interval = 10.0
        # Repo convention: 0 (or negative) means off — start() no-ops
        # and no background thread runs (exports still refresh inline).
        self.interval = float(interval)
        self._registry = registry
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self):
        if self._thread is not None or self.interval <= 0:
            return
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="hvd-health-reporter")
        self._thread.start()

    def _run(self):
        while not self._stop.wait(max(self.interval, 0.1)):
            self._registry.run_collectors()

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None


_reporter_lock = threading.Lock()
_reporter: Optional[HealthReporter] = None


def start_health_reporter(interval: Optional[float] = None) -> HealthReporter:
    """Start (or return) the process-wide health reporter thread."""
    global _reporter
    with _reporter_lock:
        if _reporter is None:
            _reporter = HealthReporter(interval=interval)
            _reporter.start()
        return _reporter


def stop_health_reporter():
    global _reporter
    with _reporter_lock:
        reporter, _reporter = _reporter, None
    if reporter is not None:
        reporter.stop()
