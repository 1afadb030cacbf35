"""Production metrics registry: counters, gauges, exponential histograms.

The tracer answers "what happened during THIS window" (bounded span
rings, flight dumps); this module answers "how is the process doing,
cumulatively" — the signal plane the scale-out router, admission
controller, and closed-loop autotuner consume.  Design mirrors the
tracer's constraints:

- **Lock-free record path.**  Every metric child keeps *per-thread
  shards* (a tiny mutable cell registered once per thread under the
  registry lock, then mutated without any lock — safe under the GIL
  because each shard has exactly one writer).  The serving host path,
  AIO callback threads, and the SDC digest pool never contend; reads
  (``export_*``/``quantile``) merge shards at call time.
- **Near-zero cost when disabled.**  Emitters guard with
  ``if metrics.enabled`` (same idiom as ``if trace.enabled``); the
  singleton ships enabled unless ``DSTPU_METRICS=0``.
- **Injectable clock** (``configure(clock=...)``) so tests pin
  ``unix_time`` in exports.
- **Hand-computable histograms.**  Fixed exponential bucket bounds
  (``exponential_buckets``), quantiles by linear interpolation inside
  the crossing bucket — both derivable on paper for test fixtures, and
  guaranteed within one bucket width of the nearest-rank percentiles
  ``RequestLatencyTracker`` reports (serve_smoke gates this).
- **Scrapeable.**  ``export_text()`` emits Prometheus exposition format
  (``# HELP``/``# TYPE``, cumulative ``_bucket{le=...}`` series,
  ``_sum``/``_count``); ``export_json()`` a self-describing
  ``{"record": "metrics"}`` document that flight dumps embed and
  ``trace_summarize --metrics`` renders.

Stdlib-only, import-cycle-free: anything from the comm watchdog to the
swap path can feed it.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

__all__ = [
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "exponential_buckets", "get_registry", "metrics", "configure",
]

_SCHEMA_VERSION = 1
INF = float("inf")


def exponential_buckets(start: float, factor: float, count: int) -> Tuple[float, ...]:
    """``count`` upper bounds ``start * factor**i`` (``+Inf`` is implicit).

    >>> exponential_buckets(1.0, 2.0, 4)
    (1.0, 2.0, 4.0, 8.0)
    """
    if start <= 0 or factor <= 1.0 or count < 1:
        raise ValueError("need start > 0, factor > 1, count >= 1")
    return tuple(start * factor ** i for i in range(count))


# Default bucket layouts.  Milliseconds: 0.01 ms .. ~168 s covers TPOT
# fractions-of-ms through queue waits of minutes.  Seconds: 10 µs .. ~84 s
# covers stage brackets from a host dict-op to an NVMe restore storm.
MS_BUCKETS = exponential_buckets(0.01, 2.0, 24)
SECONDS_BUCKETS = exponential_buckets(1e-5, 2.0, 23)


def _fmt(v: float) -> str:
    """Exposition-format number: integral floats render without the
    trailing ``.0`` noise, everything else via repr (full precision)."""
    if v == INF:
        return "+Inf"
    if isinstance(v, float) and v.is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(str(v))}"' for k, v in labels.items())
    return "{" + inner + "}"


class _Child:
    """Base for one (metric, label-values) time series."""

    __slots__ = ("name", "labels", "_lock", "_shards", "_local")

    def __init__(self, name: str, labels: Dict[str, str], lock: threading.Lock):
        self.name = name
        self.labels = labels
        self._lock = lock                 # registry lock, registration only
        self._shards: Dict[int, Any] = {}
        self._local = threading.local()

    def _shard(self):
        s = getattr(self._local, "shard", None)
        if s is None:
            s = self._new_shard()
            with self._lock:
                self._shards[threading.get_ident()] = s
            self._local.shard = s
        return s

    def _all_shards(self) -> List[Any]:
        with self._lock:
            return list(self._shards.values())

    def _new_shard(self):            # pragma: no cover - abstract
        raise NotImplementedError


class _CounterShard:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0


class Counter(_Child):
    """Monotonic counter.  ``inc(n)`` on the calling thread's shard;
    ``set_total(v)`` mirrors an *external* cumulative counter (e.g. the
    swapper's ``sdc_counters`` dict) — monotonic max, single logical
    writer; don't mix the two styles on one child."""

    __slots__ = ("_abs",)

    def __init__(self, name, labels, lock):
        super().__init__(name, labels, lock)
        self._abs: Optional[float] = None

    def _new_shard(self):
        return _CounterShard()

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError("counters only go up")
        self._shard().value += n

    def set_total(self, v: float) -> None:
        cur = self._abs
        self._abs = float(v) if cur is None else max(cur, float(v))

    def value(self) -> float:
        if self._abs is not None:
            return self._abs
        return sum(s.value for s in self._all_shards())


class _GaugeShard:
    __slots__ = ("value", "stamp")

    def __init__(self):
        self.value = 0.0
        self.stamp = 0


class Gauge(_Child):
    """Last-write-wins gauge.  ``set()`` stamps the writing shard with a
    global sequence number so the merged read returns the most recent
    write across threads; ``add()`` accumulates (merged read sums)."""

    _seq = [0]  # class-level monotonic stamp; GIL-atomic enough for telemetry

    def _new_shard(self):
        return _GaugeShard()

    def set(self, v: float) -> None:
        s = self._shard()
        Gauge._seq[0] += 1
        s.stamp = Gauge._seq[0]
        s.value = float(v)

    def add(self, n: float = 1.0) -> None:
        s = self._shard()
        s.value += n
        s.stamp = -1                       # additive shards merge by sum

    def value(self) -> float:
        shards = self._all_shards()
        if not shards:
            return 0.0
        if any(s.stamp == -1 for s in shards):
            return sum(s.value for s in shards)
        live = max(shards, key=lambda s: s.stamp)
        return live.value


class _HistShard:
    __slots__ = ("counts", "sum", "count")

    def __init__(self, nbuckets: int):
        self.counts = [0] * (nbuckets + 1)   # +1 for the +Inf bucket
        self.sum = 0.0
        self.count = 0


class Histogram(_Child):
    """Fixed-bucket histogram; bounds are *upper* bucket edges plus an
    implicit ``+Inf``.  Observation is a binary search + three scalar
    writes on the thread's own shard — no lock, no allocation."""

    __slots__ = ("bounds",)

    def __init__(self, name, labels, lock, bounds: Sequence[float]):
        super().__init__(name, labels, lock)
        b = tuple(float(x) for x in bounds)
        if not b or any(b[i] >= b[i + 1] for i in range(len(b) - 1)):
            raise ValueError("bucket bounds must be strictly increasing")
        self.bounds = b

    def _new_shard(self):
        return _HistShard(len(self.bounds))

    def observe(self, v: float) -> None:
        s = self._shard()
        bounds = self.bounds
        lo, hi = 0, len(bounds)
        while lo < hi:                       # first bound >= v
            mid = (lo + hi) // 2
            if bounds[mid] < v:
                lo = mid + 1
            else:
                hi = mid
        s.counts[lo] += 1
        s.sum += v
        s.count += 1

    # -- merged reads ----------------------------------------------------

    def merged(self) -> Tuple[List[int], float, int]:
        counts = [0] * (len(self.bounds) + 1)
        total_sum, total_n = 0.0, 0
        for s in self._all_shards():
            for i, c in enumerate(s.counts):
                counts[i] += c
            total_sum += s.sum
            total_n += s.count
        return counts, total_sum, total_n

    def count(self) -> int:
        return self.merged()[2]

    def quantile(self, q: float) -> Optional[float]:
        """Estimate the ``q``-th percentile (``q`` in [0, 100]) by linear
        interpolation inside the crossing bucket.  Hand-computable:
        target rank = q/100 * count; walk cumulative counts; interpolate
        between the bucket's lower and upper bound by the fraction of
        the bucket's population below the target.  Values beyond the
        last finite bound clamp to it (the +Inf bucket has no width)."""
        counts, _s, n = self.merged()
        if n == 0:
            return None
        target = (q / 100.0) * n
        if target <= 0:
            target = min(1.0, float(n))
        cum = 0.0
        lower = 0.0
        for i, ub in enumerate(self.bounds):
            c = counts[i]
            if c and cum + c >= target:
                frac = (target - cum) / c
                return lower + (ub - lower) * frac
            cum += c
            lower = ub
        return self.bounds[-1]

    def bucket_width_at(self, v: float) -> float:
        """Width of the bucket containing ``v`` (the agreement tolerance
        serve_smoke uses: histogram quantile vs nearest-rank sample)."""
        lower = 0.0
        for ub in self.bounds:
            if v <= ub:
                return ub - lower
            lower = ub
        return self.bounds[-1] - (self.bounds[-2] if len(self.bounds) > 1
                                  else 0.0)


class _Family:
    """One metric name: type, help text, label schema, child per label
    combination.  Label-less use goes through the implicit ``()`` child
    (``family.inc()`` etc. proxy to it)."""

    __slots__ = ("name", "kind", "help", "label_names", "_lock", "_children",
                 "_bounds")

    def __init__(self, name: str, kind: str, help_: str,
                 label_names: Tuple[str, ...], lock: threading.Lock,
                 bounds: Optional[Sequence[float]] = None):
        self.name = name
        self.kind = kind
        self.help = help_
        self.label_names = label_names
        self._lock = lock
        self._children: Dict[Tuple[str, ...], _Child] = {}
        self._bounds = tuple(bounds) if bounds is not None else None

    def labels(self, **kv: Any) -> _Child:
        if tuple(sorted(kv)) != tuple(sorted(self.label_names)):
            raise ValueError(
                f"{self.name}: expected labels {self.label_names}, got "
                f"{tuple(sorted(kv))}")
        key = tuple(str(kv[k]) for k in self.label_names)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make(dict(zip(self.label_names, key)))
                    self._children[key] = child
        return child

    def _default(self) -> _Child:
        if self.label_names:
            raise ValueError(f"{self.name} is labelled; use .labels(...)")
        return self.labels()

    def _make(self, labels: Dict[str, str]) -> _Child:
        if self.kind == "counter":
            return Counter(self.name, labels, self._lock)
        if self.kind == "gauge":
            return Gauge(self.name, labels, self._lock)
        return Histogram(self.name, labels, self._lock, self._bounds)

    # label-less convenience proxies
    def inc(self, n: float = 1.0) -> None:
        self._default().inc(n)

    def set_total(self, v: float) -> None:
        self._default().set_total(v)

    def set(self, v: float) -> None:
        self._default().set(v)

    def add(self, n: float = 1.0) -> None:
        self._default().add(n)

    def observe(self, v: float) -> None:
        self._default().observe(v)

    def value(self) -> float:
        return self._default().value()

    def quantile(self, q: float) -> Optional[float]:
        return self._default().quantile(q)

    def children(self) -> List[_Child]:
        with self._lock:
            return [self._children[k] for k in sorted(self._children)]


class MetricsRegistry:
    """Process metrics: families keyed by name, Prometheus/JSON export.

    One process-wide instance lives at ``telemetry.metrics.metrics``
    (module attribute ``metrics`` below); tests build private instances.
    Like the tracer, runtime reconfiguration mutates the singleton in
    place so importers holding a reference observe it.
    """

    def __init__(self, enabled: bool = True,
                 clock: Callable[[], float] = time.time):
        self.enabled = bool(enabled)
        self.clock = clock
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}
        self.slo: Optional[Any] = None    # SLOSet attached by the engine

    def configure(self, enabled: Optional[bool] = None,
                  clock: Optional[Callable[[], float]] = None
                  ) -> "MetricsRegistry":
        with self._lock:
            if enabled is not None:
                self.enabled = bool(enabled)
            if clock is not None:
                self.clock = clock
        return self

    # -- registration ----------------------------------------------------

    def _family(self, name: str, kind: str, help_: str,
                labels: Sequence[str], bounds=None) -> _Family:
        fam = self._families.get(name)
        if fam is not None:
            if fam.kind != kind:
                raise ValueError(
                    f"{name} already registered as {fam.kind}, not {kind}")
            return fam
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, kind, help_, tuple(labels), self._lock,
                              bounds=bounds)
                self._families[name] = fam
        return fam

    def counter(self, name: str, help: str = "",
                labels: Sequence[str] = ()) -> _Family:
        return self._family(name, "counter", help, labels)

    def gauge(self, name: str, help: str = "",
              labels: Sequence[str] = ()) -> _Family:
        return self._family(name, "gauge", help, labels)

    def histogram(self, name: str, help: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = SECONDS_BUCKETS) -> _Family:
        return self._family(name, "histogram", help, labels, bounds=buckets)

    def get(self, name: str) -> Optional[_Family]:
        return self._families.get(name)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def reset(self) -> None:
        """Drop every family (bench/tests isolate runs with this)."""
        with self._lock:
            self._families.clear()

    def sync_counters(self, prefix: str, mapping: Dict[str, Any],
                      help: str = "") -> None:
        """Mirror an external dict of cumulative counters (swap sdc
        counters, KV-tiering counters) into ``<prefix><key>_total``
        series via monotonic ``set_total``."""
        if not self.enabled:
            return
        for k, v in mapping.items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self.counter(f"{prefix}{k}_total", help).set_total(v)

    # -- export ----------------------------------------------------------

    def export_text(self) -> str:
        """Prometheus exposition format (text/plain; version 0.0.4)."""
        lines: List[str] = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {fam.help or fam.name}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for child in fam.children():
                ls = child.labels
                if fam.kind in ("counter", "gauge"):
                    lines.append(
                        f"{fam.name}{_label_str(ls)} {_fmt(child.value())}")
                else:
                    counts, hsum, n = child.merged()
                    cum = 0
                    for i, ub in enumerate(child.bounds + (INF,)):
                        cum += counts[i]
                        bl = dict(ls)
                        bl["le"] = _fmt(ub)
                        lines.append(
                            f"{fam.name}_bucket{_label_str(bl)} {cum}")
                    lines.append(
                        f"{fam.name}_sum{_label_str(ls)} {_fmt(hsum)}")
                    lines.append(f"{fam.name}_count{_label_str(ls)} {n}")
        return "\n".join(lines) + ("\n" if lines else "")

    def export_json(self) -> Dict[str, Any]:
        """Self-describing document (flight-dump header, summarizer
        ``--metrics``/``--slo`` input).  Histograms carry raw bounds +
        per-bucket counts plus derived p50/p90/p99 so consumers need no
        quantile math of their own."""
        doc: Dict[str, Any] = {
            "record": "metrics", "version": _SCHEMA_VERSION,
            "unix_time": self.clock(),
            "counters": [], "gauges": [], "histograms": [],
        }
        for fam in self.families():
            for child in fam.children():
                base = {"name": fam.name, "help": fam.help,
                        "labels": dict(child.labels)}
                if fam.kind == "counter":
                    base["value"] = child.value()
                    doc["counters"].append(base)
                elif fam.kind == "gauge":
                    base["value"] = child.value()
                    doc["gauges"].append(base)
                else:
                    counts, hsum, n = child.merged()
                    base.update({
                        "buckets": list(child.bounds),
                        "counts": counts,            # per-bucket incl +Inf
                        "sum": hsum, "count": n,
                    })
                    for q in (50, 90, 99):
                        v = child.quantile(q)
                        base[f"p{q}"] = None if v is None else round(v, 6)
                    doc["histograms"].append(base)
        if self.slo is not None:
            try:
                doc["slo"] = self.slo.evaluate()
            except Exception:    # never let a bad objective kill a dump
                doc["slo"] = {}
        return doc

    def scalar_summary(self) -> Dict[str, float]:
        """Flat scalar view for ``serving_stages()["metrics"]`` /
        ``MonitorMaster`` (one level, scalar values only).  Keys are
        ``name{a=b}`` (+ ``_p50``.. for histograms)."""
        out: Dict[str, float] = {}
        for fam in self.families():
            for child in fam.children():
                key = fam.name + _label_str(child.labels)
                if fam.kind in ("counter", "gauge"):
                    out[key] = child.value()
                else:
                    _c, hsum, n = child.merged()
                    out[key + "_count"] = n
                    out[key + "_sum"] = round(hsum, 6)
                    for q in (50, 99):
                        v = child.quantile(q)
                        if v is not None:
                            out[key + f"_p{q}"] = round(v, 6)
        return out


def validate_metrics_doc(doc: Any) -> List[str]:
    """Structural checks on an ``export_json()`` document — shared by
    ``read_flight_record`` (embedded snapshots) and
    ``trace_summarize --validate``.  Returns a list of problems (empty
    == valid): envelope fields, per-series shapes, bucket-bound
    monotonicity, counts length == bounds + 1 (the +Inf bucket), and
    sum-of-counts == count."""
    problems: List[str] = []
    if not isinstance(doc, dict):
        return ["metrics doc is not an object"]
    if doc.get("record") != "metrics":
        problems.append(f"record != 'metrics' (got {doc.get('record')!r})")
    if not isinstance(doc.get("version"), int):
        problems.append("missing integer 'version'")
    for kind in ("counters", "gauges", "histograms"):
        seq = doc.get(kind)
        if not isinstance(seq, list):
            problems.append(f"'{kind}' is not a list")
            continue
        for i, m in enumerate(seq):
            where = f"{kind}[{i}]"
            if not isinstance(m, dict) or not isinstance(m.get("name"), str):
                problems.append(f"{where}: missing name")
                continue
            where = f"{kind}[{i}] ({m['name']})"
            if not isinstance(m.get("labels"), dict):
                problems.append(f"{where}: labels not a dict")
            if kind != "histograms":
                if not isinstance(m.get("value"), (int, float)):
                    problems.append(f"{where}: non-numeric value")
                continue
            bounds = m.get("buckets")
            counts = m.get("counts")
            if not isinstance(bounds, list) or not bounds:
                problems.append(f"{where}: missing buckets")
                continue
            if any(bounds[j] >= bounds[j + 1]
                   for j in range(len(bounds) - 1)):
                problems.append(f"{where}: bucket bounds not increasing")
            if not isinstance(counts, list) or \
                    len(counts) != len(bounds) + 1:
                problems.append(
                    f"{where}: counts length != len(buckets)+1")
                continue
            if any((not isinstance(c, int)) or c < 0 for c in counts):
                problems.append(f"{where}: negative/non-int bucket count")
            if sum(counts) != m.get("count"):
                problems.append(
                    f"{where}: sum(counts)={sum(counts)} != "
                    f"count={m.get('count')}")
    slo = doc.get("slo")
    if slo is not None and not isinstance(slo, dict):
        problems.append("'slo' is not an object")
    return problems


__all__.append("validate_metrics_doc")


# ---------------------------------------------------------------------------
# Process-wide singleton
# ---------------------------------------------------------------------------

def _env_on(name: str, default: bool) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


metrics = MetricsRegistry(enabled=_env_on("DSTPU_METRICS", True))


def get_registry() -> MetricsRegistry:
    return metrics


def configure(**kw) -> MetricsRegistry:
    """Mutate the process singleton in place (importers hold references)."""
    return metrics.configure(**kw)
