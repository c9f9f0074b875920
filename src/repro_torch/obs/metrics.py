"""Process-local metrics registry: counters, gauges, histograms, series.

The measurement substrate the paper's methodology asks for (GastCoCo §3
instruments existing systems *before* designing around the findings): a
dependency-free registry of labeled series —

    registry.counter("flush.coalesced", shard=2).inc(n)
    registry.gauge("tier.sealed_fraction").set(0.4)
    registry.histogram("flush.batch_lanes").observe(512)
    registry.series("serve.latency_s", tenant="fraud").observe(dt)

Four metric kinds:

  * :class:`Counter`   — monotone accumulator (events, lanes, retries);
  * :class:`Gauge`     — last-write-wins level (sealed fraction, pending);
  * :class:`Histogram` — fixed-bucket distribution (count/sum/min/max plus
    per-bucket tallies; buckets are static so observing is O(log B) with no
    allocation);
  * :class:`Series`    — bounded reservoir of raw values for exact
    percentiles (serving latencies) with small-sample guards.

Everything is plain Python state — the registry is read/written strictly
host-side, between device steps, like every other scheduling decision in
this repo (maintenance, tuner).  Gating (zero overhead when observability
is off) lives in the :mod:`repro_torch.obs` facade, not here: a Registry
object is always live so subsystems that have always collected stats (the serve
frontend) can keep a private one regardless of the global switch.

Snapshots are nested plain dicts (JSON-safe); :func:`delta` subtracts two
snapshots' monotone parts so benches can report per-interval rates.
"""
from __future__ import annotations

import bisect
import math
from collections import deque
from typing import Dict, Iterable, List, Tuple

# default histogram buckets: seconds-oriented exponential ladder (also fine
# for lane counts — callers pass their own edges when the unit differs)
DEFAULT_BUCKETS = (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0)


def log_buckets(lo: float = 1e-5, hi: float = 10.0,
                per_decade: int = 3) -> Tuple[float, ...]:
    """Log-spaced bucket edges from ``lo`` to at least ``hi`` with
    ``per_decade`` edges per decade (1-2-5 style at the default 3).

    DEFAULT_BUCKETS is one edge per decade — fine for order-of-magnitude
    attribution, too coarse for latency distributions where the p50/p99
    spread of one phase lives inside a single decade.
    """
    if lo <= 0 or hi <= lo:
        raise ValueError(f"need 0 < lo < hi, got lo={lo} hi={hi}")
    per_decade = max(1, int(per_decade))
    edges = []
    exp = math.floor(math.log10(lo))
    step = 1.0 / per_decade
    k = 0
    while True:
        edge = 10.0 ** (exp + k * step)
        # snap to a clean mantissa so edge labels stay readable
        edge = float(f"{edge:.3g}")
        if edge >= lo or abs(edge - lo) < 1e-12 * lo:
            edges.append(edge)
        if edge >= hi:
            break
        k += 1
    return tuple(edges)


# latency-oriented preset: 10us .. 10s, 3 edges per decade — the ladder the
# flush-phase and serve-latency histograms share
LATENCY_BUCKETS_S = log_buckets(1e-5, 10.0, 3)

# how many raw values a Series retains for percentile computation
DEFAULT_SERIES_WINDOW = 8192

# decision-log retention (structured tuner/maintenance decisions)
DECISION_LOG_CAPACITY = 256


def percentile_min_n(p: float) -> int:
    """Minimum sample count for percentile ``p`` to be meaningful: at least
    one sample must lie beyond it (p50 needs 2, p99 needs 100, ...)."""
    return max(2, int(math.ceil(100.0 / max(100.0 - p, 1e-9))))


def guarded_percentiles(values, pcts: Iterable[float] = (50, 99)) -> dict:
    """``{"n": ..., "p50": ..., "p99": ...}`` with small-sample guards.

    A percentile is only emitted when the sample count clears
    :func:`percentile_min_n` — p99 over a dozen latencies is a noisy
    max-ish value, not a tail estimate.  ``n`` is always present so the
    consumer can tell "no tail yet" from "no traffic".
    """
    vals = sorted(float(v) for v in values)
    out = {"n": len(vals)}
    for p in pcts:
        if len(vals) >= percentile_min_n(p):
            # nearest-rank on the sorted sample
            idx = min(len(vals) - 1, int(math.ceil(p / 100.0 * len(vals))) - 1)
            out[f"p{p:g}"] = vals[max(idx, 0)]
    return out


def count_bucket(n: int) -> str:
    """Coarse magnitude bucket for churn counters (seal/unseal batch sizes
    keep a bounded label set instead of one series per exact count)."""
    n = int(n)
    if n <= 1:
        return "1"
    if n < 8:
        return "2-7"
    if n < 64:
        return "8-63"
    if n < 512:
        return "64-511"
    return "512+"


def _label_key(labels: dict) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def format_series(name: str, label_key: Tuple[Tuple[str, str], ...]) -> str:
    if not label_key:
        return name
    return name + "{" + ",".join(f"{k}={v}" for k, v in label_key) + "}"


class Counter:
    """Monotone accumulator."""

    __slots__ = ("value",)
    kind = "counters"

    def __init__(self):
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n

    def snapshot(self) -> float:
        return self.value


class Gauge:
    """Last-write-wins level."""

    __slots__ = ("value",)
    kind = "gauges"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def snapshot(self) -> float:
        return self.value


class Histogram:
    """Fixed-bucket distribution: ``counts[i]`` tallies values ``<=
    buckets[i]`` (exclusive of the previous edge); one overflow bucket."""

    __slots__ = ("buckets", "counts", "count", "sum", "min", "max")
    kind = "histograms"

    def __init__(self, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def snapshot(self) -> dict:
        edges = [f"le_{b:g}" for b in self.buckets] + ["le_inf"]
        return {"count": self.count, "sum": self.sum,
                "min": None if self.count == 0 else self.min,
                "max": None if self.count == 0 else self.max,
                "buckets": dict(zip(edges, self.counts))}


class Series:
    """Bounded reservoir of raw values (exact percentiles over the window).

    ``count``/``sum`` are total (never forgotten); the percentile window
    keeps the most recent :data:`DEFAULT_SERIES_WINDOW` observations.
    """

    __slots__ = ("window", "count", "sum")
    kind = "series"

    def __init__(self, maxlen: int = DEFAULT_SERIES_WINDOW):
        self.window: deque = deque(maxlen=maxlen)
        self.count = 0
        self.sum = 0.0

    def observe(self, v: float) -> None:
        v = float(v)
        self.window.append(v)
        self.count += 1
        self.sum += v

    def values(self) -> List[float]:
        return list(self.window)

    def summary(self, pcts: Iterable[float] = (50, 99)) -> dict:
        out = guarded_percentiles(self.window, pcts)
        out["n"] = self.count            # total, not just the window
        out["sum"] = self.sum
        if self.count:
            out["mean"] = self.sum / self.count
        # window bookkeeping: percentiles above are over window_n of the
        # most recent samples (capacity window_cap), so bounded-window
        # statistics are self-describing
        out["window_n"] = len(self.window)
        out["window_cap"] = self.window.maxlen
        return out

    def snapshot(self) -> dict:
        return self.summary()


class NullMetric:
    """Shared no-op standing in for every metric kind when observability is
    disabled — the call sites stay unconditional and cost one attribute
    lookup plus an empty call."""

    __slots__ = ()

    def inc(self, n: float = 1.0) -> None:
        pass

    def set(self, v: float) -> None:
        pass

    def observe(self, v: float) -> None:
        pass


NULL = NullMetric()


class Registry:
    """Named, labeled metric series + a bounded structured decision log."""

    def __init__(self):
        self._metrics: Dict[str, Dict[Tuple, object]] = {}
        self._kinds: Dict[str, type] = {}
        self.decisions: deque = deque(maxlen=DECISION_LOG_CAPACITY)
        self._decision_seq = 0

    # ---- accessors --------------------------------------------------------

    def _get(self, name: str, labels: dict, cls, *args):
        want = self._kinds.setdefault(name, cls)
        if want is not cls:
            raise TypeError(f"metric {name!r} already registered as "
                            f"{want.__name__}, requested {cls.__name__}")
        family = self._metrics.setdefault(name, {})
        key = _label_key(labels)
        metric = family.get(key)
        if metric is None:
            metric = family[key] = cls(*args)
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str,
                  buckets: Tuple[float, ...] = DEFAULT_BUCKETS,
                  **labels) -> Histogram:
        return self._get(name, labels, Histogram, buckets)

    def series(self, name: str, maxlen: int = DEFAULT_SERIES_WINDOW,
               **labels) -> Series:
        return self._get(name, labels, Series, maxlen)

    def collect(self, name: str) -> List[Tuple[dict, object]]:
        """All (labels, metric) pairs of one family, label-sorted."""
        family = self._metrics.get(name, {})
        return [(dict(key), metric) for key, metric in sorted(family.items())]

    # ---- decision log -----------------------------------------------------

    def decision(self, kind: str, **fields) -> dict:
        """Append one structured decision record (tuner plan, maintenance
        action): inputs, outcome, and the rule that fired, as plain data."""
        self._decision_seq += 1
        rec = {"seq": self._decision_seq, "kind": kind, **fields}
        self.decisions.append(rec)
        return rec

    # ---- snapshot / delta / reset ----------------------------------------

    def snapshot(self) -> dict:
        out = {"counters": {}, "gauges": {}, "histograms": {}, "series": {}}
        for name, family in sorted(self._metrics.items()):
            for key, metric in sorted(family.items()):
                out[metric.kind][format_series(name, key)] = metric.snapshot()
        return out

    def reset(self) -> None:
        self._metrics.clear()
        self._kinds.clear()
        self.decisions.clear()
        self._decision_seq = 0


def _monotone_delta(cur: float, prev: float) -> float:
    """``cur - prev`` with counter-reset detection: a monotone value lower
    than its predecessor means the registry was reset between snapshots
    (``Registry.reset()``), so the whole current value is the increment —
    the Prometheus rate() convention."""
    return cur if cur < prev else cur - prev


def delta(cur: dict, prev: dict) -> dict:
    """Difference of two registry snapshots' monotone parts.

    Counters subtract; histograms subtract count/sum/buckets; gauges and
    series report their current value (levels and reservoirs have no
    meaningful subtraction).  A ``Registry.reset()`` between the two
    snapshots is detected per-metric (current value below the previous one)
    and treated as a restart from zero rather than a negative increment.
    """
    out = {"counters": {}, "gauges": dict(cur.get("gauges", {})),
           "histograms": {}, "series": dict(cur.get("series", {}))}
    pc = prev.get("counters", {})
    for k, v in cur.get("counters", {}).items():
        out["counters"][k] = _monotone_delta(v, pc.get(k, 0.0))
    ph = prev.get("histograms", {})
    for k, h in cur.get("histograms", {}).items():
        p = ph.get(k)
        if p is None or h["count"] < p["count"]:
            # new family, or reset boundary: the histogram restarted
            out["histograms"][k] = h
            continue
        out["histograms"][k] = {
            "count": h["count"] - p["count"], "sum": h["sum"] - p["sum"],
            "min": h["min"], "max": h["max"],
            "buckets": {e: _monotone_delta(n, p["buckets"].get(e, 0))
                        for e, n in h["buckets"].items()}}
    return out
