"""Signal bus: bounded, windowed derived signals that close the obs loop.

The metrics registry (:mod:`repro_torch.obs.metrics`) records what
happened; this module turns those raw monotone counters and gauges into the
handful of *derived, windowed* statistics the tuner and maintenance policy
can act on:

  ==========================  =================================================
  signal                      derivation (per tick)
  ==========================  =================================================
  ``arrival_qps``             Δ ``serve.submitted`` / Δt     (dispatch tick)
  ``read_lanes_per_s``        Δ ``serve.read_lanes`` / Δt    (dispatch tick)
  ``read_pressure``           ``read_lanes_per_s`` / n_replicas — lanes/s each
                              replica actually absorbs       (dispatch tick)
  ``unseal_churn``            Δ ``seal.unseal_count`` per flush  (flush tick)
  ``shard_skew``              last ``flush.shard_skew`` series value
  ``sweep_contiguity``        last ``locality.contiguity`` gauge (or direct
                              ``observe``)                   (flush tick)
  ==========================  =================================================

Each signal keeps a bounded window of samples (:class:`Signal`), and
consumers receive an immutable :class:`SignalView` — plan functions
(:func:`repro_torch.core.tuner.choose_serve_plan`; in the JAX package also
``choose_plan`` and ``MaintenancePolicy.adapted``) take an optional view
and *adapt* their static knobs from the measured values, recording every
adapted decision (with the signal values that fired) in the structured
decision log.

Wiring (all opt-in — with no bus attached every plan is today's static
one, bit-identical):

    bus = obs.signal_bus()                  # global bus over the registry
    service = GraphService(..., signals=bus)
    front = ServeFrontend(service, signals=bus, retune_interval=0.5)

The bus derives from the *global* obs registry, so live signals require
``obs.enable()`` (or ``REPRO_OBS=1``) like every other obs feature; an
attached bus over a disabled registry simply never accumulates samples and
every consumer falls back to its static defaults.  Tests inject synthetic
signals with :meth:`SignalBus.observe` directly.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, NamedTuple, Optional

# samples retained per signal (ticks, not seconds — flush ticks arrive once
# per flush, dispatch ticks once per scheduler step)
DEFAULT_SIGNAL_WINDOW = 64

# minimum seconds between dispatch-tick rate samples: scheduler steps can
# arrive microseconds apart and a rate over a ~0 interval is noise
MIN_RATE_INTERVAL_S = 1e-3


class SignalSummary(NamedTuple):
    """One signal's windowed statistics (what a :class:`SignalView` holds)."""
    last: float
    mean: float
    max: float
    n: int


class Signal:
    """Bounded window of raw samples with last/mean/max accessors."""

    __slots__ = ("window",)

    def __init__(self, maxlen: int = DEFAULT_SIGNAL_WINDOW):
        self.window: deque = deque(maxlen=maxlen)

    def observe(self, v: float) -> None:
        self.window.append(float(v))

    @property
    def n(self) -> int:
        return len(self.window)

    def summary(self) -> Optional[SignalSummary]:
        if not self.window:
            return None
        vals = list(self.window)
        return SignalSummary(last=vals[-1], mean=sum(vals) / len(vals),
                             max=max(vals), n=len(vals))


class SignalView:
    """Immutable snapshot of the bus: ``{name: SignalSummary}``.

    The unit plan functions consume — a view taken at decision time cannot
    change under the decision, and a view is trivially constructible in
    tests (``SignalView({"read_lanes_per_s": SignalSummary(...)})`` or via
    :meth:`SignalBus.observe` + :meth:`SignalBus.view`).
    """

    __slots__ = ("_signals",)

    def __init__(self, signals: Dict[str, SignalSummary]):
        self._signals = dict(signals)

    def get(self, name: str) -> Optional[SignalSummary]:
        return self._signals.get(name)

    def __contains__(self, name: str) -> bool:
        return name in self._signals

    def names(self):
        return sorted(self._signals)

    def as_dict(self) -> dict:
        """JSON-safe nested dict (for reports and decision-log fields)."""
        return {k: {"last": s.last, "mean": s.mean, "max": s.max, "n": s.n}
                for k, s in sorted(self._signals.items())}

    def __repr__(self):
        return f"SignalView({self.names()})"


EMPTY_VIEW = SignalView({})


def _sum_counters(registry, name: str) -> float:
    return sum(m.value for _, m in registry.collect(name))


def _last_series(registry, name: str) -> Optional[float]:
    for _, s in registry.collect(name):
        if s.window:
            return float(s.window[-1])
    return None


class SignalBus:
    """Derives windowed signals from a metrics registry on explicit ticks.

    ``tick_flush`` runs once per service flush (churn / skew / contiguity),
    ``tick_dispatch`` once per scheduler step (arrival / read-pressure
    rates).  Both are cheap host arithmetic over registry state — no device
    work, no blocking.
    """

    def __init__(self, registry=None, clock: Callable[[], float] = None,
                 window: int = DEFAULT_SIGNAL_WINDOW):
        if registry is None:
            import repro_torch.obs as obs
            registry = obs.registry()
        self.registry = registry
        self.clock = clock if clock is not None else time.monotonic
        self.window = int(window)
        self._signals: Dict[str, Signal] = {}
        # monotone-counter checkpoints for delta computation
        self._last_flush_counts: Optional[dict] = None
        self._last_dispatch: Optional[dict] = None
        self.ticks = {"flush": 0, "dispatch": 0}

    # ---- direct observation (tests, subsystems without counters) ----------

    def observe(self, name: str, value: float) -> None:
        sig = self._signals.get(name)
        if sig is None:
            sig = self._signals[name] = Signal(self.window)
        sig.observe(value)

    # ---- ticks ------------------------------------------------------------

    def tick_flush(self, now: Optional[float] = None) -> None:
        """Derive the flush-cadence signals (call once per flush, after the
        flush's counters have landed)."""
        self.ticks["flush"] += 1
        cur = {
            "unseals": _sum_counters(self.registry, "seal.unseal_count"),
            "seals": _sum_counters(self.registry, "seal.seal_count"),
            "flushes": _sum_counters(self.registry, "flush.count"),
        }
        prev = self._last_flush_counts
        self._last_flush_counts = cur
        if prev is not None:
            # one tick per flush: the per-tick delta IS the per-flush rate
            # (flush.count guards against a caller ticking more than once)
            n_flushes = max(cur["flushes"] - prev["flushes"], 1.0)
            self.observe("unseal_churn",
                         (cur["unseals"] - prev["unseals"]) / n_flushes)
            self.observe("seal_rate",
                         (cur["seals"] - prev["seals"]) / n_flushes)
        skew = _last_series(self.registry, "flush.shard_skew")
        if skew is not None:
            self.observe("shard_skew", skew)
        for _, metric in self.registry.collect("locality.contiguity"):
            self.observe("sweep_contiguity", metric.value)
            break

    def tick_dispatch(self, now: Optional[float] = None,
                      n_replicas: int = 1) -> None:
        """Derive the dispatch-cadence rate signals (call once per
        scheduler step; intervals shorter than ``MIN_RATE_INTERVAL_S``
        accumulate into the next sample instead of producing noise)."""
        now = float(self.clock()) if now is None else float(now)
        self.ticks["dispatch"] += 1
        cur = {
            "t": now,
            "submitted": _sum_counters(self.registry, "serve.submitted"),
            "read_lanes": _sum_counters(self.registry, "serve.read_lanes"),
        }
        prev = self._last_dispatch
        if prev is None:
            self._last_dispatch = cur
            return
        dt = now - prev["t"]
        if dt < MIN_RATE_INTERVAL_S:
            return                      # keep the old checkpoint; accumulate
        self._last_dispatch = cur
        self.observe("arrival_qps", (cur["submitted"] - prev["submitted"]) / dt)
        lanes_per_s = (cur["read_lanes"] - prev["read_lanes"]) / dt
        self.observe("read_lanes_per_s", lanes_per_s)
        self.observe("read_pressure", lanes_per_s / max(1, int(n_replicas)))

    # ---- consumption ------------------------------------------------------

    def view(self) -> SignalView:
        return SignalView({name: summ for name, sig in self._signals.items()
                           if (summ := sig.summary()) is not None})

    def report(self) -> dict:
        """JSON-safe state for ``obs.report()`` / CI artifacts."""
        return {"ticks": dict(self.ticks), "signals": self.view().as_dict()}
