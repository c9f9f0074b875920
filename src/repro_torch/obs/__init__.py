"""``repro_torch.obs`` — unified tracing, metrics, and profiling facade.

GastCoCo's design came out of *measurement* (the cache-miss profile of
existing dynamic-graph systems preceded CBList and the coroutine schedule);
this module gives the port the same instrument: one process-local place
where storage, maintenance, the tuner, and the serve frontend report what
they did and how long it took.

    import repro_torch.obs as obs

    obs.enable()                        # or REPRO_OBS=1 in the environment
    service.flush()                     # hot paths are pre-instrumented
    obs.report()                        # nested dict: metrics + spans +
                                        # structured decision log
    obs.dump_trace("trace.json")        # load in https://ui.perfetto.dev

Three pieces:

  * a global :class:`~repro_torch.obs.metrics.Registry` (counters /
    gauges / fixed-bucket histograms / percentile series, labeled);
  * a global :class:`~repro_torch.obs.trace.Tracer` (host spans with
    explicit launch-boundary attribution — see :meth:`wait` — and
    Chrome/Perfetto export);
  * this facade, which gates both behind one switch so the disabled path
    costs a single flag check and a shared no-op object per call site.

Enabling is dynamic (``enable()`` / ``disable()``), and ``REPRO_OBS=1``
turns it on at import, the JAX package's switch.

**Spans in a profiler capture.**  Any ``torch.profiler`` capture of a
service shows its phases, with no switch: while a profiler records, every
:func:`span` is a ``record_function`` range named ``repro.<name>``,
whether this module is enabled or not, on the profiler's clock beside the
kernels it launches.  With neither this module enabled nor a profiler
recording, a span is the shared no-op and costs one more flag check (the
profiler's own).
"""
from __future__ import annotations

import os
from typing import Callable, Optional

from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs.metrics import (LATENCY_BUCKETS_S, NULL, Registry,
                               count_bucket, delta, guarded_percentiles,
                               log_buckets, percentile_min_n)
from repro_torch.obs.signals import (EMPTY_VIEW, SignalBus, SignalSummary,
                               SignalView)
from repro_torch.obs.slo import Objective, SloTracker
from repro_torch.obs.trace import (NULL_SPAN, ProfilerRange, Tracer,
                                   profiling)

__all__ = [
    "enabled", "enable", "disable", "registry", "tracer", "set_clock",
    "counter", "gauge", "histogram", "series", "span", "wait", "instant",
    "attribute",
    "decision", "report", "dump_trace", "reset",
    "Registry", "Tracer", "count_bucket", "delta", "guarded_percentiles",
    "percentile_min_n", "log_buckets", "LATENCY_BUCKETS_S",
    "SignalBus", "SignalView", "SignalSummary", "EMPTY_VIEW", "signal_bus",
    "Objective", "SloTracker", "record_sweep", "sweep_profile",
]


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").lower() not in ("", "0", "false", "off")


_enabled = _env_flag("REPRO_OBS")
_registry = Registry()
_tracer = Tracer()
_signal_bus: Optional[SignalBus] = None


# ---- switches --------------------------------------------------------------

def enabled() -> bool:
    return _enabled


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = bool(on)


def disable() -> None:
    enable(False)


def registry() -> Registry:
    return _registry


def tracer() -> Tracer:
    return _tracer


def set_clock(clock: Callable[[], float]) -> None:
    """Inject a virtual clock into the tracer (tests, trace replay)."""
    _tracer.clock = clock


def signal_bus() -> SignalBus:
    """The global :class:`SignalBus` over the global registry (created on
    first use).  Subsystems that accept ``signals=`` share this bus unless
    handed a private one; like the registry it exists regardless of the
    enabled flag, but only accumulates samples while obs is on (a bus over
    a silent registry derives nothing)."""
    global _signal_bus
    if _signal_bus is None:
        _signal_bus = SignalBus(_registry)
    return _signal_bus


def record_sweep(storage, task: str = "sweep"):
    """Profile one sweep's locality (:mod:`repro_torch.obs.locality`) — no-op
    returning None when disabled."""
    if not _enabled:
        return None
    from repro_torch.obs.locality import record_sweep as _impl
    return _impl(storage, task=task)


def sweep_profile(storage) -> dict:
    """Locality statistics of ``storage`` regardless of the enabled flag
    (see :func:`repro_torch.obs.locality.sweep_profile`)."""
    from repro_torch.obs.locality import sweep_profile as _impl
    return _impl(storage)


# ---- metric accessors (null objects when disabled) ------------------------

def counter(name: str, **labels):
    return _registry.counter(name, **labels) if _enabled else NULL


def gauge(name: str, **labels):
    return _registry.gauge(name, **labels) if _enabled else NULL


def histogram(name: str, buckets=metrics_mod.DEFAULT_BUCKETS, **labels):
    return (_registry.histogram(name, buckets, **labels)
            if _enabled else NULL)


def series(name: str, maxlen: int = metrics_mod.DEFAULT_SERIES_WINDOW,
           **labels):
    return _registry.series(name, maxlen, **labels) if _enabled else NULL


# ---- tracing ---------------------------------------------------------------

def span(name: str, cat: str = "host", **args):
    """Span context manager: the tracer's when enabled, else the range
    ``repro.<name>`` while a profiler records, else a shared no-op."""
    if _enabled:
        return _tracer.span(name, cat=cat, **args)
    return ProfilerRange(name) if profiling() else NULL_SPAN


def wait(x, name: str = "device.sync", **args):
    """Attribute device time explicitly at a launch boundary: synchronises
    the devices of ``x``'s tensors under a ``cat="device"`` span when
    enabled, returns ``x`` untouched (without blocking) when disabled."""
    if _enabled:
        return _tracer.wait(x, name, **args)
    return x


def attribute(name: str, ts: float, dur: float, cat: str = "host",
              **args) -> None:
    """Record a pre-measured span slice (see :meth:`Tracer.attribute`):
    per-unit attribution of one fused measurement."""
    if _enabled:
        _tracer.attribute(name, ts, dur, cat=cat, **args)


def instant(name: str, cat: str = "host", **args) -> None:
    if _enabled:
        _tracer.instant(name, cat=cat, **args)


def decision(kind: str, **fields) -> None:
    """Record a structured decision (tuner plan, maintenance action): one
    registry log entry plus an instant trace marker."""
    if _enabled:
        _registry.decision(kind, **fields)
        _tracer.instant(kind, cat="decision", **fields)


# ---- reporting -------------------------------------------------------------

def report() -> dict:
    """The whole system's observability state as one nested dict:
    registry snapshot (counters/gauges/histograms/series), per-span-name
    timing aggregates, and the structured decision log."""
    out = {
        "enabled": _enabled,
        "metrics": _registry.snapshot(),
        "spans": _tracer.aggregate(),
        "decisions": list(_registry.decisions),
        "trace_events": len(_tracer.events),
        "trace_dropped": _tracer.dropped,
    }
    if _signal_bus is not None:
        out["signals"] = _signal_bus.report()
    return out


def dump_trace(path: str) -> str:
    """Write the recorded spans as Chrome/Perfetto ``trace_event`` JSON."""
    return _tracer.dump(path)


def reset() -> None:
    """Clear all recorded state (metrics, spans, decisions, signals)."""
    global _signal_bus
    _registry.reset()
    _tracer.reset()
    _signal_bus = None
