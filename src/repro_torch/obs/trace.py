"""Span-based tracing with Chrome/Perfetto ``trace_event`` export.

Host-side wall-clock spans over the orchestration layer (flush phases,
maintenance actions, serve dispatch) — the companion to the device-side
story ``torch.profiler`` tells.  Usage:

    with tracer.span("flush.upsert", cat="flush"):
        out = batch_update_stats(...)        # records *launch* time
    tracer.wait(out, "flush.upsert.device")  # device time, separately

**Launch boundaries.**  A CUDA launch returns as soon as the work is
*enqueued*; the device keeps working.  A naive span around it therefore
measures Python and launch overhead, not compute — and a span around the
*next* blocking host read silently inherits the previous call's device
time.  The discipline here: spans record launch time by default, and
:meth:`Tracer.wait` wraps ``torch.cuda.synchronize`` of the tensors'
device in its own span with ``cat="device"``, so device time is attributed
explicitly, never smeared into whatever host phase happened to block
first.

**On the profiler's clock.**  While a ``torch.profiler`` records, every
span also enters ``torch.profiler.record_function("repro.<name>")``: the
range sits in the profiler's trace beside the host operations and kernel
launches it covers, on the profiler's own clock.  No switch of this module
decides that; the profiler's own flag does (:func:`profiling`), so any
capture of a service shows its phases.  Outside a capture nothing is
entered.

The clock is injectable (``Tracer(clock=...)``) so tests and trace replays
run on a virtual timeline — the same pattern as the serve scheduler's
``ManualClock``.

Export: :meth:`Tracer.to_chrome` emits the ``trace_event`` JSON format
(``ph: "X"`` complete events, microsecond timestamps); load the dump in
https://ui.perfetto.dev or ``chrome://tracing``.  Nesting is positional —
contained time ranges on one track render as a flame — so no parent ids
are needed.
"""
from __future__ import annotations

import functools
import json
import time
from contextlib import contextmanager
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# completed spans retained before new ones are dropped (a runaway loop must
# not grow the trace without bound; drops are counted and reported)
DEFAULT_CAPACITY = 65536
# the profiler range of span ``name`` is ``PREFIX + name``
PREFIX = "repro."


def profiling() -> bool:
    """Whether a ``torch.profiler`` records now (its own flag, one
    attribute read)."""
    return _autograd_profiler._is_profiler_enabled


class Tracer:
    """Records host spans on one logical track; exports Chrome JSON."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 capacity: int = DEFAULT_CAPACITY):
        self.clock = clock
        self.capacity = int(capacity)
        self.events: List[dict] = []      # completed spans + instants
        self.dropped = 0
        self._depth = 0
        self._t0: Optional[float] = None

    # ---- recording --------------------------------------------------------

    def _record(self, ev: dict) -> None:
        if len(self.events) >= self.capacity:
            self.dropped += 1
            return
        self.events.append(ev)

    @contextmanager
    def span(self, name: str, cat: str = "host", **args):
        """Context manager recording one complete span.

        Yields a mutable record dict; ``record["dur"]`` holds the measured
        duration (seconds) after exit, so callers can feed the same number
        into a metrics series without re-timing.  While a profiler records
        the span is also its :class:`ProfilerRange`.
        """
        anno = ProfilerRange(name) if profiling() else None
        if anno is not None:
            anno.__enter__()
        t0 = self.clock()
        if self._t0 is None:
            self._t0 = t0
        rec = {"name": name, "cat": cat, "ph": "X", "ts": t0,
               "dur": 0.0, "depth": self._depth, "args": args}
        self._depth += 1
        try:
            yield rec
        finally:
            self._depth -= 1
            rec["dur"] = self.clock() - t0
            if anno is not None:
                anno.__exit__(None, None, None)
            self._record(rec)

    def traced(self, name: Optional[str] = None, cat: str = "host"):
        """Decorator form of :meth:`span`."""
        def wrap(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def inner(*a, **kw):
                with self.span(label, cat=cat):
                    return fn(*a, **kw)
            return inner
        return wrap

    def wait(self, x, name: str = "device.sync", **args):
        """``torch.cuda.synchronize`` of the devices ``x``'s tensors lie on,
        under a ``cat="device"`` span.

        The explicit attribution point for device time at a launch
        boundary; returns ``x`` so it chains:
        ``out = tracer.wait(f(a), "f.device")``.  Host tensors need no wait.
        """
        with self.span(name, cat="device", **args):
            for dev in _cuda_devices(x):
                torch.cuda.synchronize(dev)
        return x

    def attribute(self, name: str, ts: float, dur: float, cat: str = "host",
                  **args) -> None:
        """Record a pre-measured span (attribution, not measurement).

        The fused-dispatch escape hatch: when one call does the work of N
        logical units, the caller measures the fused call once and
        *attributes* slices of it — e.g. proportionally to per-unit lane
        counts — so per-unit tracks stay in the trace without forcing the
        units to execute sequentially.
        ``ts`` is a clock() timestamp, ``dur`` seconds; nesting renders
        positionally like every other span.
        """
        if self._t0 is None:
            self._t0 = ts
        self._record({"name": name, "cat": cat, "ph": "X", "ts": ts,
                      "dur": max(float(dur), 0.0), "depth": self._depth,
                      "args": args})

    def instant(self, name: str, cat: str = "host", **args) -> None:
        """A zero-duration marker (decision points, threshold crossings)."""
        t = self.clock()
        if self._t0 is None:
            self._t0 = t
        self._record({"name": name, "cat": cat, "ph": "i", "ts": t,
                      "dur": 0.0, "depth": self._depth, "args": args})

    # ---- export -----------------------------------------------------------

    # tid rows in the Chrome export: host dispatch spans and device sync
    # spans get their own tracks so dispatch-vs-device attribution renders
    # as parallel timelines instead of overlapping bars on one track
    _HOST_TID = 0
    _DEVICE_TID = 1

    def to_chrome(self) -> dict:
        """The ``trace_event`` JSON object (Perfetto/chrome://tracing).

        ``cat="device"`` spans (from :meth:`wait`) land on their own tid
        row: a device sync overlaps the host phase that awaits it, and two
        overlapping ``ph:"X"`` events on one tid render as garbage in
        Perfetto.  Thread-name metadata labels the two rows.
        """
        t0 = self._t0 or 0.0
        events = []
        for ev in self.events:
            tid = (self._DEVICE_TID if ev["cat"] == "device"
                   else self._HOST_TID)
            out = {"name": ev["name"], "cat": ev["cat"], "ph": ev["ph"],
                   "ts": (ev["ts"] - t0) * 1e6, "pid": 0, "tid": tid,
                   "args": ev["args"]}
            if ev["ph"] == "X":
                out["dur"] = ev["dur"] * 1e6
            else:
                out["s"] = "t"                      # instant scope: thread
            events.append(out)
        meta = [
            {"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
             "args": {"name": "repro_torch.obs"}},
            {"name": "thread_name", "ph": "M", "pid": 0,
             "tid": self._HOST_TID, "args": {"name": "host dispatch"}},
            {"name": "thread_name", "ph": "M", "pid": 0,
             "tid": self._DEVICE_TID, "args": {"name": "device sync"}},
            {"name": "thread_sort_index", "ph": "M", "pid": 0,
             "tid": self._HOST_TID, "args": {"sort_index": 0}},
            {"name": "thread_sort_index", "ph": "M", "pid": 0,
             "tid": self._DEVICE_TID, "args": {"sort_index": 1}},
        ]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def dump(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)
        return path

    def aggregate(self) -> Dict[str, dict]:
        """Per-span-name totals: {name: {count, total_s, max_s, cat}}."""
        agg: Dict[str, dict] = {}
        for ev in self.events:
            if ev["ph"] != "X":
                continue
            a = agg.setdefault(ev["name"], {"count": 0, "total_s": 0.0,
                                            "max_s": 0.0, "cat": ev["cat"]})
            a["count"] += 1
            a["total_s"] += ev["dur"]
            a["max_s"] = max(a["max_s"], ev["dur"])
        return agg

    def reset(self) -> None:
        self.events.clear()
        self.dropped = 0
        self._depth = 0
        self._t0 = None


def _cuda_devices(x) -> set:
    """The CUDA devices of the tensors in ``x`` (nested tuples, lists and
    dicts; NamedTuples are tuples)."""
    found, stack = set(), [x]
    while stack:
        v = stack.pop()
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                found.add(v.device)
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
        elif isinstance(v, dict):
            stack.extend(v.values())
    return found


class _NullSpan:
    """Disabled-mode stand-in for :meth:`Tracer.span`'s context manager —
    one shared object, no allocation per call site."""

    __slots__ = ()
    # mirrors the live record's interface for callers reading span timing
    dur = 0.0

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def get(self, key, default=None):
        return default

    def __getitem__(self, key):
        raise KeyError(key)


NULL_SPAN = _NullSpan()


class ProfilerRange:
    """A span as ``torch.profiler.record_function("repro.<name>")`` alone,
    for a span taken while a profiler records and this module's tracer
    does not; yields :data:`NULL_SPAN` as its record."""

    __slots__ = ("_range",)

    def __init__(self, name: str):
        self._range = torch.profiler.record_function(PREFIX + name)

    def __enter__(self):
        self._range.__enter__()
        return NULL_SPAN

    def __exit__(self, *exc):
        self._range.__exit__(*exc)
        return False
