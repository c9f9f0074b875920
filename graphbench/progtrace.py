"""The program's own ranges in a traced window.

While a profiler records, every ``repro_torch.obs`` span is a
``record_function`` range named ``repro.<span>``, on the profiler's clock
(no switch of the program's).  :func:`summarize` takes the Chrome trace a
traced window exports (``harness.TRACE_PATH``) and gives, for each range
name (the prefix cut):

* ``count`` -- the ranges of that name; ``host_ms`` -- their summed length;
* ``device_ms`` -- ms of the device operations *launched* while a range of
  that name was open, whenever they ran: an operation is matched to its
  ``cuda_runtime`` / ``cuda_driver`` launch by ``correlation`` and counts
  toward every name open at the launch (``device_self_ms``: toward the
  innermost range alone);
* ``idle_ms`` -- the card's idle ms inside the ranges' intervals
  (``idle_self_ms``: the idle ms whose innermost program range is this
  one);
* ``syncs`` -- the host's synchronisations with the card
  (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
  ``cudaEventSynchronize``) issued inside the ranges (``syncs_self``:
  innermost).

A name nested in a range of its own name counts once toward the inclusive
totals.  The program runs on the harness's one host thread, so ranges and
launches are matched by time alone.  As :mod:`graphbench.devtrace` reads
it: only inside the ``graphbench.window`` range, and the harness's feed
between rounds (``graphbench.feed``) is no one's -- what it launches
counts nowhere and its time is not idle.

    python3 -m graphbench.progtrace build/graphbench/trace.json

prints the table.  A trace is parsed once a process (cached by path and
modification time): every reader of a run asks for the same one.
"""
from __future__ import annotations

import bisect
import functools
import json
import sys
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from graphbench.devtrace import DEVICE_CATS, FEED, WINDOW, _union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
PREFIX = "repro."
NONE = "(none)"               # idle or launches under no program range
FIELDS = ("count", "host_ms", "device_ms", "device_self_ms", "idle_ms",
          "idle_self_ms", "syncs", "syncs_self")


def _inside(sorted_iv, t) -> bool:
    """``t`` lies in one of the disjoint sorted intervals ``sorted_iv``."""
    i = bisect.bisect_right(sorted_iv, (t, float("inf"))) - 1
    return i >= 0 and sorted_iv[i][0] <= t <= sorted_iv[i][1]


class _Idle:
    """The card's idle time in ``[lo, t]``, from the sorted idle gaps."""

    def __init__(self, gaps: List[Tuple[float, float]]):
        self.starts = [s for s, _ in gaps]
        self.gaps = gaps
        self.before = [0.0]
        for s, e in gaps:
            self.before.append(self.before[-1] + e - s)

    def upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        s, e = self.gaps[i - 1]
        return self.before[i - 1] + min(e, t) - s

    def between(self, a: float, b: float) -> float:
        return self.upto(b) - self.upto(a) if b > a else 0.0


def summarize(events: List[dict]) -> Dict:
    """``{"ranges": {name: {field: value}}, "window_ms", "device_ms",
    "idle_ms"}`` of a Chrome trace's events (see the module); the window's
    totals leave the feed out, as the ranges do."""
    dev, ranges, feeds, launches, wins = [], [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat, name = ev.get("cat", ""), ev.get("name", "")
        corr = ev.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((s, e, corr))
        elif cat == "user_annotation":
            if name.startswith(PREFIX):
                ranges.append((s, e, name[len(PREFIX):]))
            elif name == WINDOW:
                wins.append((s, e))
            elif name == FEED:
                feeds.append((s, e))
        elif cat in LAUNCH_CATS:
            launches.append((s, name, corr))
    if not wins:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    if not dev:
        raise RuntimeError("the trace holds no device event: the profiler "
                           "did not trace the card")
    lo, hi = wins[0]
    feeds = _union(feeds)
    fed = {c for t, _, c in launches if _inside(feeds, t)}

    # device ms of each launch, clipped to the window, the feed's left out
    op_ms: Dict[object, float] = defaultdict(float)
    busy = []
    for s, e, c in dev:
        if (c is not None and c in fed) or e <= lo or s >= hi:
            continue
        s, e = max(s, lo), min(e, hi)
        busy.append((s, e))
        if c is not None:
            op_ms[c] += (e - s) / 1e3
    covered = _union(busy + [(max(s, lo), min(e, hi)) for s, e in feeds
                             if e > lo and s < hi])
    edges = [lo] + [x for iv in covered for x in iv] + [hi]
    idle = _Idle([(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s])

    # one sweep over the ranges (properly nested on the one host thread)
    # and the points inside them: launches and synchronisations
    marks = []
    for i, (s, e, _) in enumerate(ranges):
        if lo <= s < hi:
            marks.append((s, 0, -e, i))
            marks.append((e, 2, 0.0, i))
    seen = set()                     # one launch a correlation
    for t, name, c in launches:
        if not lo <= t <= hi:
            continue
        if c is not None and c in op_ms and c not in seen:
            seen.add(c)
            marks.append((t, 1, 0.0, ("op", op_ms[c])))
        if name.startswith(SYNCS):
            marks.append((t, 1, 0.0, ("sync", 1)))
    marks.sort(key=lambda m: m[:3])

    out = defaultdict(lambda: dict.fromkeys(FIELDS, 0.0))
    stack: List[int] = []
    names: Tuple[str, ...] = ()      # the open names, each once
    inner = NONE
    prev = lo
    for t, kind, _, item in marks:
        if kind == 1:
            what, v = item
            key = ("device_ms", "device_self_ms") if what == "op" else \
                ("syncs", "syncs_self")
            for n in names:
                out[n][key[0]] += v
            out[inner][key[1]] += v
            continue
        out[inner]["idle_self_ms"] += idle.between(prev, t) / 1e3
        prev = t
        s, e, name = ranges[item]
        if kind == 0:
            row = out[name]
            row["count"] += 1
            if name not in names:
                row["host_ms"] += (min(e, hi) - s) / 1e3
                row["idle_ms"] += idle.between(s, min(e, hi)) / 1e3
            stack.append(item)
        else:
            stack.remove(item)
        names = tuple(dict.fromkeys(ranges[j][2] for j in stack))
        inner = ranges[stack[-1]][2] if stack else NONE
    out[inner]["idle_self_ms"] += idle.between(prev, hi) / 1e3
    for row in out.values():
        for k in ("count", "syncs", "syncs_self"):
            row[k] = int(row[k])
    return {"ranges": dict(out), "window_ms": (hi - lo) / 1e3,
            "device_ms": sum(op_ms.values()),
            "idle_ms": idle.upto(hi) / 1e3}


def table(path) -> Dict:
    """:func:`summarize` of the trace exported to ``path``, parsed once a
    process for each modification of the file."""
    st = Path(path).stat()
    return _parsed(str(path), st.st_mtime_ns, st.st_size)


@functools.lru_cache(maxsize=1)
def _parsed(path: str, mtime_ns: int, size: int) -> Dict:
    return summarize(json.loads(Path(path).read_text())["traceEvents"])


def ranges_of(rec) -> Optional[Dict[str, dict]]:
    """The program's ranges in a run's traced window, or None when the run
    was not traced; empty when the program made none."""
    if not rec.get("trace"):
        return None
    from graphbench import harness
    if not harness.TRACE_PATH.exists():
        return None
    return {k: v for k, v in table(harness.TRACE_PATH)["ranges"].items()
            if k != NONE}


def per(rec, name: str, field: str, parent: str, over: str
        ) -> Optional[float]:
    """``field`` of range ``name`` over ``rec[over]`` (batches, jobs);
    0 when the program made ``parent`` ranges but none called ``name``,
    None when it made no ``parent`` range (an untraced run, a program
    without ranges) or ``rec[over]`` is 0."""
    rows = ranges_of(rec)
    if not rows or parent not in rows or not rec[over]:
        return None
    return rows.get(name, {}).get(field, 0.0) / rec[over]


def format_table(summary: Dict) -> str:
    """The summary as a fixed-width table, one range name a row."""
    head = ("range", "count", "host ms", "dev ms", "dev self", "idle ms",
            "idle self", "syncs", "syncs self")
    rows = [head]
    for name, r in sorted(summary["ranges"].items()):
        rows.append((name, str(r["count"]))
                    + tuple(f"{r[k]:.1f}" for k in FIELDS[1:6])
                    + (str(r["syncs"]), str(r["syncs_self"])))
    width = [max(len(row[i]) for row in rows) for i in range(len(head))]
    lines = ["  ".join(c.ljust(w) if i == 0 else c.rjust(w)
                       for i, (c, w) in enumerate(zip(row, width)))
             for row in rows]
    lines.append(f"window {summary['window_ms']:.1f} ms, device "
                 f"{summary['device_ms']:.1f} ms, idle "
                 f"{summary['idle_ms']:.1f} ms")
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python3 -m graphbench.progtrace <trace.json>",
              file=sys.stderr)
        return 2
    print(format_table(table(argv[0])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
