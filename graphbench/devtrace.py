"""The profiler reader: what ran on the card in a traced window.

:func:`profile` traces the CPU and the card with ``torch.profiler``; the
harness marks the window and each of its calls with ``record_function``
ranges named ``graphbench.<span>``.  :func:`read` takes the exported
Chrome trace and gives

* ``busy_s`` -- seconds in which a kernel, copy or fill ran on the card,
  inside the window (overlaps counted once), and ``window_s``, the
  window's length less the feed's;
* ``device_s_in`` -- those seconds inside each kind of span (by name);
* ``device_ops`` -- the ten device operations that took most time;
* ``idle_gaps`` -- idle seconds of the card summed by what the host was
  doing (the innermost span and the innermost host operation at the
  gap's middle), the ten largest.

The harness's feed between rounds (``graphbench.feed`` ranges: the next
batch made and copied to the card) is not the program's work: what it
launches counts nowhere, and its time is taken out of the window, as the
harness takes it out of the window's seconds.
It needs a card and a trace with device events: with either missing it
raises, and it never reads a CPU timing as a device one.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "graphbench.window"
FEED = "graphbench.feed"      # the harness's feed between rounds
TOP = 10
NAME_CHARS = 120              # a kernel's name as reported, cut


def profile():
    """A ``torch.profiler`` over the host and the card (enter it)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the device trace needs a CUDA device")
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    return torch.profiler.profile(activities=acts, record_shapes=False,
                                  with_stack=False, profile_memory=False)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _near(sorted_spans, t):
    """The spans of ``sorted_spans`` that start at or before ``t``, the
    last few (the feed's ranges do not nest)."""
    i = bisect.bisect_right(sorted_spans, (t, float("inf")))
    return sorted_spans[max(0, i - 2):i]


def _clip(iv, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]


def _covering(starts, items, t):
    """The innermost (latest-starting) item ``(s, e, name)`` covering
    ``t``, from items sorted by start."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 257), -1):
        s, e, name = items[j]
        if e >= t:
            return name
    return None


def read(path: Path) -> Dict:
    """The summary of the trace exported to ``path`` (see the module)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the device trace needs a CUDA device")
    return summarize(json.loads(Path(path).read_text())["traceEvents"])


def summarize(events: List[dict]) -> Dict:
    """The summary of a Chrome trace's events (see the module)."""
    dev, spans, ops, launches = [], [], [], []
    for ev in events:
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        s = float(ev["ts"])
        e = s + float(ev["dur"])
        cat = ev.get("cat", "")
        corr = ev.get("args", {}).get("correlation")
        if cat in DEVICE_CATS:
            dev.append((s, e, ev.get("name", "?")[:NAME_CHARS], corr))
        elif cat == "user_annotation" and ev.get("name", "").startswith(
                "graphbench."):
            spans.append((s, e, ev["name"]))
        elif cat == "cpu_op":
            ops.append((s, e, ev.get("name", "?")))
        elif cat == "cuda_runtime":
            launches.append((s, corr))
    feeds = sorted((s, e) for s, e, n in spans if n == FEED)
    fed = {c for t, c in launches
           if any(s <= t <= e for s, e in _near(feeds, t))}
    dev = [(s, e, n) for s, e, n, c in dev if c is None or c not in fed]
    spans = [x for x in spans if x[2] != FEED]
    win = [(s, e) for s, e, n in spans if n == WINDOW]
    if not win:
        raise RuntimeError(f"no {WINDOW} range in the trace")
    if not dev:
        raise RuntimeError("the trace holds no device event: the profiler "
                           "did not trace the card")
    lo, hi = win[0]
    fed_iv = _union(_clip(feeds, lo, hi))
    fed_us = sum(e - s for s, e in fed_iv)
    # the card's time outside the feed: what the feed covers is not busy
    covered = _union(_clip([(s, e) for s, e, _ in dev], lo, hi) + fed_iv)
    busy_us = sum(e - s for s, e in covered) - fed_us

    by_op = defaultdict(float)
    for s, e, name in dev:
        if e > lo and s < hi:
            by_op[name] += min(e, hi) - max(s, lo)
    device_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]

    # device seconds inside each kind of span
    inner = [(s, e, n) for s, e, n in spans if n != WINDOW]
    device_s_in = defaultdict(float)
    dstarts = [s for s, _, _ in sorted(dev)]
    dsorted = sorted(dev)
    for s, e, name in inner:
        i = bisect.bisect_left(dstarts, s)
        while i < len(dsorted) and dsorted[i][0] < e:
            ds, de, _ = dsorted[i]
            device_s_in[name] += (min(de, e) - ds) / 1e6
            i += 1

    # idle gaps, by what the host was doing at their middle
    inner.sort()
    ops.sort()
    sp_starts = [s for s, _, _ in inner]
    op_starts = [s for s, _, _ in ops]
    idle = defaultdict(float)
    edges = [lo] + [x for iv in covered for x in iv] + [hi]
    for gs, ge in zip(edges[0::2], edges[1::2]):
        if ge <= gs:
            continue
        mid = 0.5 * (gs + ge)
        span = _covering(sp_starts, inner, mid) or "graphbench.between"
        op = _covering(op_starts, ops, mid) or "python"
        idle[f"{span[len('graphbench.'):]}/{op}"] += (ge - gs) / 1e6
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo - fed_us) / 1e6,
            "device_s_in": {k[len("graphbench."):]: v
                            for k, v in device_s_in.items()},
            "device_ops": [[n, t / 1e6] for n, t in device_ops],
            "idle_gaps": [[n, t] for n, t in idle_gaps]}
