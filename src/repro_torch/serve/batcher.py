"""Shape-bucketed micro-batching: per-kind queues, deadline dispatch.

A frontend that fuses whatever happens to be queued would hand the device
a new batch shape per occupancy level (in the JAX package a compile each;
here a new allocation size, and a new capture for any CUDA graph kept per
shape).  The batcher therefore pads every fused mega-batch up to a
**bucket**: the smallest member of a fixed power-of-two ladder
(``ServePlan.bucket_set``) that holds the queued lanes.  The distinct
shapes per request kind are then bounded by ``len(bucket_set)`` —
observable via :meth:`JitShapeStat.cache_size`, which the serve report
carries so a storm is visible, not silent.

Dispatch is deadline-driven: each request may wait at most its latency
class's window (``ServePlan.windows``); a queue becomes due when its oldest
deadline expires or a full largest-bucket of lanes is waiting.  Requests
wider than the largest bucket are split across mega-batches at dispatch
(kind-specific result slicing reassembles them).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.serve.request import Ticket


def bucket_for(n: int, bucket_set: Sequence[int]) -> int:
    """Smallest bucket ≥ n (callers split anything wider than the max)."""
    for b in bucket_set:
        if n <= b:
            return b
    return bucket_set[-1]


class JitShapeStat:
    """Distinct padded shapes dispatched per request kind.

    Because every fused execution runs at a bucket shape, this is the set
    of batch shapes the frontend's data plane hands the device (the JAX
    package's compile-cache footprint, kept under its name).
    """

    def __init__(self):
        self._shapes: Dict[str, set] = {}

    def record(self, kind: str, bucket: int) -> None:
        self._shapes.setdefault(kind, set()).add(int(bucket))

    def cache_size(self, kind: str) -> int:
        return len(self._shapes.get(kind, ()))

    def report(self) -> Dict[str, dict]:
        return {k: {"jit_cache_size": len(v), "buckets": sorted(v)}
                for k, v in sorted(self._shapes.items())}


@dataclasses.dataclass
class MicroBatch:
    """One dispatch unit: tickets fused in arrival order.

    ``spans[i] = (batch_off, req_off, width)``: ticket ``i`` contributes its
    request lanes ``[req_off, req_off + width)`` at fused-array offset
    ``batch_off``.  A ticket wider than the room left in a bucket is split
    across consecutive micro-batches (its spans tile the request); the
    executor completes it once every lane has been served.
    """
    kind: str
    tickets: List[Ticket]
    spans: List[Tuple[int, int, int]]
    lanes: int                      # real lanes (sum of span widths)
    bucket: int                     # padded shape this batch dispatches at

    @property
    def occupancy(self) -> float:
        return self.lanes / self.bucket


class KindQueue:
    """FIFO of waiting tickets for one request kind."""

    def __init__(self, kind: str, bucket_set: Sequence[int],
                 windows: Dict[str, float]):
        self.kind = kind
        self.bucket_set = tuple(sorted(bucket_set))
        self.windows = dict(windows)
        # deques + a running lane counter: popping the head of a long
        # backlog must not shift the whole queue per dispatch
        self._waiting: collections.deque = collections.deque()  # (ticket, left)
        self._deadlines: collections.deque = collections.deque()
        self._pending_lanes = 0
        self._head_partial = False    # head ticket already served some lanes

    def put(self, ticket: Ticket, deadline: Optional[float] = None) -> None:
        """Queue a ticket; its dispatch deadline defaults to arrival + the
        class window.  ``deadline`` overrides for tickets entering late —
        admission-deferred requests re-queue with ``admit_time + window``
        (their wait was the budget's doing; the batching window still gets
        its co-batching slack) while latency keeps accruing from the true
        arrival."""
        window = self.windows[ticket.request.latency_class]
        self._waiting.append((ticket, ticket.request.size))
        self._deadlines.append(ticket.t_arrival + window
                               if deadline is None else deadline)
        self._pending_lanes += ticket.request.size

    @property
    def pending_lanes(self) -> int:
        return self._pending_lanes

    def __len__(self) -> int:
        return len(self._waiting)

    def next_deadline(self) -> Optional[float]:
        return min(self._deadlines) if self._deadlines else None

    def due(self, now: float) -> bool:
        if not self._waiting:
            return False
        if self._head_partial:
            return True          # finish a split ticket in the same pump —
                                 # all its parts serve one snapshot version
        if self.pending_lanes >= self.bucket_set[-1]:
            return True          # a full largest bucket is waiting
        return min(self._deadlines) <= now

    def take(self) -> MicroBatch:
        """Pop the next mega-batch (arrival order, ≤ the largest bucket).

        A ticket wider than the remaining room is split: its head lanes
        ride this batch, the tail stays queued at the front (same
        deadline), tagged so the executor defers completion until every
        part has run.
        """
        cap = self.bucket_set[-1]
        tickets, spans, off = [], [], 0
        split = False
        while self._waiting and off < cap:
            ticket, left = self._waiting[0]
            width = min(left, cap - off)
            req_off = ticket.request.size - left
            tickets.append(ticket)
            spans.append((off, req_off, width))
            off += width
            if width == left:
                self._waiting.popleft()
                self._deadlines.popleft()
            else:
                self._waiting[0] = (ticket, left - width)
                split = True
                break            # bucket is full
        self._pending_lanes -= off
        self._head_partial = split
        return MicroBatch(kind=self.kind, tickets=tickets, spans=spans,
                          lanes=off, bucket=bucket_for(off, self.bucket_set))
