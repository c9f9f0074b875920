"""Typed request IR for the serving frontend.

Every request entering :class:`~repro_torch.serve.scheduler.ServeFrontend`
is one of five kinds, tagged with a **tenant id** (scheduling + stats + the
read-your-writes opt-in live per tenant) and a **latency class** (which
dispatch window the micro-batcher may hold it for).  Requests carry
host-side numpy arrays — they sit in queues until the batcher fuses them
into one padded device batch, so keeping them off-device avoids a transfer
per request.

``size`` is the number of batch lanes the request occupies in a fused
mega-batch (the unit the shape buckets are measured in); requests wider
than the largest bucket are split by the batcher at dispatch.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Optional, Tuple

import numpy as np

LATENCY_CLASSES = ("interactive", "standard", "batch")

_ticket_ids = itertools.count()


def _i32(x) -> np.ndarray:
    return np.atleast_1d(np.asarray(x, np.int32))


@dataclasses.dataclass(frozen=True)
class Request:
    """Base request: tenant + latency class tags (scheduling metadata)."""
    tenant: str = "default"
    latency_class: str = "standard"

    def __post_init__(self):
        if self.latency_class not in LATENCY_CLASSES:
            raise ValueError(f"latency_class {self.latency_class!r} not in "
                             f"{LATENCY_CLASSES}")

    @property
    def kind(self) -> str:
        return KIND_OF[type(self)]

    @property
    def size(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class PointRead(Request):
    """Batched edge-existence + weight lookup: (found, weight) per lane."""
    qsrc: np.ndarray = None
    qdst: np.ndarray = None

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "qsrc", _i32(self.qsrc))
        object.__setattr__(self, "qdst", _i32(self.qdst))
        if self.qsrc.shape != self.qdst.shape:
            raise ValueError("qsrc/qdst shape mismatch")

    @property
    def size(self) -> int:
        return int(self.qsrc.shape[0])


@dataclasses.dataclass(frozen=True)
class DegreeRead(Request):
    """Batched out-degree lookup (out-of-range ids report 0)."""
    verts: np.ndarray = None

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "verts", _i32(self.verts))

    @property
    def size(self) -> int:
        return int(self.verts.shape[0])


@dataclasses.dataclass(frozen=True)
class KHopSample(Request):
    """Fanout neighborhood sample from ``seeds``.

    The fanout spec is frontend configuration (``ServeFrontend``'s
    ``fanout``), not per-request — a per-request fanout would open an
    unbounded set of batch shapes.  ``seed`` salts the batch's generator
    seed per request.
    """
    seeds: np.ndarray = None
    seed: int = 0

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "seeds", _i32(self.seeds))

    @property
    def size(self) -> int:
        return int(self.seeds.shape[0])


@dataclasses.dataclass(frozen=True)
class Analytics(Request):
    """One registered vertex-program run (cached/warm-started per epoch by
    the service; the frontend dispatches these singly — a program run is
    already a whole-graph batch)."""
    name: str = "pagerank"
    source: Optional[int] = None
    kw: Tuple = ()     # extra program kwargs as a sorted tuple of pairs

    @property
    def size(self) -> int:
        return 1


@dataclasses.dataclass(frozen=True)
class UpdateBatch(Request):
    """Edge upserts/deletes to admit into the service's update log."""
    src: np.ndarray = None
    dst: np.ndarray = None
    w: Optional[np.ndarray] = None
    op: Optional[np.ndarray] = None

    def __post_init__(self):
        super().__post_init__()
        object.__setattr__(self, "src", _i32(self.src))
        object.__setattr__(self, "dst", _i32(self.dst))
        if self.src.shape != self.dst.shape:
            raise ValueError("src/dst shape mismatch")
        if self.w is not None:
            object.__setattr__(self, "w",
                               np.atleast_1d(np.asarray(self.w, np.float32)))
        if self.op is not None:
            object.__setattr__(self, "op", _i32(self.op))

    @property
    def size(self) -> int:
        return int(self.src.shape[0])


KIND_OF = {PointRead: "point_read", DegreeRead: "degree_read",
           KHopSample: "khop", Analytics: "analytics",
           UpdateBatch: "update"}
KINDS = tuple(KIND_OF.values())
READ_KINDS = ("point_read", "degree_read", "khop")


class Ticket:
    """Mutable completion handle for one submitted request.

    ``value`` is populated at dispatch completion; ``version`` records the
    ``(epoch, watermark)`` snapshot version the request was served at.
    For updates that is the version current *at admission* — it does NOT
    yet contain the admitted records; they become visible at the first
    snapshot whose watermark exceeds this one.  Timing fields are in the
    frontend clock's unit (wall seconds by default, virtual in tests).
    """

    __slots__ = ("id", "request", "t_arrival", "t_done", "done", "value",
                 "version", "shed")

    def __init__(self, request: Request, t_arrival: float):
        self.id = next(_ticket_ids)
        self.request = request
        self.t_arrival = t_arrival
        self.t_done: Optional[float] = None
        self.done = False
        self.value = None
        self.version: Optional[Tuple[int, int]] = None
        self.shed = False     # rejected by admission control (value is None)

    def complete(self, value, now: float, version=None) -> None:
        self.value = value
        self.t_done = now
        self.version = version
        self.done = True

    def complete_shed(self, now: float) -> None:
        """Terminal reject by admission control: ``done`` (the caller's
        wait ends) with ``shed`` set and no value — a fast, explicit
        rejection the client can retry elsewhere, not a served answer."""
        self.shed = True
        self.t_done = now
        self.done = True

    @property
    def latency(self) -> Optional[float]:
        return None if self.t_done is None else self.t_done - self.t_arrival

    def __repr__(self):
        state = ("shed" if self.shed
                 else "done" if self.done else "pending")
        return (f"Ticket(#{self.id} {self.request.kind} "
                f"tenant={self.request.tenant!r} "
                f"{self.request.latency_class} {state})")
