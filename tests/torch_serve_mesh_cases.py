"""The cases of ``tests/test_torch_serve_mesh.py``: one ``ServeFrontend``
replay over ``GraphService(n_shards=S)`` through ``repro_torch``, its
tickets and the frontend's decisions as plain host values.

Without a process group the shards stack on the one device and the
frontend makes no collective (the reference); on a gloo group every rank
builds the same service and frontend, is submitted the same requests in
the same order and replays them on a clock of its own.  The module imports
torch and the port only, so the gloo ranks load it without JAX.  The trace
is ``tests/test_torch_tiered.py``'s (two tenants over all five kinds, 120
requests on 48 vertices), copied here so that no rank imports JAX; the
test holds the copy to the original.

The cases:

  * ``same``    -- every rank on rank 0's clock;
  * ``skewed``  -- rank r's clock reads ``r * SKEW_OFFSET_S`` ahead and
    runs at ``1 + r * SKEW_RATE`` times rank 0's rate;
  * ``unready`` -- rank ``UNREADY_RANK``'s service reports its shadow
    flush unready for its first ``UNREADY_POLLS`` polls;
  * ``retune``  -- ``retune_interval`` set, each rank's signal bus fed
    timings of its own (rank r's rates ``1 + r`` times rank 0's) on a host
    that shows a card a rank.

The reference runs a case as rank 0 would see it alone: its clock, and
with ``unready`` the wrapper on its only service.
"""
import dataclasses
import itertools

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import serve as tserve
from repro_torch.obs.metrics import Registry
from repro_torch.obs.signals import SignalBus
from repro_torch.serve import request as trequest
from repro_torch.stream import GraphService

WORLD = 4
SHARD_COUNTS = (2, 4, 8)
CASES = ("same", "skewed", "unready", "retune")
SKEW_OFFSET_S, SKEW_RATE = 0.7e-3, 0.1
UNREADY_RANK, UNREADY_POLLS = WORLD - 1, 3
RETUNE_INTERVAL = 0.01
# the plan's flush threshold, cut so that the trace's writes begin shadow
# flushes the steps publish (at the plan's own the read-your-writes tenant's
# flushes drain the log first, and no publish is left to agree)
FLUSH_PENDING_MAX = 16
# rank 0's fed signals; rank r's are (1 + r) times these
FED_ARRIVAL_QPS, FED_READ_LANES_PER_S = 1500.0, 4e9

# the tests/test_torch_tiered.py graph: 160 random edges over 48 vertices
NV = 48
_RNG = np.random.default_rng(7)
SRC = _RNG.integers(0, NV, 160).astype(np.int32)
DST = _RNG.integers(0, NV, 160).astype(np.int32)
KINDS = ("PointRead", "DegreeRead", "UpdateBatch", "KHopSample", "Analytics")


def trace(n=120, seed=0):
    """``tests/test_torch_tiered.py:_trace``: two tenants over point /
    degree / update / k-hop / PageRank requests; updates from vertices 0..7
    only, and a few into the rest at the end."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dt = float(rng.exponential(1 / 2000))
        tenant = "fraud" if rng.random() < 0.5 else "dashboard"
        cls = "interactive" if tenant == "fraud" else "standard"
        m = int(rng.integers(4, 17))
        k = int(rng.choice(5, p=[0.45, 0.2, 0.25, 0.07, 0.03]))
        if k == 0:
            e = rng.integers(0, len(SRC), m)
            fields = dict(qsrc=SRC[e], qdst=DST[e])
        elif k == 1:
            fields = dict(verts=rng.integers(-2, NV + 2, m).astype(np.int32))
        elif k == 2:
            hi = NV if i > n * 0.8 else 8
            fields = dict(src=rng.integers(0, hi, m).astype(np.int32),
                          dst=rng.integers(0, NV, m).astype(np.int32),
                          op=np.where(rng.random(m) < 0.2, -1, 1)
                          .astype(np.int32),
                          w=rng.random(m).astype(np.float32))
            cls = "batch"
        elif k == 3:
            fields = dict(seeds=rng.integers(0, NV, 4).astype(np.int32),
                          seed=i)
        else:
            fields = dict(name="pagerank", kw=(("max_iters", 8),))
            tenant, cls = "dashboard", "batch"
        out.append((dt, k, fields, tenant, cls))
    return out


def serve_plan(pkg):
    """The tiered test's plan through ``pkg`` (``repro.serve`` or
    ``repro_torch.serve``), its flush threshold FLUSH_PENDING_MAX."""
    plan = pkg.choose_serve_plan(2000.0, mean_lanes_per_request=12.0,
                                 log_capacity=128)
    return dataclasses.replace(plan, flush_pending_max=FLUSH_PENDING_MAX)


class SkewedClock:
    """Reads ``offset + rate * base()``."""

    def __init__(self, base, offset: float, rate: float):
        self.base, self.offset, self.rate = base, offset, rate

    def __call__(self) -> float:
        return self.offset + self.rate * self.base()


def hold_flush(svc, polls: int) -> None:
    """``svc.flush_ready()`` reports False for its first ``polls`` polls."""
    ready, seen = svc.flush_ready, [0]

    def flush_ready():
        seen[0] += 1
        return seen[0] > polls and ready()

    svc.flush_ready = flush_ready


def _plan(plan) -> tuple:
    return tuple(sorted(dataclasses.asdict(plan).items(),
                        key=lambda kv: kv[0]))


def _value(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if isinstance(v, dict):
        return {k: _value(x) for k, x in v.items()}
    return v


def run(S: int, case: str, rank: int = 0) -> dict:
    """One replay of the trace at S shards as ``rank`` sees it: every
    ticket (kind, version, value, arrival and completion times), the steps
    at which shadow flushes were published, the plans adopted at retunes
    beside the plans this rank's own signals would give, and the report."""
    # the k-hop salt reads ticket ids: number every replay's from 0, so a
    # rank and the reference draw alike
    trequest._ticket_ids = itertools.count()
    svc = GraphService.from_coo(SRC, DST, None, num_vertices=NV,
                                num_blocks=96, block_width=4,
                                log_capacity=128, n_shards=S, device="cpu")
    grouped = dist.is_initialized()
    if case == "unready" and (rank == UNREADY_RANK or not grouped):
        hold_flush(svc, UNREADY_POLLS)
    base = tserve.ManualClock()
    clock = base
    if case == "skewed":
        clock = SkewedClock(base, rank * SKEW_OFFSET_S, 1 + rank * SKEW_RATE)
    bus, kw = None, {}
    if case == "retune":
        bus = SignalBus(registry=Registry())
        kw = dict(signals=bus, retune_interval=RETUNE_INTERVAL,
                  n_replicas=WORLD)
    front = tserve.ServeFrontend(svc, serve_plan(tserve), clock=clock,
                                 fanout=(3, 2), **kw)
    front.register_tenant("fraud", read_your_writes=True)
    front.register_tenant("dashboard")
    publishes = []
    finish = svc.finish_flush

    def finish_flush():
        publishes.append(front._steps)
        return finish()

    svc.finish_flush = finish_flush
    out = {"plans": [], "local_plans": [], "plane": []}
    tickets = []
    device_count = torch.cuda.device_count
    if case == "retune" and grouped:
        torch.cuda.device_count = lambda: WORLD   # a card a rank
    try:
        for dt, k, fields, tenant, cls in trace():
            base.advance(dt)
            if bus is not None:
                bus.observe("arrival_qps", FED_ARRIVAL_QPS * (1 + rank))
                bus.observe("read_lanes_per_s",
                            FED_READ_LANES_PER_S * (1 + rank))
            tickets.append(front.submit(getattr(tserve, KINDS[k])(
                tenant=tenant, latency_class=cls, **fields)))
            before, retunes = front.plan, front._retunes
            front.step()
            if front._retunes != retunes:
                local = tserve.choose_serve_plan(
                    before.arrival_lanes_per_s / 8.0, log_capacity=128,
                    n_replicas=1, signals=bus.view(), max_replicas=1)
                out["plans"].append(_plan(front.plan))
                out["local_plans"].append(_plan(local))
                out["plane"].append(front.read_plane.n_replicas)
        front.drain(flush=True)
    finally:
        torch.cuda.device_count = device_count
    out["tickets"] = [
        (t.request.kind, t.done, t.shed, t.version, _value(t.value),
         t.t_arrival, t.t_done) for t in tickets]
    out["publishes"] = publishes
    rep = front.report()
    out["report"] = {k: rep[k] for k in ("service", "read_plane",
                                         "agreement", "completed")}
    out["replica_retunes"] = sum(
        c.value for _, c in front.metrics.collect("serve.replica_retunes"))
    out["final_plan"] = _plan(front.plan)
    return out


def run_all(rank: int = 0) -> dict:
    """Every case at every shard count: ``{(S, case): run(...)}``."""
    return {(S, case): run(S, case, rank)
            for S in SHARD_COUNTS for case in CASES}
