"""The serving loop: multi-tenant request scheduling over GraphService.

One :class:`ServeFrontend` owns the per-kind micro-batch queues
(:mod:`repro_torch.serve.batcher`), the read-your-writes overlay routing
(:mod:`repro_torch.serve.overlay`), and the interleaving of write-side work
(log admission, flush, maintenance — all inside :meth:`GraphService.flush`)
with read serving across snapshot versions.  The GastCoCo move — hide the
latency of one stream inside the batching slack of another — applied to
serving: flushes run in the dispatch windows reads are already waiting out.

Scheduling is cooperative and host-driven: :meth:`ServeFrontend.step`
dispatches everything due at ``now`` and returns; callers pump it from
their event loop (or :meth:`drain` for replay/bench workloads).  The clock
is injectable so tests and benches replay traffic on a virtual timeline.

Per step, in order:

  1. admission-**deferred** requests are re-offered as their token budgets
     refill (:mod:`repro_torch.serve.admission` — submit() already shed
     what the budget rejects outright);
  2. due **update** micro-batches are admitted into the service log
     (padded to a bucket, masked — a bounded set of shapes like every
     kind);
  3. **flush control**: an in-flight double-buffered flush is published
     when its device work is done (or write pressure recurs), and a new
     one *begins* when the pending count crosses
     ``ServePlan.flush_pending_max`` — begin drains the log and launches
     the next epoch's update, so the reads below keep serving the pinned
     snapshot while the upsert runs (the epoch advance readers eventually
     observe is a pointer swap in :meth:`_version`);
  4. the read plane re-**broadcasts** if a new snapshot was published
     (asynchronous copies per replica — :mod:`repro_torch.serve.replica`);
  5. due **point/degree read** batches *dispatch* round-robin across the
     R snapshot replicas (launched without waiting, collected at the end
     of the step with one synchronisation and host copy per batch: the
     point reads' chain walks are one ``chain_walk`` kernel launch, so a
     dispatch never blocks the host) — tenants opted into read-your-writes
     route through the pending-log overlay instead, which while a shadow
     flush is in flight spans shadow+pending (bit-identical to
     flush-then-read, still).  Any overlay dispatch first force-admits
     updates waiting in the frontend queue;
  6. due **khop / analytics** dispatch; for read-your-writes tenants these
     admit queued updates and force a full flush first (whole-graph reads
     cannot be overlaid per key, so freshness is bought with an epoch
     advance);
  7. in-flight read batches are **collected** in dispatch order — one
     synchronisation and host copy each, attributed as device time via
     ``obs.wait`` — and their tickets complete.

Every response is stamped with the ``(epoch, watermark)`` version it was
served at.
"""
from __future__ import annotations

import collections
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core.tuner import ServePlan, choose_serve_plan
from repro_torch.obs.metrics import LATENCY_BUCKETS_S, Registry
from repro_torch.serve import overlay as ov
from repro_torch.serve.admission import DEFER, SHED, AdmissionController
from repro_torch.serve.batcher import JitShapeStat, KindQueue, MicroBatch
from repro_torch.serve.replica import ReadPlane, to_device
from repro_torch.serve.request import Request, Ticket
from repro_torch.stream import snapshot as snap
from repro_torch.stream.service import GraphService


class ManualClock:
    """Deterministic virtual clock for tests and trace replay."""

    def __init__(self, t0: float = 0.0):
        self.t = float(t0)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


class TenantConfig:
    def __init__(self, read_your_writes: bool = False,
                 budget_lanes_per_s: Optional[float] = None,
                 budget_burst_lanes: Optional[int] = None):
        self.read_your_writes = bool(read_your_writes)
        # None -> the plan's default budget applies; <= 0 -> admission off
        # for this tenant
        self.budget_lanes_per_s = budget_lanes_per_s
        self.budget_burst_lanes = budget_burst_lanes


class _Partial:
    """Accumulator for a ticket split across micro-batches."""

    __slots__ = ("served", "bufs", "parts")

    def __init__(self):
        self.served = 0
        self.bufs: Dict[str, np.ndarray] = {}
        self.parts: List = []


def _fetch(arrs: tuple) -> tuple:
    """Host numpy copies of a batch's result tensors: the copies are
    queued together and waited for once."""
    outs = [a.to("cpu", non_blocking=True) for a in arrs]
    for dev in {a.device for a in arrs if a.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    return tuple(o.numpy() for o in outs)


class ServeFrontend:
    """Batched multi-tenant request frontend over a :class:`GraphService`."""

    def __init__(self, service: GraphService, plan: Optional[ServePlan] = None,
                 *, fanout: Tuple[int, ...] = (15, 10), clock=None,
                 freshness_flush: bool = True,
                 n_replicas: Optional[int] = None,
                 signals=None, slo=None,
                 retune_interval: Optional[float] = None):
        """``signals=`` attaches a :class:`repro_torch.obs.SignalBus`: every
        step ticks the dispatch-cadence signals (arrival QPS, read lanes/s, read
        pressure per replica), and with ``retune_interval=T`` seconds the
        frontend periodically re-runs :func:`choose_serve_plan` over the
        measured signals and resizes the read plane to the adapted
        ``n_replicas`` (the measured-read-pressure loop).  Existing queues
        keep their bucket ladders (batch shapes stay bounded); the replica
        resize takes effect immediately.

        ``slo=`` attaches a :class:`repro_torch.obs.SloTracker`: every
        completion
        (and shed) is scored against its ``(tenant, class)`` objective,
        breaches emit edge-triggered ``slo.breach`` decisions, and
        batch-class submissions are shed while any interactive objective
        burns its error budget faster than the tracker's threshold."""
        self.service = service
        self.plan = plan or choose_serve_plan(
            100.0, log_capacity=service._log.capacity,
            high_watermark=service._high_watermark)
        self.fanout = tuple(fanout)
        self.clock = clock if clock is not None else time.monotonic
        self.freshness_flush = bool(freshness_flush)
        self.tenants: Dict[str, TenantConfig] = {"default": TenantConfig()}
        # queue key: (kind, overlay?) — overlay and plain variants compile
        # the same bucket shapes but run different fused functions
        self._queues: Dict[Tuple[str, bool], KindQueue] = {}
        self._partials: Dict[int, _Partial] = {}
        self.shapes = JitShapeStat()
        # snapshot fan-out: R replicas of the pinned snapshot, round-robin
        # read dispatch (n_replicas kwarg overrides the plan's)
        self.read_plane = ReadPlane(
            service.snapshot,
            self.plan.n_replicas if n_replicas is None else n_replicas)
        # dispatched-but-uncollected read mega-batches, in dispatch order:
        # (micro-batch, device tensors, version stamp)
        self._inflight: List[Tuple[MicroBatch, tuple, Tuple[int, int]]] = []
        # per-(tenant, class) token buckets; submit() sheds or defers
        self.admission = AdmissionController(
            default_rate=self.plan.budget_lanes_per_s,
            default_burst=self.plan.budget_burst_lanes)
        self._deferred: collections.deque = collections.deque()
        # serving statistics live on a repro_torch.obs metrics registry: the
        # global one when observability is on (so obs.report() carries the
        # QPS/p50/p99/occupancy series), a private always-on one otherwise
        # (the frontend has always collected these — report() must work
        # regardless of the global switch)
        self.metrics: Registry = (obs.registry() if obs.enabled()
                                  else Registry())
        self._tenant_span: Dict[str, List[float]] = {}  # [first_arr, last_done]
        self._completed = 0
        self._interleaved_flushes = 0
        self._version_cache: Optional[Tuple] = None
        self.signals = signals
        self.slo = slo
        self._retune_interval = (None if retune_interval is None
                                 else float(retune_interval))
        self._last_retune: Optional[float] = None
        self._retunes = 0

    # ---- tenancy ----------------------------------------------------------

    def register_tenant(self, name: str, read_your_writes: bool = False,
                        budget_lanes_per_s: Optional[float] = None,
                        budget_burst_lanes: Optional[int] = None
                        ) -> TenantConfig:
        """Register (or reconfigure) a tenant.  ``budget_lanes_per_s``
        overrides the plan's default admission budget for this tenant
        (0 or negative disables admission for it; None keeps the plan's)."""
        cfg = TenantConfig(read_your_writes, budget_lanes_per_s,
                           budget_burst_lanes)
        self.tenants[name] = cfg
        if budget_lanes_per_s is not None:
            burst = (budget_burst_lanes if budget_burst_lanes is not None
                     else max(int(budget_lanes_per_s), 1))
            self.admission.set_budget(name, budget_lanes_per_s, burst)
        return cfg

    def _overlay_for(self, req: Request) -> bool:
        cfg = self.tenants.get(req.tenant)
        return bool(cfg and cfg.read_your_writes)

    # ---- submission -------------------------------------------------------

    def _queue(self, kind: str, use_overlay: bool) -> KindQueue:
        key = (kind, use_overlay)
        if key not in self._queues:
            self._queues[key] = KindQueue(kind, self.plan.bucket_set,
                                          self.plan.windows)
        return self._queues[key]

    def submit(self, req: Request) -> Ticket:
        """Offer a request: admission-checked, then queued for batching.

        The returned ticket is always live — check ``ticket.shed`` before
        ``ticket.value``: a shed ticket completed immediately with no value
        (the tenant's ``(tenant, latency_class)`` token budget was
        exhausted and the class is latency-bound).  Batch-class requests
        over budget are *deferred* instead: parked until tokens refill,
        then queued with a fresh dispatch window.
        """
        if req.tenant not in self.tenants:
            self.register_tenant(req.tenant)
        now = float(self.clock())
        ticket = Ticket(req, t_arrival=now)
        span = self._tenant_span.setdefault(req.tenant, [now, now])
        span[0] = min(span[0], now)
        self.metrics.counter("serve.submitted", tenant=req.tenant,
                             cls=req.latency_class).inc()
        # SLO-driven load shedding runs BEFORE token admission (a shed here
        # must not consume the tenant's budget): while any interactive
        # objective burns its error budget too fast, batch-class load — the
        # cheapest to retry — is dropped before interactive p99 burns
        if self.slo is not None and req.latency_class == "batch" \
                and self.slo.should_shed_batch():
            ticket.complete_shed(now)
            self.metrics.counter("serve.shed", tenant=req.tenant,
                                 cls=req.latency_class).inc()
            self.metrics.counter("serve.slo_shed", tenant=req.tenant,
                                 cls=req.latency_class).inc()
            obs.instant("serve.slo_shed", cat="serve", tenant=req.tenant,
                        cls=req.latency_class, lanes=req.size)
            self._slo_observe(req, shed=True)
            return ticket
        verdict = self.admission.admit(req.tenant, req.latency_class,
                                       req.size, now)
        if verdict == SHED:
            ticket.complete_shed(now)
            self.metrics.counter("serve.shed", tenant=req.tenant,
                                 cls=req.latency_class).inc()
            self.metrics.counter("serve.shed_lanes", tenant=req.tenant,
                                 cls=req.latency_class).inc(req.size)
            obs.instant("serve.shed", cat="serve", tenant=req.tenant,
                        cls=req.latency_class, lanes=req.size)
            self._slo_observe(req, shed=True)
            return ticket
        if verdict == DEFER:
            self.admission.on_defer(req.tenant, req.latency_class, req.size)
            self.metrics.counter("serve.deferred", tenant=req.tenant,
                                 cls=req.latency_class).inc()
            self._deferred.append(ticket)
            return ticket
        self._enqueue(ticket)
        return ticket

    def _enqueue(self, ticket: Ticket,
                 deadline: Optional[float] = None) -> None:
        req = ticket.request
        use_overlay = (req.kind in ("point_read", "degree_read", "khop")
                       and self._overlay_for(req))
        self._queue(req.kind, use_overlay).put(ticket, deadline)

    def _readmit_deferred(self, now: float) -> None:
        """Re-offer parked batch-class requests as their budgets refill
        (FIFO per arrival; a re-admitted ticket gets a fresh dispatch
        window — its latency still accrues from true arrival)."""
        if not self._deferred:
            return
        still: collections.deque = collections.deque()
        while self._deferred:
            ticket = self._deferred.popleft()
            req = ticket.request
            if self.admission.try_readmit(req.tenant, req.latency_class,
                                          req.size, now):
                self.admission.on_undefer(req.tenant, req.latency_class,
                                          req.size)
                self._enqueue(ticket,
                              deadline=now
                              + self._queue_window(req.latency_class))
            else:
                still.append(ticket)
        self._deferred = still

    def _queue_window(self, latency_class: str) -> float:
        return self.plan.windows[latency_class]

    # ---- the serving loop -------------------------------------------------

    def step(self, now: Optional[float] = None) -> int:
        """Dispatch everything due at ``now``; returns completions."""
        now = float(self.clock()) if now is None else float(now)
        done0 = self._completed

        # 1. re-offer admission-deferred requests (budgets refill with time)
        self._readmit_deferred(now)

        # 2. write-side: admit due update batches
        self._pump((("update", False),), now)

        # 3. flush control: publish an in-flight double-buffered flush when
        #    its device work is done (or pressure recurs), then begin a new
        #    one under write pressure — begin defers the publish, so the
        #    reads below still serve the pinned epoch and never block on
        #    the upsert
        pressure = (self.service.pending_updates
                    >= self.plan.flush_pending_max)
        if self.service.flush_in_flight and (pressure
                                             or self.service.flush_ready()):
            self._finish_flush()
        if pressure:
            if self.plan.double_buffer:
                self._begin_flush()
            else:
                self._flush()

        # 4. mirror a newly published snapshot across the read replicas
        self.read_plane.broadcast(self.service.snapshot)

        # 5. point/degree serving (overlay variants read the pending log;
        #    plain variants fan out over the replicas, collected in 7.)
        self._pump((("point_read", False), ("degree_read", False),
                    ("point_read", True), ("degree_read", True)), now)

        # 6. whole-graph reads (khop + analytics)
        self._pump((("khop", False), ("khop", True),
                    ("analytics", False), ("analytics", True)), now)

        # 7. collect every read dispatched this step (one host copy per
        #    mega-batch) and complete the tickets
        self._collect(now)

        # 8. signal derivation + periodic retune: tick the dispatch-cadence
        #    signals, then (on the retune interval) re-plan from measured
        #    pressure and resize the read plane
        if self.signals is not None:
            self.signals.tick_dispatch(now,
                                       n_replicas=self.read_plane.n_replicas)
            if self._retune_interval is not None:
                if self._last_retune is None:
                    self._last_retune = now
                elif now - self._last_retune >= self._retune_interval:
                    self.retune(now)
        return self._completed - done0

    def drain(self, flush: bool = False) -> int:
        """Pump steps at each next deadline until every queue is empty.

        Steps at the *earliest* pending deadline each round so recorded
        latencies keep their deadline order (stepping at the latest would
        complete an interactive read with a batch-window timestamp).
        Admission-deferred requests contribute their token-refill ETA as a
        deadline, so a drain meters virtual time through budget waits too.
        """
        done0 = self._completed
        now = float(self.clock())
        while any(len(q) for q in self._queues.values()) or self._deferred \
                or self._inflight:
            # virtual time is monotone across rounds: budget refills meter
            # against the last *stepped* time, not the (possibly frozen)
            # wall clock — else a parked request's retry ETA never arrives
            now = max(now, float(self.clock()))
            deadlines = [q.next_deadline() for q in self._queues.values()
                         if len(q)]
            deadlines += [
                self.admission.retry_eta(t.request.tenant,
                                         t.request.latency_class,
                                         t.request.size, now)
                for t in self._deferred]
            now = max(now, min(deadlines)) if deadlines else now
            self.step(now)
        if flush:
            self._flush()
        return self._completed - done0

    def retune(self, now: Optional[float] = None) -> ServePlan:
        """Re-run :func:`choose_serve_plan` over the measured signals and
        adopt the adapted plan: the read plane is rebuilt when the measured
        read pressure calls for a different ``n_replicas`` (the decision
        log records the firing signal values).  Existing kind queues keep
        their bucket ladders — the batch shapes must stay bounded — so the
        ladder/window parts of the new plan apply to queues created later.
        """
        now = float(self.clock()) if now is None else float(now)
        self._last_retune = now
        view = self.signals.view() if self.signals is not None else None
        new_plan = choose_serve_plan(
            self.plan.arrival_lanes_per_s / 8.0,
            log_capacity=self.service._log.capacity,
            high_watermark=self.service._high_watermark,
            n_replicas=self.read_plane.n_replicas,
            signals=view)
        if new_plan.n_replicas != self.read_plane.n_replicas:
            self.read_plane = ReadPlane(self.service.snapshot,
                                        new_plan.n_replicas)
            self.metrics.counter("serve.replica_retunes").inc()
        self._retunes += 1
        self.metrics.counter("serve.retunes").inc()
        self.plan = new_plan
        return new_plan

    def _pump(self, keys, now: float) -> None:
        for key in keys:
            q = self._queues.get(key)
            while q is not None and q.due(now):
                self._dispatch(q.take(), overlay=key[1], now=now)

    def _flush(self) -> None:
        """Synchronous flush: publish any in-flight shadow epoch AND drain
        whatever the log holds (the freshness path — RYW khop/analytics
        buy their consistency with a full epoch advance)."""
        if self.service.flush_in_flight or self.service.pending_updates > 0:
            with obs.span("serve.flush", cat="serve",
                          pending=self.service.pending_updates):
                self.service.flush()
            self._interleaved_flushes += 1
            self.metrics.counter("serve.interleaved_flushes").inc()

    def _begin_flush(self) -> None:
        with obs.span("serve.flush_begin", cat="serve",
                      pending=self.service.pending_updates):
            self.service.begin_flush()
        self.metrics.counter("serve.flush_begins").inc()

    def _finish_flush(self) -> None:
        with obs.span("serve.flush_publish", cat="serve"):
            self.service.finish_flush()
        self._interleaved_flushes += 1
        self.metrics.counter("serve.interleaved_flushes").inc()

    def _admit_queued_updates(self, now: float) -> None:
        """Force-admit every update still waiting in the frontend queue.

        Read-your-writes covers *admitted* records (the log's pending
        window), so an overlay read dispatching ahead of a slower update
        window must not leave that tenant's writes sitting in the queue —
        admission is pulled forward, the updates' own dispatch windows only
        bound how long they wait when nobody is reading.
        """
        q = self._queues.get(("update", False))
        while q is not None and len(q):
            self._dispatch(q.take(), overlay=False, now=now)

    def _version(self) -> Tuple[int, int]:
        """The current snapshot's concrete (epoch, watermark), cached per
        snapshot object — dispatch stamps must not pay a blocking device
        read per micro-batch."""
        snapshot = self.service.snapshot
        if self._version_cache is None or self._version_cache[0] is not snapshot:
            self._version_cache = (snapshot, snapshot.version)
        return self._version_cache[1]

    # ---- dispatch ---------------------------------------------------------

    def _dispatch(self, mb: MicroBatch, overlay: bool, now: float) -> None:
        if overlay:
            self._admit_queued_updates(now)    # read-your-writes: the overlay
                                               # only sees admitted records
        if mb.kind == "analytics":
            self._run_analytics(mb, overlay, now)
            return
        self.shapes.record(mb.kind, mb.bucket)
        self.metrics.series("serve.occupancy", kind=mb.kind).observe(
            mb.occupancy)
        self.metrics.counter("serve.dispatches", kind=mb.kind).inc()
        if mb.kind in ("point_read", "degree_read", "khop"):
            # read pressure source: lanes dispatched toward the read plane
            # (the signal bus derives read_lanes_per_s / read_pressure)
            self.metrics.counter("serve.read_lanes", kind=mb.kind).inc(
                mb.lanes)
        with obs.span("serve.dispatch", cat="serve", kind=mb.kind,
                      bucket=mb.bucket, lanes=mb.lanes, overlay=overlay):
            if mb.kind == "update":
                self._run_update(mb, now)
            elif mb.kind == "point_read":
                self._run_point(mb, overlay, now)
            elif mb.kind == "degree_read":
                self._run_degree(mb, overlay, now)
            elif mb.kind == "khop":
                self._run_khop(mb, overlay, now)
            else:                                      # pragma: no cover
                raise ValueError(f"unknown request kind {mb.kind!r}")

    def _fuse(self, mb: MicroBatch, field, fill, dtype) -> np.ndarray:
        out = np.full((mb.bucket,), fill, dtype)
        for ticket, (off, req_off, width) in zip(mb.tickets, mb.spans):
            arr = field(ticket.request)
            if arr is not None:
                out[off:off + width] = arr[req_off:req_off + width]
        return out

    def _valid_mask(self, mb: MicroBatch) -> np.ndarray:
        m = np.zeros((mb.bucket,), bool)
        m[:mb.lanes] = True
        return m

    # -- per-kind executors --

    def _run_update(self, mb: MicroBatch, now: float) -> None:
        src = self._fuse(mb, lambda r: r.src, 0, np.int32)
        dst = self._fuse(mb, lambda r: r.dst, 0, np.int32)
        w = self._fuse(mb, lambda r: r.w, 1.0, np.float32)
        op = self._fuse(mb, lambda r: r.op, 1, np.int32)       # INSERT
        receipt = self.service.apply(src, dst, w, op,
                                     valid=self._valid_mask(mb))
        if not bool(receipt.admitted):
            # the service's own flush-and-retry is bypassed under
            # auto_flush=False — the frontend owns flush scheduling, so it
            # retries once itself rather than completing tickets for writes
            # that were never admitted
            self._flush()
            receipt = self.service.apply(src, dst, w, op,
                                         valid=self._valid_mask(mb))
            if not bool(receipt.admitted):
                raise RuntimeError(
                    f"update mega-batch of {mb.lanes} lanes rejected by an "
                    "empty log — bucket ladder exceeds the admission gate "
                    "(see choose_serve_plan's high_watermark clamp)")
        version = self._version()
        for ticket, (off, req_off, width) in zip(mb.tickets, mb.spans):
            self._offer(ticket, "receipts", receipt, width, now, version)

    def _run_point(self, mb: MicroBatch, overlay: bool, now: float) -> None:
        qs = self._fuse(mb, lambda r: r.qsrc, 0, np.int32)
        qd = self._fuse(mb, lambda r: r.qdst, 0, np.int32)
        if overlay:
            dev = self.service.device
            arrs = ov.overlay_point_reads(self.service.snapshot,
                                          self.service.pending_view(),
                                          to_device(qs, dev),
                                          to_device(qd, dev))
            version = self._version()
        else:
            replica, arrs = self.read_plane.query_edges(qs, qd)
            version = self.read_plane.version
            self.metrics.counter("serve.replica_dispatch",
                                 replica=str(replica)).inc()
        self._inflight.append((mb, tuple(arrs), version))

    def _run_degree(self, mb: MicroBatch, overlay: bool, now: float) -> None:
        verts = self._fuse(mb, lambda r: r.verts, 0, np.int32)
        if overlay:
            arrs = (ov.overlay_degrees(self.service.snapshot,
                                       self.service.pending_view(),
                                       to_device(verts, self.service.device)),)
            version = self._version()
        else:
            replica, arrs = self.read_plane.query_degrees(verts)
            version = self.read_plane.version
            self.metrics.counter("serve.replica_dispatch",
                                 replica=str(replica)).inc()
        self._inflight.append((mb, tuple(arrs), version))

    def _run_khop(self, mb: MicroBatch, overlay: bool, now: float) -> None:
        # read-your-writes for a whole-neighborhood read = flush first: the
        # per-key overlay cannot patch a sampled subgraph
        if overlay and self.freshness_flush:
            self._flush()
            self.read_plane.broadcast(self.service.snapshot)
        seeds = self._fuse(mb, lambda r: r.seeds, 0, np.int32)
        salt = 0
        for t in mb.tickets:
            salt = (salt * 1000003 + int(t.request.seed) + t.id) & 0x7FFFFFFF
        if overlay:
            dev = self.service.device
            gen = torch.Generator(device=dev).manual_seed(salt)
            sg = tuple(snap.sample_khop(self.service.snapshot,
                                        to_device(seeds, dev), gen,
                                        self.fanout))
            version = self._version()
        else:
            replica, sg = self.read_plane.sample_khop(seeds, salt,
                                                      self.fanout)
            version = self.read_plane.version
            self.metrics.counter("serve.replica_dispatch",
                                 replica=str(replica)).inc()
        self._inflight.append((mb, sg, version))

    # -- pipelined collection: dispatched read batches -> completed tickets

    def _collect(self, now: float) -> None:
        """Sync each in-flight read mega-batch (dispatch order) and complete
        its tickets: ONE synchronisation and host copy per batch,
        attributed as device time via ``obs.wait`` — not one host sync per
        result field."""
        while self._inflight:
            mb, arrs, version = self._inflight.pop(0)
            vals = _fetch(obs.wait(arrs, "serve.read.sync", kind=mb.kind))
            if mb.kind == "point_read":
                found, w = vals
                for ticket, (off, req_off, width) in zip(mb.tickets, mb.spans):
                    self._offer(ticket, ("found", "w"),
                                (found[off:off + width], w[off:off + width]),
                                width, now, version, req_off=req_off)
            elif mb.kind == "degree_read":
                deg = vals[0]
                for ticket, (off, req_off, width) in zip(mb.tickets, mb.spans):
                    self._offer(ticket, ("deg",), (deg[off:off + width],),
                                width, now, version, req_off=req_off)
            else:
                self._complete_khop(mb, vals, now, version)

    def _complete_khop(self, mb: MicroBatch, sg_np, now: float,
                       version) -> None:
        # per-hop layout: seed lane i owns edge lanes [i*P_h, (i+1)*P_h)
        # inside hop h's segment, where P_h = prod(fanout[:h+1])
        hop_off, hop_P = [], []
        off_acc = 0
        P = 1
        for k in self.fanout:
            P *= k
            hop_off.append(off_acc)
            hop_P.append(P)
            off_acc += mb.bucket * P
        for ticket, (off, req_off, width) in zip(mb.tickets, mb.spans):
            idx = np.concatenate([
                np.arange(ho + off * P, ho + (off + width) * P)
                for ho, P in zip(hop_off, hop_P)])
            part = {"src": sg_np[0][idx], "dst": sg_np[1][idx],
                    "layer": sg_np[2][idx], "valid": sg_np[3][idx],
                    "seeds": ticket.request.seeds[req_off:req_off + width]}
            self._offer(ticket, "khop_parts", part, width, now, version)

    def _run_analytics(self, mb: MicroBatch, overlay: bool, now: float
                       ) -> None:
        for ticket in mb.tickets:
            req = ticket.request
            if self._overlay_for(req) and self.freshness_flush:
                self._admit_queued_updates(now)
                self._flush()
            out = self.service.analytics(req.name, source=req.source,
                                         **dict(req.kw))
            ticket.complete(out, now, self._version())
            self._record_done(ticket, now)

    # ---- completion / reassembly ------------------------------------------

    def _offer(self, ticket: Ticket, fields, values, width: int, now: float,
               version, req_off: int = 0) -> None:
        """Credit ``width`` served lanes to ``ticket``; complete when full."""
        total = ticket.request.size
        if width == total and ticket.id not in self._partials:
            value = self._finalize(ticket, fields, values)
            ticket.complete(value, now, version)
            self._record_done(ticket, now)
            return
        part = self._partials.setdefault(ticket.id, _Partial())
        if isinstance(fields, tuple):            # array results: fill buffers
            for name, arr in zip(fields, values):
                buf = part.bufs.get(name)
                if buf is None:
                    buf = part.bufs[name] = np.zeros((total,), arr.dtype)
                buf[req_off:req_off + width] = arr
        else:                                    # object results: collect
            part.parts.append(values)
        part.served += width
        if part.served >= total:
            del self._partials[ticket.id]
            value = self._finalize(ticket, fields, part)
            ticket.complete(value, now, version)
            self._record_done(ticket, now)

    @staticmethod
    def _receipt_value(receipts) -> dict:
        """Aggregate the covering mega-batch receipts (attribution is per
        batch, not per ticket — counts include co-batched requests)."""
        return {"admitted": all(bool(r.admitted) for r in receipts),
                "appended": sum(int(r.appended) for r in receipts),
                "coalesced": sum(int(r.coalesced) for r in receipts)}

    def _finalize(self, ticket: Ticket, fields, payload):
        kind = ticket.request.kind
        if isinstance(payload, _Partial):
            if kind == "update":
                return self._receipt_value(payload.parts)
            if kind == "khop":
                return {k: np.concatenate([p[k] for p in payload.parts])
                        for k in payload.parts[0]}
            vals = tuple(payload.bufs[name] for name in fields)
        else:
            if kind == "update":
                return self._receipt_value([payload])
            if kind == "khop":
                return payload
            vals = payload
        if kind == "point_read":
            return {"found": vals[0], "w": vals[1]}
        return {"deg": vals[0]}

    def _record_done(self, ticket: Ticket, now: float) -> None:
        self._completed += 1
        req = ticket.request
        self.metrics.series("serve.latency_s", tenant=req.tenant,
                            cls=req.latency_class).observe(ticket.latency)
        self.metrics.histogram("serve.latency_hist_s", LATENCY_BUCKETS_S,
                               cls=req.latency_class).observe(ticket.latency)
        self.metrics.counter("serve.completed", tenant=req.tenant).inc()
        span = self._tenant_span.setdefault(req.tenant, [ticket.t_arrival, now])
        span[1] = max(span[1], now)
        self._slo_observe(req, latency_s=ticket.latency)

    def _slo_observe(self, req: Request, latency_s: Optional[float] = None,
                     shed: bool = False) -> None:
        """Score one outcome against its SLO objective; a crossing into
        breach emits the edge-triggered ``slo.breach`` event (structured
        decision + counter)."""
        if self.slo is None:
            return
        breach = self.slo.observe(req.tenant, req.latency_class,
                                  latency_s=latency_s, shed=shed)
        if breach is not None:
            self.metrics.counter("slo.breach", tenant=req.tenant,
                                 cls=req.latency_class).inc()
            obs.decision("slo.breach", **breach)

    # ---- stats ------------------------------------------------------------

    def report(self) -> dict:
        """Per-tenant / per-class / per-kind serving statistics.

        Computed off the shared :mod:`repro_torch.obs` metrics registry (the
        ``serve.latency_s`` / ``serve.occupancy`` series), so when
        observability is on the same numbers appear in ``obs.report()``.
        Percentiles carry their sample count ``n`` and are *omitted* below
        the minimum meaningful count (p50 needs 2 samples, p99 needs 100 —
        a p99 over a dozen latencies is a noisy max, not a tail).
        """
        tenants: Dict[str, dict] = {}
        for labels, s in self.metrics.collect("serve.latency_s"):
            tenant, cls = labels["tenant"], labels["cls"]
            t = tenants.setdefault(tenant, {"requests": 0, "by_class": {}})
            summ = s.summary(pcts=(50, 99))
            t["requests"] += summ["n"]
            entry = {"count": summ["n"], "n": summ["n"]}
            if "p50" in summ:
                entry["p50_ms"] = summ["p50"] * 1e3
            if "p99" in summ:
                entry["p99_ms"] = summ["p99"] * 1e3
            t["by_class"][cls] = entry
        for tenant, t in tenants.items():
            a0, a1 = self._tenant_span.get(tenant, (0.0, 0.0))
            t["qps"] = t["requests"] / (a1 - a0) if a1 > a0 else float("inf")
        kinds = {}
        shape_rep = self.shapes.report()
        for labels, s in self.metrics.collect("serve.occupancy"):
            kind = labels["kind"]
            kinds[kind] = {
                "dispatches": s.count,
                "mean_occupancy": s.sum / s.count if s.count else 0.0,
                **shape_rep.get(kind, {"jit_cache_size": 0, "buckets": []}),
            }
        svc = self.service.stats

        def _by_labels(name: str) -> Dict[str, float]:
            return {f"{lbl['tenant']}/{lbl['cls']}": c.value
                    for lbl, c in self.metrics.collect(name)}

        replica_dispatches = {lbl["replica"]: int(c.value)
                              for lbl, c in
                              self.metrics.collect("serve.replica_dispatch")}
        return {
            "tenants": tenants,
            "kinds": kinds,
            "completed": self._completed,
            "admission": {
                "submitted": _by_labels("serve.submitted"),
                "shed": _by_labels("serve.shed"),
                "shed_lanes": _by_labels("serve.shed_lanes"),
                "deferred": _by_labels("serve.deferred"),
                "deferred_waiting": len(self._deferred),
            },
            "read_plane": {
                "n_replicas": self.read_plane.n_replicas,
                "dispatches_by_replica": replica_dispatches,
                "retunes": self._retunes,
            },
            "service": {"epoch": self.service.epoch,
                        "flushes": svc.flushes,
                        "interleaved_flushes": self._interleaved_flushes,
                        "flush_in_flight": self.service.flush_in_flight,
                        "pending_updates": self.service.pending_updates},
            "slo": self.slo.summary() if self.slo is not None else {},
            "signals": (self.signals.report()
                        if self.signals is not None else {}),
        }
