"""GraphService — the versioned dynamic-graph serving facade, in torch.

One object owns update admission, snapshot versioning, maintenance
scheduling and incremental analytics over one CBList, over a
:class:`~repro_torch.distributed.graph.ShardedCBList` (``n_shards=S``: S
GTChain-balanced shards, stacked on the one device or, when a process
group is up, laid over its ranks by ``shard_mesh(S)``), or over a
:class:`~repro_torch.core.tiered.TieredGraph` of either
(``seal_after_epochs=K``):

    service = GraphService.from_coo(src, dst, w, num_vertices=nv)
    service.apply(us, ud, uw, op)          # -> update log (coalesced)
    service.flush()                        # -> new snapshot epoch
    found, w = service.query_edges(qs, qd) # consistent snapshot reads
    ranks = service.analytics("pagerank")  # warm-started incrementally

``flush`` drains the log, re-coalesces across append batches (the last op
per key wins), frames the result as a delete phase plus an insert phase
(upsert: no parallel edges) and applies one BatchUpdate.  The
``dropped_edges`` overflow counter triggers a capacity grow and an exact
retry on the pre-update storage; the maintenance policy then schedules
compact/rebuild/grow, and on tiered storage seals the vertices unwritten
for K flushes.  Analytics dispatch through the program registry with
per-epoch caching and warm starts gated by each program's
``warm_validity``; :meth:`GraphService.register_program` opens
user-defined workloads to the same loop.  Under :mod:`repro_torch.obs` a
flush is broken into phase spans (admission, coalesce, upsert, grow
retries, maintenance) with matching counters.

On a process group every rank runs one service over the same calls: the
log, the snapshot's epoch and watermark and every flush report are
replicated, each rank's storage holds its own shards, and the flush's
decisions read reduced values (the update stats, the reads of the delete
keys, the maintenance statistics), so the ranks make the same
collectives in the same order.  :meth:`GraphService.flush_ready` reads the
rank's own device and may differ between ranks; callers on a group publish
a shadow flush at points they agree on.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.backend import resolve_device
from repro_torch.core.blockstore import I32
from repro_torch.core.cblist import CBList, blocks_needed, build_from_coo
from repro_torch.core.program import (VertexProgram, get_program,
                                      has_program, run_program)
from repro_torch.core.tiered import TieredGraph
from repro_torch.core.tuner import (SystemProbe, choose_engine_impl,
                                    choose_plan)
from repro_torch.core.updates import (DELETE, INSERT, NOP, UpdateStats,
                                      batch_update_stats, read_edges)
from repro_torch.graph import algorithms as _builtin_programs  # noqa: F401 — registers the built-in programs
from repro_torch.stream import log as ulog
from repro_torch.stream import maintenance as maint
from repro_torch.stream import snapshot as snap
from repro_torch.stream.log import LogReceipt, PendingView, UpdateLog
from repro_torch.stream.maintenance import MaintenanceAction, MaintenancePolicy
from repro_torch.stream.snapshot import Snapshot

MAX_GROW_RETRIES = 6


def _pad_warm(warm: torch.Tensor, capacity: int, fill) -> torch.Tensor:
    """Pad a cached fixpoint to the post-grow vertex capacity with the
    program's "unknown" lattice element (axis 0 is the vertex axis)."""
    if warm.dim() == 0 or warm.shape[0] >= capacity:
        return warm
    pad = torch.full((capacity - warm.shape[0],) + tuple(warm.shape[1:]),
                     fill, dtype=warm.dtype, device=warm.device)
    return torch.cat([warm, pad])


def _kw_match(a: dict, b: dict) -> bool:
    """Cache-parameter equality that tolerates tensor-valued parameters."""
    if a.keys() != b.keys():
        return False
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, (torch.Tensor, np.ndarray)) or \
                isinstance(vb, (torch.Tensor, np.ndarray)):
            if not np.array_equal(_host(va), _host(vb)):
                return False
        elif va != vb:
            return False
    return True


def _host(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _receipt_counts(receipt: LogReceipt) -> Tuple[bool, int, int]:
    """(admitted, appended, coalesced) of a log receipt in one host read."""
    admitted, appended, coalesced = torch.stack(
        [receipt.admitted.to(I32), receipt.appended,
         receipt.coalesced]).tolist()
    return bool(admitted), int(appended), int(coalesced)


class FlushReport(NamedTuple):
    epoch: int                    # snapshot epoch after the flush
    watermark: int                # log sequence applied through
    applied_inserts: int
    applied_deletes: int
    grow_retries: int             # reactive grows forced by dropped_edges
    maintenance: MaintenanceAction


@dataclasses.dataclass
class _ShadowFlush:
    """In-flight flush: what :meth:`GraphService.begin_flush` dispatched
    and :meth:`GraphService.finish_flush` still needs (``pre_cbl`` is the
    pre-update storage the grow-retry replays onto)."""
    records: Tuple[torch.Tensor, ...]
    watermark: int
    pre_cbl: CBList
    new_cbl: CBList
    ustats: UpdateStats
    batch: Tuple[torch.Tensor, ...]       # (src2, dst2, w2, op2)
    net_deletes: int
    done: Optional[torch.cuda.Event]      # recorded after the upsert's launch
    sealed_before: Optional[torch.Tensor]  # tiered: sealed mask pre-update


@dataclasses.dataclass
class ServiceStats:
    admitted: int = 0             # records admitted into the log
    coalesced: int = 0            # records cancelled at admission
    rejected_batches: int = 0     # whole-batch backpressure rejections
    flushes: int = 0
    applied_inserts: int = 0
    applied_deletes: int = 0
    dropped_retries: int = 0      # overflow-triggered grow+retry cycles
    grows: int = 0
    compacts: int = 0
    rebuilds: int = 0
    seals: int = 0                # cold-vertex seal repartitions (tiered)
    unseals: int = 0              # vertices written back into the delta


def _num_blocks(cbl) -> int:
    """Delta block capacity, per shard when sharded (the grow target unit);
    a TieredGraph reports its delta's (grow only ever targets the mutable
    tier)."""
    return cbl.store.num_blocks if isinstance(cbl, CBList) else cbl.num_blocks


class GraphService:
    """Facade over log + snapshot + maintenance + incremental analytics for
    one CBList, shard stack or TieredGraph.  Host-side orchestrator: every
    decision that needs concrete statistics runs between device steps."""

    def __init__(self, cbl: CBList, *, log_capacity: int = 4096,
                 high_watermark: float = 0.75,
                 policy: MaintenancePolicy = MaintenancePolicy(),
                 probe: Optional[SystemProbe] = None,
                 auto_flush: bool = True, n_shards: int = 1,
                 seal_after_epochs: Optional[int] = None, signals=None):
        """``n_shards > 1`` splits the storage into GTChain-balanced shards
        (:func:`repro_torch.distributed.graph.shard_cbl`), placed by
        :func:`~repro_torch.distributed.graph.shard_mesh`: stacked on the
        one device without a process group, or each rank of the group
        holding its block of them (``cbl`` is then the same on every rank,
        as the JAX package's comes from ``jax.devices()``).  Flushes route
        updates to the shard that owns their source, maintenance runs per
        shard, and analytics sweeps run on every shard and reduce along the
        shard axis and across the ranks.  A ``ShardedCBList`` is taken as
        it is; one sharded another number of ways is refused.

        ``seal_after_epochs=K`` turns on tiered storage: the CBList (or the
        shard stack) becomes the hot delta of a
        :class:`~repro_torch.core.tiered.TieredGraph`, and maintenance
        seals vertices unwritten for K flushes into the immutable CSR run;
        a write touching a sealed vertex unseals it.

        ``probe=`` is the :class:`~repro_torch.core.tuner.SystemProbe`
        :meth:`plan` reads (the card's constants by default).

        ``signals=`` attaches a :class:`repro_torch.obs.SignalBus`: every
        flush ticks it after its counters land, and the post-flush
        maintenance decision runs under the churn-adapted policy
        (:meth:`MaintenancePolicy.adapted`)."""
        from repro_torch.core.tiered import tier_from_cbl
        if isinstance(cbl, CBList):
            if n_shards > 1:
                from repro_torch.distributed.graph import (shard_cbl,
                                                           shard_mesh)
                cbl, _ = shard_cbl(cbl, n_shards, mesh=shard_mesh(
                    n_shards, cbl.device.type))
        elif not isinstance(cbl, TieredGraph) \
                and n_shards > 1 and cbl.n_shards != n_shards:
            raise ValueError(
                f"GraphService(n_shards={n_shards}) got storage already "
                f"sharded {cbl.n_shards} ways — pass n_shards=1 to keep it, "
                "or reshard explicitly (unshard + shard_cbl) first")
        if seal_after_epochs is not None:
            if not isinstance(cbl, TieredGraph):
                cbl = tier_from_cbl(cbl)
            policy = dataclasses.replace(policy,
                                         seal_after_epochs=seal_after_epochs)
        self._snap = snap.snapshot_of(cbl)
        self._shadow: Optional[_ShadowFlush] = None
        self._log: UpdateLog = ulog.make_log(log_capacity, cbl.device)
        self._high_watermark = float(high_watermark)
        self._policy = policy
        self._probe = probe
        self._auto_flush = auto_flush
        self._signals = signals
        self._pending = 0             # records in the log (host count)
        self.stats = ServiceStats()
        # analytics cache: (name, source) -> (epoch, delete_count, kw, result)
        self._cache: Dict[Tuple, Tuple[int, int, dict, torch.Tensor]] = {}
        self._deletes_applied = 0     # net topology removals (lattice-split signal)
        self.last_iterations = 0      # fixpoint iterations of the last analytics run
        self._programs: Dict[str, VertexProgram] = {}  # service-local registry

    @classmethod
    def from_coo(cls, src, dst, w=None, *, num_vertices: int,
                 num_blocks: Optional[int] = None, block_width: int = 32,
                 device=None, **kw) -> "GraphService":
        """Build the service's CBList from COO edges on ``device`` (the card
        unless another device is named), its block capacity provisioned by
        the per-vertex block demand; ``**kw`` go to the constructor
        (``n_shards=S`` to shard it, ``seal_after_epochs=K`` for tiered
        storage)."""
        device = resolve_device(device)
        src = torch.as_tensor(src, device=device).to(I32)
        dst = torch.as_tensor(dst, device=device).to(I32)
        if w is not None:
            w = torch.as_tensor(w, device=device).to(torch.float32)
        if num_blocks is None:
            # provision by the actual per-vertex ceil-block demand (a
            # low-degree-heavy graph needs ~one block per live vertex)
            demand = blocks_needed(src, num_vertices, block_width)
            num_blocks = max(64, demand + demand // 2 + num_vertices // 8)
        cbl = build_from_coo(src, dst, w, num_vertices=num_vertices,
                             num_blocks=num_blocks, block_width=block_width)
        return cls(cbl, **kw)

    @property
    def device(self) -> torch.device:
        return self._snap.cbl.device

    # ---- versioned read path ---------------------------------------------

    @property
    def snapshot(self) -> Snapshot:
        """The current served version (pin it for multi-query consistency)."""
        return self._snap

    @property
    def epoch(self) -> int:
        return int(self._snap.epoch)

    @property
    def pending_updates(self) -> int:
        """Admitted records waiting in the log (not those of an in-flight
        flush): a host count kept beside the log, so reading it waits for
        nothing on the device."""
        return self._pending

    @property
    def flush_in_flight(self) -> bool:
        return self._shadow is not None

    def flush_ready(self) -> bool:
        """Non-blocking: has the in-flight flush's device work completed?
        (False when nothing is in flight.)  The scheduler polls this to
        publish without stalling a read step on the upsert."""
        if self._shadow is None:
            return False
        done = self._shadow.done
        return True if done is None else done.query()

    def pending_view(self) -> PendingView:
        """Coalesced, non-destructive view of the not-yet-visible records
        (shadow + log while a flush is in flight)."""
        if self._shadow is not None:
            return ulog.merge_views(*self._shadow.records, self._log)
        return ulog.peek(self._log)

    def _as(self, x, dtype):
        return torch.as_tensor(x, device=self.device).to(dtype)

    def query_edges(self, qsrc, qdst):
        return snap.query_edges(self._snap, self._as(qsrc, I32),
                                self._as(qdst, I32))

    def query_degrees(self, verts):
        return snap.query_degrees(self._snap, self._as(verts, I32))

    def sample_khop(self, seeds, generator: torch.Generator,
                    fanout: Sequence[int] = (15, 10)):
        return snap.sample_khop(self._snap, self._as(seeds, I32), generator,
                                fanout)

    # ---- write path -------------------------------------------------------

    def apply(self, src, dst, w=None, op=None, valid=None) -> LogReceipt:
        """Admit an update batch into the log (no storage mutation yet).

        On watermark rejection the service flushes and retries once (when
        ``auto_flush``); a batch larger than the whole log raises.
        """
        args = (self._as(src, I32), self._as(dst, I32),
                None if w is None else self._as(w, torch.float32),
                None if op is None else self._as(op, I32),
                None if valid is None else self._as(valid, torch.bool))
        with obs.span("service.apply", cat="flush",
                      records=int(args[0].shape[0])):
            self._log, receipt = ulog.append(
                self._log, *args, high_watermark=self._high_watermark)
            admitted, appended, coalesced = _receipt_counts(receipt)
            if not admitted:
                self.stats.rejected_batches += 1
                obs.counter("log.rejected_batches").inc()
                if not self._auto_flush:
                    return receipt
                self.flush()
                self._log, receipt = ulog.append(
                    self._log, *args, high_watermark=self._high_watermark)
                admitted, appended, coalesced = _receipt_counts(receipt)
                if not admitted:
                    raise ValueError(
                        f"update batch of {args[0].shape[0]} records cannot "
                        f"fit an empty log of capacity {self._log.capacity} "
                        f"at watermark {self._high_watermark}")
            self._pending += appended
            self.stats.admitted += appended
            self.stats.coalesced += coalesced
            obs.counter("log.admitted").inc(appended)
            obs.counter("log.coalesced").inc(coalesced)
        return receipt

    def flush(self) -> FlushReport:
        """Drain the log into storage and publish a new snapshot epoch.

        Publishes any in-flight :meth:`begin_flush` first, then drains what
        the log still holds; after it returns everything admitted so far is
        visible.
        """
        with obs.span("service.flush", cat="flush", epoch=self.epoch):
            if self._shadow is None:
                self._begin()
                return self._finish()
            report = self._finish()
            if self._pending > 0:
                self._begin()
                report = self._finish()
            return report

    def begin_flush(self) -> None:
        """Drain the log and build the next epoch against a shadow buffer;
        readers keep the pinned snapshot until :meth:`finish_flush`."""
        if self._shadow is not None:
            self._finish()
        with obs.span("service.flush_begin", cat="flush", epoch=self.epoch):
            self._begin()

    def finish_flush(self) -> Optional[FlushReport]:
        """Publish the in-flight shadow flush (no-op when none)."""
        if self._shadow is None:
            return None
        with obs.span("service.flush_publish", cat="flush", epoch=self.epoch):
            return self._finish()

    def _begin(self) -> None:
        with obs.span("flush.admission", cat="flush") as adm_rec:
            self._log, (s, d, w, op, valid) = ulog.drain(self._log)
            watermark = int(self._log.head)
            self._pending = 0
        obs.histogram("flush.phase_s", obs.LATENCY_BUCKETS_S,
                      phase="admission").observe(adm_rec.get("dur", 0.0))
        cbl = self._snap.cbl

        with obs.span("flush.coalesce", cat="flush") as coal_rec:
            # cross-append coalescing: the drained stream is FIFO, the last
            # op per key is the net effect
            keep = ulog._coalesce_mask(s, d, valid)
            n_ins = int((keep & (op == INSERT)).sum())

            # net topology removals = final-op DELETE keys that currently
            # exist (the upsert framing also "deletes" every re-inserted
            # key, which must not count as a lattice split); only those
            # keys are looked up
            del_keys = torch.nonzero(keep & (op == DELETE)).squeeze(1)
            net_deletes = 0
            if del_keys.numel():
                found, _ = read_edges(cbl, s[del_keys], d[del_keys])
                net_deletes = int(found.sum())
        obs.histogram("flush.phase_s", obs.LATENCY_BUCKETS_S,
                      phase="coalesce").observe(coal_rec.get("dur", 0.0))
        obs.counter("flush.pending_inserts").inc(n_ins)
        obs.counter("flush.net_deletes").inc(net_deletes)

        # proactive grow: worst case every pending insert opens a block
        action = maint.decide(cbl, pending_inserts=n_ins, policy=self._policy,
                              headroom_only=True)
        if action.kind == "grow":
            cbl = maint.apply_action(cbl, action, self._policy)
            self.stats.grows += 1

        # upsert framing: the delete phase clears every kept key (nop when
        # absent), the insert phase re-adds the final-insert keys
        nop = torch.full_like(op, NOP)
        batch = (torch.cat([s, s]), torch.cat([d, d]), torch.cat([w, w]),
                 torch.cat([torch.where(keep, DELETE, nop),
                            torch.where(keep & (op == INSERT), INSERT, nop)]))
        sealed_before = (cbl.sealed if isinstance(cbl, TieredGraph)
                         else None)
        with obs.span("flush.upsert", cat="flush",
                      lanes=int(batch[0].shape[0]), retry=0):
            new_cbl, ustats = batch_update_stats(cbl, *batch)
        done = None
        if new_cbl.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self._shadow = _ShadowFlush(
            records=(s, d, w, op, valid), watermark=watermark, pre_cbl=cbl,
            new_cbl=new_cbl, ustats=ustats, batch=batch,
            net_deletes=net_deletes, done=done, sealed_before=sealed_before)

    def _finish(self) -> FlushReport:
        sh = self._shadow
        self._shadow = None
        cbl, new_cbl, ustats = sh.pre_cbl, sh.new_cbl, sh.ustats

        grow_retries = 0
        while True:
            dropped = int(obs.wait(ustats.dropped_edges, "flush.upsert.sync"))
            if dropped == 0:
                break
            if grow_retries >= MAX_GROW_RETRIES:
                raise RuntimeError(
                    f"flush still dropping {dropped} edges after "
                    f"{grow_retries} capacity doublings")
            # retry the whole batch on the pre-update cbl: updates are
            # pure, so this is exact (no partial application to reconcile)
            with obs.span("flush.grow_retry", cat="flush", dropped=dropped):
                cbl = maint.apply_action(
                    cbl, MaintenanceAction(
                        kind="grow", reason=f"overflow: {dropped} dropped",
                        num_blocks=(_num_blocks(cbl)
                                    * self._policy.grow_factor)),
                    self._policy)
            obs.counter("flush.grow_retries").inc()
            grow_retries += 1
            self.stats.grows += 1
            with obs.span("flush.upsert", cat="flush",
                          lanes=int(sh.batch[0].shape[0]),
                          retry=grow_retries):
                new_cbl, ustats = batch_update_stats(cbl, *sh.batch)
        cbl = new_cbl
        if sh.sealed_before is not None:
            # writes into the sealed tier moved their vertices back to the
            # delta inside batch_update_stats
            self.stats.unseals += int((sh.sealed_before & ~cbl.sealed).sum())

        # post-apply maintenance (fragmentation repair / cold-vertex seal);
        # policy.stats_period > 1 runs the headroom-only decide on off-cycle
        # flushes; with a signal bus the policy is churn-adapted first, and
        # decide and apply run under the same adapted K
        with obs.span("flush.maintenance", cat="flush") as maint_rec:
            policy = self._policy
            if self._signals is not None:
                policy = policy.adapted(self._signals.view())
            period = max(1, int(policy.stats_period))
            off_cycle = (self.stats.flushes + 1) % period != 0
            action = maint.decide(cbl, pending_inserts=0, policy=policy,
                                  headroom_only=off_cycle)
            if action.kind in ("compact", "rebuild", "grow", "seal"):
                cbl = maint.apply_action(cbl, action, policy)
                if action.kind == "compact":
                    self.stats.compacts += 1
                elif action.kind == "rebuild":
                    self.stats.rebuilds += 1
                elif action.kind == "seal":
                    self.stats.seals += 1
                else:
                    self.stats.grows += 1
        obs.histogram("flush.phase_s", obs.LATENCY_BUCKETS_S,
                      phase="maintenance").observe(maint_rec.get("dur", 0.0))

        self._snap = snap.advance(self._snap, cbl, sh.watermark)
        applied_inserts = int(ustats.applied_inserts)
        self.stats.flushes += 1
        self.stats.applied_inserts += applied_inserts
        self.stats.applied_deletes += sh.net_deletes
        self.stats.dropped_retries += grow_retries
        self._deletes_applied += sh.net_deletes
        obs.counter("flush.count").inc()
        obs.counter("flush.applied_inserts").inc(applied_inserts)
        obs.gauge("service.epoch").set(int(self._snap.epoch))
        if self._signals is not None:
            # flush-cadence signals, after this flush's counters landed
            self._signals.tick_flush()
        return FlushReport(epoch=int(self._snap.epoch),
                           watermark=sh.watermark,
                           applied_inserts=applied_inserts,
                           applied_deletes=sh.net_deletes,
                           grow_retries=grow_retries, maintenance=action)

    # ---- incremental analytics -------------------------------------------

    def register_program(self, prog: VertexProgram, *,
                         overwrite: bool = False) -> VertexProgram:
        """Open a user-defined :class:`~repro_torch.core.program.
        VertexProgram` to the serving loop (snapshots, per-epoch caching,
        warm starts); service-local, shadowing a global program of the same
        name for this service only."""
        if not overwrite and (prog.name in self._programs
                              or has_program(prog.name)):
            raise ValueError(f"program {prog.name!r} is already registered "
                             "(pass overwrite=True to shadow it)")
        self._programs[prog.name] = prog
        # cached fixpoints belong to the program that computed them
        for key in [k for k in self._cache if k[0] == prog.name]:
            del self._cache[key]
        return prog

    def _resolve_program(self, name: str) -> VertexProgram:
        return self._programs.get(name) or get_program(name)

    def analytics(self, name: str, source: Optional[int] = None,
                  **kw) -> torch.Tensor:
        """Run (or incrementally refresh) an analytics workload.

        Results are cached per (name, source) with their epoch; a later call
        on a newer epoch warm-starts from the cached fixpoint when the
        program's ``warm_validity`` allows it.  The engine ``impl`` is the
        tuner's choice for the storage's device.  The fixpoint's iteration
        count is kept in :attr:`last_iterations`.
        """
        prog = self._resolve_program(name)
        cbl = self._snap.cbl
        epoch = int(self._snap.epoch)
        source = (0 if source is None else int(source)) \
            if prog.needs_source else None
        key = (name, source)
        cached = self._cache.get(key)
        if cached is not None and cached[0] == epoch \
                and _kw_match(cached[2], kw):
            return cached[3]

        impl = choose_engine_impl(cbl, prog)
        warm = None
        if cached is not None and prog.warm_validity != "never":
            if not (prog.warm_validity == "inserts_only"
                    and self._deletes_applied > cached[1]):
                warm = _pad_warm(cached[3], cbl.capacity_vertices,
                                 prog.warm_fill)
        call_kw = dict(kw)
        if prog.needs_source:
            call_kw["source"] = source
        out, self.last_iterations = run_program(
            cbl, prog, warm=warm, impl=impl, return_stats=True, **call_kw)

        self._cache[key] = (epoch, self._deletes_applied, dict(kw), out)
        return out

    def plan(self, task="scan_all"):
        """The tuner's current execution plan for a task or program
        (introspection; takes a task string, a program name or a
        VertexProgram).  With a signal bus attached the plan sees the
        measured signals (contiguity, unseal churn)."""
        if isinstance(task, str) and (task in self._programs
                                      or has_program(task)):
            task = self._resolve_program(task)
        signals = self._signals.view() if self._signals is not None else None
        return choose_plan(self._snap.cbl, task, self._probe,
                           signals=signals, policy=self._policy)
