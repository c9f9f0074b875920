"""Adaptation layer (paper §6): the system probe, the execution-strategy
tuner, the sharded write path's route plan and the serving frontend's
plan.

The paper probes the machine for the number of coroutines per thread and
picks one of four prefetch strategies (All-Hard / All-Soft / Hybrid-I by
block size / Hybrid-II by hotness) by the rule ``C_m × (1 - P_h) <
C_coro``: P_h is the GTChain contiguity statistic (the chance the next
chain block is the next physical block), C_m the exposed latency of a cold
block fetch, C_coro the per-block prefetch setup.  :func:`choose_plan`
keeps the JAX package's rules and decision records; its probe holds the
card's numbers.

The engine route is not the strategy's to choose: ``ExecPlan.impl`` (and
``run_impl``) is what :func:`choose_engine_impl` returns, ``"cuda"`` on a
CUDA tensor and ``"torch"`` on the CPU.  The JAX package sends sweeps to its
kernels only on a TPU and only within a contiguity band, from v5e
constants; on the card the kernels win on every sum sweep of the graph
cell (PageRank 1.72-1.89 ms an iteration against 7.2-7.7 ms through
``impl="torch"``, ``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 at 700 W),
so that gate is not carried over.  min / max combines stay on
``scatter_reduce`` in the engine either way.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Optional

import torch

import repro_torch.obs as obs
from repro_torch.core import blockstore as bs
from repro_torch.core.cblist import CBList

# point-read lanes a second one replica of the LiveJournal-size snapshot
# serves closed loop in 4,096-lane batches (chip_smoke.py serve phase,
# NVIDIA H100 80GB HBM3, 700 W: 2.74-3.06e6 over three runs)
REPLICA_READ_LANES_PER_S = 3.0e6

logger = logging.getLogger(__name__)

STRATEGIES = ("all_hard", "all_soft", "hybrid_block", "hybrid_hot")


@dataclasses.dataclass(frozen=True)
class SystemProbe:
    """The system constants the plans read, for an H100 SXM (80 GB HBM3).

    ``hbm_bw_gbps``: the memory rate the bounds of ``chip_smoke.py`` use
    (``HBM_BYTES_PER_S``, 3.35 TB/s, the H100 SXM's data-sheet rate).
    ``block_fetch_overhead_us``: the exposed latency of a cold block fetch,
    2.5 dependent steps of ``chip_smoke.py``'s ``WALK_STEP_NS`` (150 ns, an
    L2 round trip; a DRAM miss takes 2-3 times that).
    ``smem_bytes``: shared memory an SM (228 KiB on Hopper), the on-chip
    buffer that caps the prefetch depth where the JAX package reads VMEM.
    ``scalar_prefetch_overhead_us`` and ``remote_message_overhead_us`` (a
    message across a shard cut; one device here, so it is a partial row of
    the shard-axis reduction) keep the JAX package's values: not measured
    on the card.
    ``replica_read_lanes_per_s``: point-read lanes one snapshot replica
    serves a second, from the serve phase of ``chip_smoke.py`` on an NVIDIA
    H100 80GB HBM3 at 700 W.
    """
    hbm_bw_gbps: float = 3350.0
    block_fetch_overhead_us: float = 0.375
    scalar_prefetch_overhead_us: float = 0.05
    remote_message_overhead_us: float = 2.0
    smem_bytes: int = 228 * 1024
    max_lookahead: int = 8
    replica_read_lanes_per_s: float = REPLICA_READ_LANES_PER_S


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    strategy: str            # one of STRATEGIES
    partition: str           # "vertex" | "gtchain"
    lookahead: int           # pipeline depth (coroutine-count analogue)
    impl: str                # "cuda" | "torch" (choose_engine_impl)
    n_shards: int = 1        # graph shards the sweep spans
    cut_fraction: float = 0.0  # fraction of edges crossing the shard cut
    contiguity: float = 1.0  # the P_h statistic the decision used
    run_impl: str = "torch"  # tiered: impl for the sealed-CSR tier sweep
    sealed_fraction: float = 0.0  # tiered: share of edges in the sealed tier
    route_lane_cap: int = 0  # sharded write path: per-shard routed lane cap
    route_rounds: int = 1    # sharded write path: expected spill rounds
    seal_after_epochs: Optional[int] = None  # tiered: churn-adapted seal
                                             # threshold advisory (None =
                                             # keep the policy's static K)


# ---- sharded write-path cost model ----------------------------------------

# Smallest routed lane bucket: tiny batches still get one fixed shape
# instead of a fresh shape per batch size.
MIN_ROUTE_LANES = 8
# Per-shard lane-capacity ceiling factor over the balanced share
# ceil(batch/n_shards): skew beyond this spills to further rounds instead of
# ever-wider per-shard batches (the shapes stay on the power-of-two ladder
# between MIN_ROUTE_LANES and slack * batch/n_shards).
ROUTE_SLACK = 2


@dataclasses.dataclass(frozen=True)
class RoutePlan:
    """The write-path analogue of :class:`ExecPlan`: how a sharded flush
    packs an update batch into per-shard lanes.

    ``lane_cap`` is the per-shard routed lane capacity (a power of two);
    ``n_rounds`` the spill rounds needed when the most-loaded shard
    exceeds it; ``skew`` the max/mean active-records-per-shard ratio the
    decision saw; and ``stats_period`` a maintenance-cadence hint: how many
    flushes the full-statistics maintenance decision can be amortised over
    (spilling or heavily skewed write batches fragment faster, so they pull
    the cadence back to every flush).
    """
    lane_cap: int
    n_rounds: int
    records_per_shard: float
    skew: float
    stats_period: int

    @property
    def spilled(self) -> bool:
        return self.n_rounds > 1


def choose_route_plan(n_shards: int, batch_lanes: int,
                      max_records: Optional[int] = None,
                      total_records: Optional[int] = None) -> RoutePlan:
    """Pick the routed lane capacity and spill-round count for one sharded
    update batch (host arithmetic over concrete counts).

    ``batch_lanes`` is the batch length (it bounds the shape ladder);
    ``max_records`` / ``total_records`` the *active* (non-NOP) record
    counts, per-shard max and overall, measured by the router.  When they
    are unknown (planning ahead of a batch) the worst case ``max_records =
    batch_lanes`` is assumed.
    """
    n_shards = max(1, int(n_shards))
    batch_lanes = max(0, int(batch_lanes))
    balanced = -(-batch_lanes // n_shards) if batch_lanes else 1
    ceil_cap = _pow2_at_least(max(MIN_ROUTE_LANES, balanced * ROUTE_SLACK))
    if max_records is None:
        max_records = batch_lanes
    max_records = max(0, int(max_records))
    if total_records is None:
        total_records = max_records * n_shards
    lane_cap = min(_pow2_at_least(max(MIN_ROUTE_LANES, max_records)),
                   ceil_cap)
    n_rounds = max(1, -(-max_records // lane_cap))
    mean = max(float(total_records) / n_shards, 1e-9)
    skew = float(max_records) / mean if total_records else 1.0
    # maintenance cadence: balanced, spill-free write batches fragment the
    # store slowly enough to amortise the full-statistics scans over a few
    # flushes; spill or heavy skew means chains are churning: look now
    if n_rounds > 1 or skew > ROUTE_SLACK:
        period = 1
    elif total_records == 0 or total_records * 4 <= lane_cap * n_shards:
        period = 4      # light traffic: fragmentation statistics can wait
    else:
        period = 2
    return RoutePlan(lane_cap=int(lane_cap), n_rounds=int(n_rounds),
                     records_per_shard=float(total_records) / n_shards,
                     skew=round(skew, 4), stats_period=period)


def choose_lookahead(probe: SystemProbe, block_bytes: int) -> int:
    """Coroutine-count analogue: enough blocks in flight to cover the fetch
    latency, capped by the SM's shared memory (paper: enough coroutines to
    hide C_m)."""
    fetch_us = block_bytes / (probe.hbm_bw_gbps * 1e3)   # bytes / (GB/s) in us
    need = int(math.ceil(probe.block_fetch_overhead_us / max(fetch_us, 1e-6)))
    cap_smem = max(2, probe.smem_bytes // max(block_bytes, 1) // 4)
    return int(max(2, min(need, probe.max_lookahead, cap_smem)))


def choose_plan(cbl, task, probe: Optional[SystemProbe] = None,
                signals=None, policy=None) -> ExecPlan:
    """Execution strategy tuner (paper Fig. 8).

    ``task``: a :class:`~repro_torch.core.program.VertexProgram` (the plan
    keys on its ``task`` metadata) or a task string: "scan_all" (dense
    sweeps), "frontier" (sparse relaxation steps), "query" (read_edge),
    "batch_update".  Takes a CBList, a
    :class:`~repro_torch.distributed.graph.ShardedCBList` (the plan then
    reports the cut fraction beside the shard-local contiguity) or a
    :class:`~repro_torch.core.tiered.TieredGraph`.

    ``signals`` (a :class:`repro_torch.obs.SignalView`): a measured
    ``sweep_contiguity`` signal replaces the scanned P_h statistic, and on
    tiered storage a measured ``unseal_churn`` signal adapts the seal
    threshold through ``policy.adapted(signals)`` (reported as
    ``plan.seal_after_epochs``; ``policy`` is the base
    :class:`~repro_torch.stream.maintenance.MaintenancePolicy`).  With
    ``signals=None`` the plan is the static decision.
    """
    task = getattr(task, "task", task)       # VertexProgram -> its metadata
    probe = probe or SystemProbe()
    from repro_torch.core.tiered import TieredGraph
    if isinstance(cbl, TieredGraph):
        # the delta keeps the full hybrid decision; the sealed run is a
        # flat contiguous segment reduction on the same route
        plan = choose_plan(cbl.delta, task, probe, signals=signals)
        run_impl = choose_engine_impl(cbl, task)
        plan = dataclasses.replace(
            plan, run_impl=run_impl,
            sealed_fraction=float(cbl.sealed_fraction))
        if signals is not None and policy is not None \
                and policy.seal_after_epochs is not None:
            adapted = policy.adapted(signals)
            plan = dataclasses.replace(
                plan, seal_after_epochs=adapted.seal_after_epochs)
        obs.decision("choose_plan.tiered", task=str(task), run_impl=run_impl,
                     sealed_fraction=round(plan.sealed_fraction, 4),
                     run_capacity=int(cbl.run_capacity),
                     seal_after_epochs=plan.seal_after_epochs,
                     rule="the sealed run takes the delta's device route")
        return plan
    if isinstance(cbl, CBList):
        n_shards = 1
        cut = 0.0
        contiguity = float(bs.gtchain_contiguity(cbl.store))   # P_h analogue
        lanes = cbl.store.num_blocks * cbl.store.block_width
    else:                                # ShardedCBList: shard-local stats
        from repro_torch.distributed.graph import (cut_fraction,
                                                   shard_contiguity)
        n_shards = cbl.n_shards
        cut = float(cut_fraction(cbl))
        contiguity = float(shard_contiguity(cbl))
        lanes = cbl.num_blocks * cbl.block_width   # per-shard sweep extent
    frac_chunks = float((cbl.v_level <= 1).float().mean())   # small chunks
    contiguity_source = "scan"
    sig_contig = signals.get("sweep_contiguity") if signals is not None \
        else None
    if sig_contig is not None:
        # measured P_h from real sweeps (the locality profiler through the
        # signal bus) replaces the scanned statistic: the same quantity
        contiguity = float(sig_contig.mean)
        contiguity_source = "measured"
    block_bytes = cbl.block_width * 8                          # key+val lanes
    lookahead = choose_lookahead(probe, block_bytes)

    # partition: whole-graph sweeps use the fine-grained GTChain partition;
    # frontier / query tasks need per-vertex chains (GTChain only serves
    # scan_vertices + scan_edges over everything, paper §5.2)
    partition = "gtchain" if task == "scan_all" else "vertex"

    # hybrid decision: C_m_eff × (1 - P_h) vs C_coro (paper §6.2, extended:
    # a message crossing the shard cut is a bigger C_m)
    c_m_eff = (probe.block_fetch_overhead_us
               + cut * probe.remote_message_overhead_us)
    exposed = c_m_eff * (1.0 - contiguity)
    if exposed < probe.scalar_prefetch_overhead_us:
        strategy = "all_hard"            # the hardware pipeline suffices
        rule = "exposed C_m*(1-P_h) below prefetch setup cost"
    elif task == "batch_update" or task == "query":
        # pointer-chasing chains dominate; prefetch the cold heads
        strategy = "hybrid_hot"
        rule = "pointer-chasing task: prefetch cold chain heads"
    elif frac_chunks > 0.9:
        strategy = "hybrid_block"        # chunks contiguous; chains prefetched
        rule = "small-chunk share > 0.9: contiguous chunks, prefetch chains"
    else:
        strategy = "all_soft"
        rule = "exposed latency dominates: prefetch everywhere"

    impl = choose_engine_impl(cbl, task)
    route_lane_cap, route_rounds = 0, 1
    if task == "batch_update" and n_shards > 1:
        # write-path cost model: how a capacity-bound batch would pack into
        # per-shard lanes (the live flush re-decides per batch with the
        # measured counts; this is the planning-ahead worst case)
        route = choose_route_plan(n_shards, lanes)
        route_lane_cap, route_rounds = route.lane_cap, route.n_rounds
        obs.decision("choose_route_plan", n_shards=n_shards,
                     batch_lanes=int(lanes), lane_cap=route.lane_cap,
                     n_rounds=route.n_rounds, skew=route.skew,
                     stats_period=route.stats_period,
                     rule="capacity-bound worst case (no batch in flight)")
    plan = ExecPlan(strategy=strategy, partition=partition,
                    lookahead=lookahead, impl=impl, n_shards=n_shards,
                    cut_fraction=cut, contiguity=contiguity,
                    route_lane_cap=route_lane_cap, route_rounds=route_rounds)
    logger.info(
        "choose_plan task=%s strategy=%s impl=%s n_shards=%d "
        "contiguity=%.3f cut_fraction=%.3f exposed_us=%.3f",
        task, strategy, impl, n_shards, contiguity, cut, exposed)
    obs.decision("choose_plan", task=str(task), strategy=strategy, impl=impl,
                 partition=partition, rule=rule, n_shards=n_shards,
                 contiguity=round(contiguity, 4),
                 contiguity_source=contiguity_source,
                 cut_fraction=round(cut, 4), exposed_us=round(exposed, 4),
                 lanes=int(lanes), lookahead=lookahead,
                 device=cbl.device.type)
    return plan


# ---- serving-frontend plan (repro_torch.serve) ----------------------------

# dispatch-window clamps per latency class (seconds): an interactive read
# may wait at most ~a few ms for co-batching; batch traffic trades latency
# for occupancy.  The window chosen inside the clamp targets TARGET_OCCUPANCY
# of the largest bucket at the observed arrival rate.
SERVE_WINDOW_CLAMPS = {
    "interactive": (0.0005, 0.005),
    "standard": (0.002, 0.025),
    "batch": (0.010, 0.250),
}
SERVE_TARGET_OCCUPANCY = 0.5
SERVE_MAX_BUCKET_CAP = 4096
SERVE_MIN_BUCKET = 16


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


SERVE_BUDGET_HEADROOM = 2.0   # per-(tenant, class) budget = headroom × fair rate
SERVE_BUDGET_BURST_BUCKETS = 4   # burst allowance in largest-bucket units
# target utilization of one replica's read capacity when sizing the read
# plane from measured pressure (headroom absorbs bursts between retunes)
SERVE_REPLICA_TARGET_UTIL = 0.75
# signal samples required before a measured rate overrides a static kwarg
MIN_SIGNAL_SAMPLES = 3


@dataclasses.dataclass(frozen=True)
class ServePlan:
    """Knobs for the :mod:`repro_torch.serve` frontend, keyed on arrival
    rate.

    ``bucket_set`` is the closed set of padded batch shapes the frontend may
    dispatch (power-of-two ladder — the shapes per request kind are bounded
    by its length); ``windows`` maps latency class -> dispatch window
    seconds; ``flush_pending_max`` is the pending-record count at which the
    scheduler interleaves a flush ahead of read serving.

    ``n_replicas`` sizes the read plane: the pinned snapshot is broadcast
    to that many devices and read mega-batches fan out round-robin
    (:mod:`repro_torch.serve.replica`); clamped to the devices present.
    ``double_buffer`` selects the pipelined flush (begin/publish split) —
    when off, write pressure flushes synchronously as before.

    ``budget_lanes_per_s``/``budget_burst_lanes`` are the default
    per-``(tenant, latency_class)`` token-bucket admission budget
    (:mod:`repro_torch.serve.admission`); 0 disables admission control.
    """
    bucket_set: tuple
    windows: dict
    flush_pending_max: int
    arrival_lanes_per_s: float
    n_replicas: int = 1
    double_buffer: bool = True
    budget_lanes_per_s: float = 0.0
    budget_burst_lanes: int = 0


def choose_serve_plan(arrival_qps: float, mean_lanes_per_request: float = 8.0,
                      probe: Optional[SystemProbe] = None,
                      log_capacity: int = 4096,
                      high_watermark: float = 0.75,
                      n_replicas: int = 1,
                      tenant_budget_qps: Optional[float] = None,
                      signals=None,
                      max_replicas: Optional[int] = None) -> ServePlan:
    """Size the frontend's bucket ladder and dispatch windows from the
    observed arrival rate (the serving analogue of ``choose_plan``: pick
    the batching strategy from a measured system statistic, not a constant).

    The largest bucket is sized to hold the lanes arriving inside the batch
    class's window clamp at ``SERVE_TARGET_OCCUPANCY``; each class's window
    is then the time to fill that bucket at the arrival rate, clamped to the
    class's latency budget.  A higher rate therefore grows buckets *and*
    shrinks windows — both directions keep occupancy near the target
    without opening new batch shapes (the ladder stays a bounded
    power-of-two set).

    ``n_replicas`` requests that many snapshot read replicas (read capacity
    scales with devices, so the admission budgets below scale with it too).
    ``tenant_budget_qps`` opts into per-``(tenant, latency_class)``
    admission control: each pair may sustain
    ``SERVE_BUDGET_HEADROOM × tenant_budget_qps × mean_lanes × n_replicas``
    lanes/s with a burst allowance of ``SERVE_BUDGET_BURST_BUCKETS``
    largest buckets — sized so a tenant at its declared rate never sheds,
    while a storm is bounded at the headroom multiple instead of starving
    every other tenant's p99.  ``None`` leaves admission off.

    ``signals`` (an :class:`repro_torch.obs.SignalView`) closes the loop: a
    measured ``arrival_qps`` signal replaces the
    ``arrival_qps`` kwarg, and a measured ``read_lanes_per_s`` signal sizes
    ``n_replicas`` — enough replicas that each runs at
    ``SERVE_REPLICA_TARGET_UTIL`` of ``probe.replica_read_lanes_per_s``,
    clamped to ``max_replicas`` (the local device count by default).  Each
    override needs ``MIN_SIGNAL_SAMPLES`` windowed samples, and every
    adapted knob lands in the decision log with the signal values that
    fired.  With ``signals=None`` the plan is bit-identical to the static
    one.
    """
    adapted = {}                 # knob -> firing signal values (decision log)
    if signals is not None:
        sig_qps = signals.get("arrival_qps")
        if sig_qps is not None and sig_qps.n >= MIN_SIGNAL_SAMPLES:
            arrival_qps = sig_qps.mean
            adapted["arrival_qps"] = {
                "mean": round(sig_qps.mean, 2), "last": round(sig_qps.last, 2),
                "n": sig_qps.n}
        sig_lanes = signals.get("read_lanes_per_s")
        if sig_lanes is not None and sig_lanes.n >= MIN_SIGNAL_SAMPLES:
            probe = probe or SystemProbe()
            cap = (probe.replica_read_lanes_per_s
                   * SERVE_REPLICA_TARGET_UTIL)
            if max_replicas is None:
                max_replicas = max(1, torch.cuda.device_count())
            want = int(-(-max(sig_lanes.mean, 0.0) // max(cap, 1.0)))
            n_replicas = min(max(1, want), max(1, int(max_replicas)))
            adapted["n_replicas"] = {
                "read_lanes_per_s_mean": round(sig_lanes.mean, 2),
                "read_lanes_per_s_last": round(sig_lanes.last, 2),
                "n": sig_lanes.n,
                "replica_capacity_lanes_per_s": round(cap, 2),
                "max_replicas": int(max_replicas)}
    lane_rate = max(arrival_qps, 1.0) * max(mean_lanes_per_request, 1.0)
    batch_hi = SERVE_WINDOW_CLAMPS["batch"][1]
    # an update mega-batch must clear the log's high-watermark admission
    # gate even when the log is empty, or apply() would reject it forever —
    # clamp the ladder below the watermarked capacity (pass the service's
    # actual high_watermark when it differs from the 0.75 default)
    limit = max(int(high_watermark * log_capacity), SERVE_MIN_BUCKET)
    p = _pow2_at_least(limit)
    hard_cap = min(SERVE_MAX_BUCKET_CAP, p if p == limit else p // 2)
    max_bucket = _pow2_at_least(
        int(min(max(lane_rate * batch_hi * SERVE_TARGET_OCCUPANCY,
                    SERVE_MIN_BUCKET), hard_cap)))
    min_bucket = max(SERVE_MIN_BUCKET, max_bucket // 16)
    ladder, b = [], min_bucket
    while b <= max_bucket:
        ladder.append(b)
        b *= 2
    fill = SERVE_TARGET_OCCUPANCY * max_bucket / lane_rate   # bucket fill time
    windows = {cls: float(min(max(fill, lo), hi))
               for cls, (lo, hi) in SERVE_WINDOW_CLAMPS.items()}
    n_replicas = max(1, int(n_replicas))
    if tenant_budget_qps is None:
        budget_rate, budget_burst = 0.0, 0
    else:
        budget_rate = (SERVE_BUDGET_HEADROOM * max(tenant_budget_qps, 1.0)
                       * max(mean_lanes_per_request, 1.0) * n_replicas)
        budget_burst = SERVE_BUDGET_BURST_BUCKETS * max_bucket
    plan = ServePlan(bucket_set=tuple(ladder), windows=windows,
                     flush_pending_max=max(64, log_capacity // 2),
                     arrival_lanes_per_s=lane_rate,
                     n_replicas=n_replicas,
                     budget_lanes_per_s=budget_rate,
                     budget_burst_lanes=budget_burst)
    logger.info(
        "choose_serve_plan qps=%.1f lanes/s=%.1f buckets=%s windows=%s "
        "flush_pending_max=%d replicas=%d budget=%.0f lanes/s",
        arrival_qps, lane_rate, plan.bucket_set,
        {k: round(v, 4) for k, v in windows.items()}, plan.flush_pending_max,
        n_replicas, budget_rate)
    rule = (f"fill largest bucket to {SERVE_TARGET_OCCUPANCY:g} "
            f"occupancy inside class clamps (ladder capped by "
            f"watermarked log admission); budgets "
            f"{SERVE_BUDGET_HEADROOM:g}x declared rate x replicas")
    if adapted:
        rule += ("; adapted from measured signals: "
                 + ", ".join(sorted(adapted)))
    obs.decision("choose_serve_plan", arrival_qps=round(arrival_qps, 2),
                 lanes_per_s=round(lane_rate, 2),
                 bucket_set=list(plan.bucket_set),
                 windows={k: round(v, 5) for k, v in windows.items()},
                 flush_pending_max=plan.flush_pending_max,
                 n_replicas=n_replicas,
                 budget_lanes_per_s=round(budget_rate, 2),
                 adapted=adapted or None,
                 rule=rule)
    return plan


def choose_engine_impl(cbl, task="scan_all") -> str:
    """The ``impl=`` for the engine sweeps over ``cbl`` (a CBList, a
    ShardedCBList or a TieredGraph, whose sealed run then takes the same
    route): ``"cuda"`` when its tensors lie on a CUDA device, else
    ``"torch"``.  ``task`` (a task string or a VertexProgram) is accepted
    for signature parity and not read."""
    del task
    return "cuda" if cbl.device.type == "cuda" else "torch"
