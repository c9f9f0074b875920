"""Engine implementation choice and the serving frontend's plan.

``choose_engine_impl`` and the serve plan (``ServePlan``,
``choose_serve_plan``) are carried over; ``choose_plan`` / ``ExecPlan`` /
``RoutePlan`` wait for the tiered and sharded storage.

For the engine: the JAX package's rule sends sweeps to its kernels only on
a TPU and only while GTChain contiguity lies between its maintenance floor
(0.85) and its all-hard cut (0.9), from v5e constants; copied here it
would keep the CUDA kernels off the service's path almost always.  So the port routes every sum sweep on a CUDA tensor
through the kernels and runs the plain oracle on the CPU.  A gate derived
from measured H100 numbers is later work; min/max combines stay on
``scatter_reduce`` in the engine either way.
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import torch

import repro_torch.obs as obs

# point-read lanes a second one replica of the LiveJournal-size snapshot
# serves closed loop in 4,096-lane batches (chip_smoke.py serve phase,
# NVIDIA H100 80GB HBM3, 700 W: 2.74-3.06e6 over three runs)
REPLICA_READ_LANES_PER_S = 3.0e6

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class SystemProbe:
    """Measured system constants the plans read.

    ``replica_read_lanes_per_s``: point-read lanes one snapshot replica
    serves a second — sized from the serve phase of ``chip_smoke.py`` on
    an NVIDIA H100 80GB HBM3 at 700 W (the JAX package's TPU constants are
    not carried over).
    """
    replica_read_lanes_per_s: float = REPLICA_READ_LANES_PER_S




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
    """The ``impl=`` for the engine sweeps over ``cbl`` (a CBList or a
    TieredGraph, whose sealed run then takes the same route): ``"cuda"``
    when its tensors lie on a CUDA device, else ``"torch"``.  ``task`` (a
    task string or a VertexProgram) is accepted for signature parity and
    not read."""
    del task
    return "cuda" if cbl.device.type == "cuda" else "torch"
