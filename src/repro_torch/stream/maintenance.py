"""Maintenance policy: when to compact, rebuild or grow a CBList.

Incremental inserts are cheap (tail-append) and pay for it in measurable
ways, each with its repair action:

  ===========================  ============================  ================
  statistic (watched)          degradation                   action
  ===========================  ============================  ================
  ``gtchain_contiguity``       chain-adjacent blocks no      ``compact``
                               longer physically adjacent
  chain-overlap fraction       tail blocks range-overlap     ``rebuild``
                               earlier ones
  free-stack headroom          allocator near exhaustion     ``grow``
  vertex-capacity headroom     logical ids near table end    ``grow``
  ===========================  ============================  ================

The decision runs on the host between device steps (it reads concrete
statistics); the actions are pure CBList -> CBList transforms.  Priority:
grow > rebuild > compact.  The tiered storage's seal action and the
churn-adapted seal threshold (``MaintenancePolicy.adapted``) come with the
tiered slice.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

import repro_torch.obs as obs
from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import NULL
from repro_torch.core.cblist import (CBList, block_fences, compact_cbl, grow,
                                     rebuild)


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    contiguity_floor: float = 0.85    # P_h below this -> compact
    overlap_ceiling: float = 0.25     # chain-overlap fraction above -> rebuild
    headroom_floor: float = 0.10      # free-block fraction below -> grow
    vertex_headroom_floor: float = 0.05  # spare vertex-id fraction below -> grow
    grow_factor: int = 2              # capacity doubling per grow
    max_edges_hint: Optional[int] = None  # rebuild extraction bound
                                          # (default: num_blocks * block_width)
    stats_period: int = 1             # post-flush full decide every N flushes


class MaintenanceAction(NamedTuple):
    kind: str         # "none" | "compact" | "rebuild" | "grow"
    reason: str
    num_blocks: int = 0       # grow target (0 = unchanged)
    vertex_capacity: int = 0  # grow target (0 = unchanged)


def chain_overlap_fraction(cbl: CBList) -> torch.Tensor:
    """Fraction of chain-consecutive block pairs whose key ranges overlap
    (consecutive live blocks of one owner with ``lo[next] <= hi[prev]``)."""
    st = cbl.store
    order = bs.gtchain_order(st)
    owner_o = st.owner[order]
    lo, hi = block_fences(st)
    lo_o, hi_o = lo[order], hi[order]
    nonempty = (st.count[order] > 0) & (owner_o != NULL)
    same = (owner_o[1:] == owner_o[:-1]) & nonempty[1:] & nonempty[:-1]
    ovl = same & (lo_o[1:] <= hi_o[:-1])
    return ovl.sum().float() / same.sum().clamp(min=1).float()


def decide(cbl: CBList, pending_inserts: int = 0,
           policy: MaintenancePolicy = MaintenancePolicy(),
           headroom_only: bool = False) -> MaintenanceAction:
    """Pick the maintenance action for the current storage state.

    ``pending_inserts`` (worst case: every insert opens a fresh block)
    feeds the headroom projection, so the service grows *before* a flush
    would overflow.  ``headroom_only`` skips the two full-store statistic
    scans (the proactive pre-flush call only ever acts on a grow).

    Under :mod:`repro_torch.obs` every call emits one
    ``maint.decision{kind=...,phase=...}`` counter increment (phase
    "proactive" for the headroom-only call, "full" otherwise) and a decide
    span; an action other than "none" also lands in the decision log.
    """
    phase = "proactive" if headroom_only else "full"
    with obs.span("maint.decide", cat="maint", phase=phase):
        action = _decide(cbl, pending_inserts, policy, headroom_only)
    obs.counter("maint.decision", kind=action.kind, phase=phase).inc()
    if action.kind != "none":
        obs.decision("maint.decide", action=action.kind, phase=phase,
                     reason=action.reason)
    return action


def _decide(cbl: CBList, pending_inserts: int, policy: MaintenancePolicy,
            headroom_only: bool) -> MaintenanceAction:
    return _decide_from_stats(
        nb=cbl.store.num_blocks, free=int(bs.free_blocks_left(cbl.store)),
        n_live=int(cbl.n_vertices), nv_cap=cbl.capacity_vertices,
        overlap=0.0 if headroom_only else float(chain_overlap_fraction(cbl)),
        contiguity=(1.0 if headroom_only
                    else float(bs.gtchain_contiguity(cbl.store))),
        pending_inserts=pending_inserts, policy=policy)


def _decide_from_stats(*, nb: int, free: int, n_live: int, nv_cap: int,
                       overlap: float, contiguity: float,
                       pending_inserts: int,
                       policy: MaintenancePolicy) -> MaintenanceAction:
    """The threshold rules of :func:`decide` over concrete statistics."""
    projected_free = free - pending_inserts
    if projected_free < policy.headroom_floor * nb:
        target = nb * policy.grow_factor
        while target - (nb - free) < pending_inserts + policy.headroom_floor * target:
            target *= policy.grow_factor
        return MaintenanceAction(
            kind="grow", num_blocks=target,
            reason=f"free blocks {free}/{nb} (pending {pending_inserts}) "
                   f"below headroom floor {policy.headroom_floor:.2f}")
    spare_v = nv_cap - n_live
    if spare_v < policy.vertex_headroom_floor * nv_cap:
        return MaintenanceAction(
            kind="grow", vertex_capacity=nv_cap * policy.grow_factor,
            reason=f"vertex ids {n_live}/{nv_cap} near capacity")
    if overlap > policy.overlap_ceiling:
        return MaintenanceAction(
            kind="rebuild",
            reason=f"chain overlap {overlap:.2f} above {policy.overlap_ceiling:.2f}")
    if contiguity < policy.contiguity_floor:
        return MaintenanceAction(
            kind="compact",
            reason=f"contiguity {contiguity:.2f} below {policy.contiguity_floor:.2f}")
    return MaintenanceAction(kind="none", reason="all statistics in band")


def apply_action(cbl: CBList, action: MaintenanceAction,
                 policy: MaintenancePolicy = MaintenancePolicy()) -> CBList:
    """Execute a scheduled action (pure; 'none' is the identity).

    Under :mod:`repro_torch.obs` each applied action gets a
    ``maint.action{kind=...}`` counter and a ``maint.apply`` span that
    waits for the device, so the span holds the action's device time.
    """
    if action.kind == "none":
        return cbl
    obs.counter("maint.action", kind=action.kind).inc()
    with obs.span("maint.apply", cat="maint", kind=action.kind,
                  reason=action.reason):
        out = _apply_action(cbl, action, policy)
        if obs.enabled() and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    return out


def _apply_action(cbl: CBList, action: MaintenanceAction,
                  policy: MaintenancePolicy) -> CBList:
    if action.kind == "compact":
        return compact_cbl(cbl)
    if action.kind == "rebuild":
        max_edges = policy.max_edges_hint or (cbl.store.num_blocks
                                              * cbl.store.block_width)
        return rebuild(cbl, max_edges=max_edges)
    if action.kind == "grow":
        return grow(cbl, num_blocks=action.num_blocks or None,
                    vertex_capacity=action.vertex_capacity or None)
    raise ValueError(f"unknown maintenance action {action.kind!r}")
