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
statistics); the actions are pure storage -> storage transforms.  Priority:
grow > seal > rebuild > compact.

Tiered storage (:class:`~repro_torch.core.tiered.TieredGraph`) adds the
``"seal"`` action: vertices with no writes for ``seal_after_epochs`` write
generations move out of the delta into the immutable CSR run.  Sealing
empties their chains, so it outranks the delta-local repairs (a rebuild of
chains about to leave the delta would be wasted work); rebuild and compact
stay local to the delta.  ``MaintenancePolicy.adapted`` raises the seal
threshold from the measured unseal churn of a signal bus.

A :class:`~repro_torch.distributed.graph.ShardedCBList` is decided as one
stack (every shard's statistics in one host read) and repaired per shard.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import NULL
from repro_torch.core.cblist import (CBList, block_fences, compact_cbl, grow,
                                     rebuild)

# churn-adaptation knobs for MaintenancePolicy.adapted(): the seal threshold
# K doubles while the measured unseal-churn ratio (unseals per seal: the
# share of sealed vertices that writes pull straight back into the
# delta) exceeds the target, capped at CHURN_ADAPT_CAP x base K
SEAL_CHURN_TARGET = 0.25
CHURN_ADAPT_CAP = 8
# windowed samples required before churn adaptation fires
MIN_CHURN_SAMPLES = 3


@dataclasses.dataclass(frozen=True)
class MaintenancePolicy:
    contiguity_floor: float = 0.85    # P_h below this -> compact
    overlap_ceiling: float = 0.25     # chain-overlap fraction above -> rebuild
    headroom_floor: float = 0.10      # free-block fraction below -> grow
    vertex_headroom_floor: float = 0.05  # spare vertex-id fraction below -> grow
    grow_factor: int = 2              # capacity doubling per grow
    max_edges_hint: Optional[int] = None  # rebuild extraction bound
                                          # (default: num_blocks * block_width)
    seal_after_epochs: Optional[int] = None  # tiered: vertices unwritten for
                                             # this many write generations
                                             # are cold (None = never seal)
    seal_min_fraction: float = 0.05   # don't repartition for fewer cold
                                      # vertices than this fraction of live
    stats_period: int = 1             # post-flush full decide every N flushes

    def adapted(self, signals) -> "MaintenancePolicy":
        """This policy with the seal threshold K adapted from measured
        unseal churn (a :class:`repro_torch.obs.SignalView`).

        A high ``unseal_churn`` / ``seal_rate`` ratio means K is too eager:
        vertices get sealed and pulled straight back into the delta by
        writes, a move each way.  K doubles per factor the ratio sits
        above :data:`SEAL_CHURN_TARGET`, capped at :data:`CHURN_ADAPT_CAP` x
        base.  Stateless: each call reads the windowed signals afresh, so a
        subsiding churn window relaxes K back toward the base policy.
        Returns ``self`` when there is no usable signal.
        """
        if signals is None or self.seal_after_epochs is None:
            return self
        churn = signals.get("unseal_churn")
        if churn is None or churn.n < MIN_CHURN_SAMPLES:
            return self
        seals = signals.get("seal_rate")
        per_seal = churn.mean / max(seals.mean if seals else 1.0, 1.0)
        mult, ratio = 1, per_seal
        while ratio > SEAL_CHURN_TARGET and mult < CHURN_ADAPT_CAP:
            mult *= 2
            ratio /= 2.0
        if mult == 1:
            return self
        k = int(self.seal_after_epochs * mult)
        obs.decision(
            "maintenance.adapt_seal", base_k=self.seal_after_epochs,
            adapted_k=k, multiplier=mult,
            unseal_churn_mean=round(churn.mean, 4),
            unseal_churn_last=round(churn.last, 4), churn_n=churn.n,
            seal_rate_mean=round(seals.mean, 4) if seals else None,
            churn_per_seal=round(per_seal, 4),
            rule=f"unseal churn per seal {per_seal:.2f} above target "
                 f"{SEAL_CHURN_TARGET:g}: double K per excess factor "
                 f"(cap {CHURN_ADAPT_CAP}x)")
        return dataclasses.replace(self, seal_after_epochs=k)


class MaintenanceAction(NamedTuple):
    kind: str         # "none" | "compact" | "rebuild" | "grow" | "seal"
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


def decide(cbl, pending_inserts: int = 0,
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

    ``cbl`` may be a :class:`~repro_torch.core.tiered.TieredGraph`; then the
    delta's rules run first and a large-enough cold set seals (the service
    passes the policy :meth:`MaintenancePolicy.adapted` to its signals).
    On a :class:`~repro_torch.distributed.graph.ShardedCBList` the rules run
    per shard and the highest-priority shard action wins (grow > rebuild >
    compact): one shard near exhaustion grows the whole stack, because the
    shards keep one shape.
    """
    phase = "proactive" if headroom_only else "full"
    with obs.span("maint.decide", cat="maint", phase=phase):
        action = _decide(cbl, pending_inserts, policy, headroom_only)
    obs.counter("maint.decision", kind=action.kind, phase=phase).inc()
    if action.kind != "none":
        obs.decision("maint.decide", action=action.kind, phase=phase,
                     reason=action.reason)
    return action


def _decide(cbl, pending_inserts: int, policy: MaintenancePolicy,
            headroom_only: bool) -> MaintenanceAction:
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import TieredGraph
        if isinstance(cbl, TieredGraph):
            return _decide_tiered(cbl, pending_inserts, policy,
                                  headroom_only)
        return _decide_sharded(cbl, pending_inserts, policy, headroom_only)
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


_ACTION_PRIORITY = {"grow": 4, "seal": 3, "rebuild": 2, "compact": 1,
                    "none": 0}


def _decide_tiered(tg, pending_inserts: int, policy: MaintenancePolicy,
                   headroom_only: bool) -> MaintenanceAction:
    """Tiered decision: the delta's own statistics rule, then sealing.

    Grow always wins, and the proactive pre-flush call (``headroom_only``)
    never seals (a repartition right before a write batch would likely
    unseal straight back).  Otherwise a large-enough cold set outranks the
    delta-local rebuild / compact.
    """
    base = _decide(tg.delta, pending_inserts, policy, headroom_only)
    if headroom_only or base.kind == "grow" \
            or policy.seal_after_epochs is None:
        return base
    from repro_torch.core.tiered import cold_mask
    n_cold = int(cold_mask(tg, policy.seal_after_epochs).sum())
    n_live = max(int(tg.n_vertices), 1)
    if n_cold and n_cold >= policy.seal_min_fraction * n_live \
            and _ACTION_PRIORITY[base.kind] < _ACTION_PRIORITY["seal"]:
        return MaintenanceAction(
            kind="seal",
            reason=f"{n_cold}/{n_live} vertices unwritten for "
                   f">={policy.seal_after_epochs} epochs")
    return base


def _sharded_statistics(scbl) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-shard (free blocks, chain overlap, contiguity) in one host read:
    ``decide`` sits on the flush path, so the sharded rules must not pay a
    device round trip a shard.  On a process group every rank gathers every
    shard's (one collective), so every rank decides alike."""
    from repro_torch.distributed.graph import gather_shards
    views = scbl.views
    stats = gather_shards(scbl, torch.stack([
        scbl.shards.store.free_top.to(torch.float64),
        torch.stack([chain_overlap_fraction(v) for v in views]).double(),
        torch.stack([bs.gtchain_contiguity(v.store) for v in views])
        .double()], 1))
    free, overlap, contig = np.asarray(stats.T.tolist())
    return free.astype(np.int64), overlap, contig


def _decide_sharded(scbl, pending_inserts: int, policy: MaintenancePolicy,
                    headroom_only: bool) -> MaintenanceAction:
    """One decision for the whole shard stack.

    The per-shard statistics arrive in one host read
    (:func:`_sharded_statistics`; the free counts alone when
    ``headroom_only``) and the threshold rules evaluate over the stack.
    ``pending_inserts`` is charged to every shard (in the worst case the
    whole batch routes to one), the grow target is the largest shard
    target so the grown stack keeps one shape, and the reason names the
    first shard that tripped the winning rule.
    """
    S = scbl.n_shards
    if headroom_only:
        from repro_torch.distributed.graph import gather_shards
        free = np.asarray(gather_shards(scbl, scbl.shards.store.free_top)
                          .tolist(), np.int64)
        overlap, contig = np.zeros(S), np.ones(S)
    else:
        free, overlap, contig = _sharded_statistics(scbl)
    nb = scbl.num_blocks
    n_live = int(scbl.n_vertices)
    nv_cap = scbl.capacity_vertices
    blk_grow = (free - pending_inserts) < policy.headroom_floor * nb
    v_low = (nv_cap - n_live) < policy.vertex_headroom_floor * nv_cap
    v_grow = ~blk_grow & v_low        # a block-growing shard never also
    if blk_grow.any() or v_grow.any():   # reports the vertex rule
        num_blocks = 0
        for k in np.nonzero(blk_grow)[0]:
            target = nb * policy.grow_factor
            while target - (nb - free[k]) \
                    < pending_inserts + policy.headroom_floor * target:
                target *= policy.grow_factor
            num_blocks = max(num_blocks, int(target))
        vcap = nv_cap * policy.grow_factor if v_grow.any() else 0
        k0 = int(np.argmax(blk_grow | v_grow))
        if blk_grow[k0]:
            reason = (f"shard {k0}: free blocks {int(free[k0])}/{nb} "
                      f"(pending {pending_inserts}) below headroom floor "
                      f"{policy.headroom_floor:.2f}")
        else:
            reason = f"shard {k0}: vertex ids {n_live}/{nv_cap} near capacity"
        return MaintenanceAction(kind="grow", num_blocks=num_blocks,
                                 vertex_capacity=vcap, reason=reason)
    rebuild_m = overlap > policy.overlap_ceiling
    if rebuild_m.any():
        k0 = int(np.argmax(rebuild_m))
        return MaintenanceAction(
            kind="rebuild",
            reason=f"shard {k0}: chain overlap {float(overlap[k0]):.2f} "
                   f"above {policy.overlap_ceiling:.2f}")
    compact_m = contig < policy.contiguity_floor
    if compact_m.any():
        k0 = int(np.argmax(compact_m))
        return MaintenanceAction(
            kind="compact",
            reason=f"shard {k0}: contiguity {float(contig[k0]):.2f} "
                   f"below {policy.contiguity_floor:.2f}")
    return MaintenanceAction(kind="none", reason="all shards in band")


def apply_action(cbl, action: MaintenanceAction,
                 policy: MaintenancePolicy = MaintenancePolicy()):
    """Execute a scheduled action (pure; 'none' is the identity).

    Sharded storage applies per shard: compact / rebuild keep the shapes,
    grow raises every shard to the same (per-shard) block target.

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


def _apply_action(cbl, action: MaintenanceAction,
                  policy: MaintenancePolicy):
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import TieredGraph
        if isinstance(cbl, TieredGraph):
            return _apply_tiered(cbl, action, policy)
        from repro_torch.distributed.graph import (compact_sharded,
                                                   grow_sharded,
                                                   rebuild_sharded)
        if action.kind == "compact":
            return compact_sharded(cbl)
        if action.kind == "rebuild":
            max_edges = policy.max_edges_hint or (cbl.num_blocks
                                                  * cbl.block_width)
            return rebuild_sharded(cbl, max_edges=max_edges)
        if action.kind == "grow":
            return grow_sharded(
                cbl, num_blocks=action.num_blocks or None,
                vertex_capacity=action.vertex_capacity or None)
        raise ValueError(f"unknown maintenance action {action.kind!r}")
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


def _apply_tiered(tg, action: MaintenanceAction, policy: MaintenancePolicy):
    """Tiered actions: seal moves the cold vertices' chains into the run
    (:func:`~repro_torch.core.tiered.seal`: the delta's capacity stays; a
    sharded store repartitions), grow extends the tier
    bookkeeping with the delta, rebuild / compact stay local to the delta
    (the sealed run is sorted and contiguous by construction)."""
    from repro_torch.core.tiered import cold_mask, seal, tiered_grow
    if action.kind == "seal":
        if policy.seal_after_epochs is None:
            raise ValueError("seal action without policy.seal_after_epochs")
        return seal(tg, cold_mask(tg, policy.seal_after_epochs))
    if action.kind == "grow":
        return tiered_grow(tg, num_blocks=action.num_blocks or None,
                           vertex_capacity=action.vertex_capacity or None)
    return dataclasses.replace(tg, delta=_apply_action(tg.delta, action,
                                                       policy))
