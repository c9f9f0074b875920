"""TieredGraph — sealed-CSR runs under the CBList delta (LSM-style tiering),
in torch.

An immutable, sorted run (:class:`~repro_torch.core.csr.CSRGraph`) holds
the cold bulk, a small mutable delta (:class:`~repro_torch.core.cblist.
CBList`) absorbs writes, reads and sweeps merge both tiers, and maintenance
*seals* cold vertices into the run.

Tier invariant — **vertex-granular, disjoint**: every vertex's out-edges
live in exactly one tier.  ``sealed[v]`` says which; a sealed vertex has an
empty delta chain.  Point reads pick the owning tier, sweeps combine two
partial outputs through the program's semiring, and *unseal* is the only
write-path obligation: a write whose source is sealed first moves that
vertex back into the delta.

Lifecycle::

        build                     seal (cold: no writes for K epochs)
    ──────────► hot (delta) ─────────────────────────► sealed (CSR run)
                    ▲                                        │
                    └────────────────────────────────────────┘
                      unseal (any write touching the vertex)

``wgen`` counts update batches (one flush is one batch); ``v_epoch[v]`` is
the generation of v's last write.  ``wgen``, ``run_version`` and
``run_retired`` are host ints (the JAX package keeps the first two on the
device; no device read per flush).

Moving vertices between the tiers (:func:`seal`, :func:`unseal`) is, on
one store, a *move* whose work follows what moves.  An unseal copies the
vertex's run rows (contiguous under ``offsets``) into fresh delta chains
and *retires* them in the run: they stay there, skipped by sweeps, reads,
degrees and the sampler (``sealed`` is False on their row), until the next
seal; ``run_retired`` counts them.  A seal takes the cold vertices' chains
out of the delta (their blocks go back to the pool and the delta is
compacted in the same copy; the capacity stays), sorts their edges alone
and merges them into the run in both of its orders
(:func:`~repro_torch.core.csr.csr_merge`), dropping the retired lanes.  A
sharded store moves by the *repartition* (:func:`_repartition`, also the
tests' oracle), which reads both tiers out whole and rebuilds them, the
delta re-sized to the remaining hot demand (× ``DELTA_SLACK``, a power of
two).

Division of labour: sweeps, reads and samples are pure and make no host
sync; the update entry points, the moves and the repartition are
host-orchestrated (shapes change) and never write into the tensors of the
graph they were given, so a snapshot that holds the old graph keeps
serving it.

Sharding: the delta may be a :class:`~repro_torch.distributed.graph.
ShardedCBList`; then ``runs`` is a tuple of one run a shard the rank holds,
each holding exactly the sealed vertices its shard owns (``v_shard``),
every run of the same capacity, and the run sweeps reduce across the
shards, and across the delta's mesh on a process group, as the delta's do
(:func:`repro_torch.distributed.graph.sharded_runs_sweep`).  The run
tier's degrees, edge counts and reads are reduced over the mesh too, so
every rank sees the whole graph.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch

import repro_torch.obs as obs
from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import (I32, NULL, PAD, arange32,
                                         composite_key)
from repro_torch.core.cblist import (CBList, blocks_needed, build_from_coo,
                                     compact_cbl, to_coo)
from repro_torch.core.csr import (CSRGraph, _csr_build, _live_lanes,
                                  csr_build, csr_degrees, csr_empty,
                                  csr_in_degrees, csr_merge, csr_pull,
                                  csr_push, csr_push_feat, csr_query,
                                  csr_rank_neighbors, csr_to_coo)
from repro_torch.core.engine import (SEMIRINGS, _default_edge_f, in_degrees,
                                     process_edge_pull, process_edge_push,
                                     process_edge_push_feat)
from repro_torch.core.updates import (INSERT, NOP, UpdateStats,
                                      batch_update_stats, delete_vertices,
                                      read_edges, upsert_edges)

# delta re-size policy at seal time: hot block demand gets this slack, then
# rounds up to a power of two with this floor
DELTA_SLACK = 1.5
MIN_DELTA_BLOCKS = 64


def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass(frozen=True, eq=False)
class TieredGraph:
    """Two-tier storage: an immutable CSR run under a mutable CBList delta.

    Exposes the vertex-table surface (``capacity_vertices``, ``n_vertices``,
    ``v_deg``, ``v_level``, ``num_edges``, ``block_width``, ``device``) the
    engine, snapshot and program layers read, so it drops into every
    storage-dispatching entry point.
    """
    delta: CBList           # the hot, mutable tier (or a ShardedCBList)
    runs: CSRGraph          # the sealed tier (sharded: a tuple, one a shard)
    sealed: torch.Tensor    # bool[NV]  vertex lives in the run tier
    v_epoch: torch.Tensor   # i32[NV]   write generation of the last write
    wgen: int               # current write generation (batches)
    run_version: int        # bumps on every seal / unseal
    run_retired: int = 0    # run lanes whose row was unsealed since the
                            # last seal (skipped until the next one merges)

    # ---- vertex-table surface -------------------------------------------

    @property
    def capacity_vertices(self) -> int:
        return self.sealed.shape[0]

    @property
    def n_vertices(self) -> torch.Tensor:
        return self.delta.n_vertices

    @property
    def block_width(self) -> int:
        return self.delta.block_width

    @property
    def device(self) -> torch.device:
        return self.delta.device

    @property
    def num_blocks(self) -> int:
        """Delta block capacity (per shard when sharded)."""
        d = self.delta
        return d.store.num_blocks if isinstance(d, CBList) else d.num_blocks

    @property
    def is_sharded(self) -> bool:
        return not isinstance(self.delta, CBList)

    @property
    def run_list(self) -> Tuple[CSRGraph, ...]:
        """The sealed runs: one, or one a shard."""
        return self.runs if self.is_sharded else (self.runs,)

    @property
    def run_capacity(self) -> int:
        """Static lane capacity of the sealed tier (per shard when
        sharded)."""
        return self.run_list[0].capacity

    def _across(self, t: torch.Tensor) -> torch.Tensor:
        """A sum of the local runs' partials over the delta's mesh."""
        from repro_torch.distributed.graph import SUM, _all_reduce, mesh_of
        return _all_reduce(mesh_of(self), t, SUM)

    @functools.cached_property
    def run_degrees(self) -> torch.Tensor:
        """Out-degrees in the run tier (a retired row reads 0)."""
        return self._across(sum(csr_degrees(g, self.sealed)
                                for g in self.run_list))

    @functools.cached_property
    def v_deg(self) -> torch.Tensor:
        """Global out-degrees: each vertex's edges live in exactly one tier."""
        return self.delta.v_deg + self.run_degrees

    @property
    def v_level(self) -> torch.Tensor:
        return self.delta.v_level

    @functools.cached_property
    def run_edges(self) -> torch.Tensor:
        """Live edges of the sealed tier (retired lanes left out)."""
        return self.run_degrees.sum()

    @property
    def num_edges(self) -> torch.Tensor:
        return self.delta.num_edges + self.run_edges

    @property
    def sealed_fraction(self) -> torch.Tensor:
        """Fraction of live edges held by the sealed tier."""
        run_e = self.run_edges
        return run_e / (run_e + self.delta.num_edges).clamp(min=1)


def _empty_runs_like(delta):
    """An empty sealed tier for ``delta``: one empty run, or one a local
    shard."""
    nvc = delta.capacity_vertices
    if isinstance(delta, CBList):
        return csr_empty(nvc, 0, delta.device)
    return tuple(csr_empty(nvc, 0, delta.device) for _ in delta.views)


def tier_from_cbl(delta) -> TieredGraph:
    """Wrap existing storage (a CBList or a ShardedCBList) as an all-hot
    tiered graph (empty run tier)."""
    nvc = delta.capacity_vertices
    dev = delta.device
    return TieredGraph(delta=delta, runs=_empty_runs_like(delta),
                       sealed=torch.zeros(nvc, dtype=torch.bool, device=dev),
                       v_epoch=torch.zeros(nvc, dtype=I32, device=dev),
                       wgen=0, run_version=0)


# ---------------------------------------------------------------------------
# Tier-aware sweeps (pure: a merge of two partial outputs)
# ---------------------------------------------------------------------------

def _merge(a: torch.Tensor, b: torch.Tensor, combine: str) -> torch.Tensor:
    """Elementwise cross-tier combine through the program's semiring."""
    if combine == "sum":
        return a + b
    return SEMIRINGS[combine].lane_reduce(torch.stack([a, b]), 0)


def _runs_sweep(tg: TieredGraph, x, active, sweep, combine: str):
    """The run-tier sweep (a ``tier.run_sweep`` span): the one run's, or
    every shard's run reduced across the shards (and the mesh)."""
    with obs.span("tier.run_sweep", cat="tier"):
        if not tg.is_sharded:
            return sweep(tg.runs, x, active)
        from repro_torch.distributed.graph import sharded_runs_sweep
        return sharded_runs_sweep(tg.runs, tg.delta.mesh, x, active, sweep,
                                  combine)


def _by_sealed_source(tg: TieredGraph, active: Optional[torch.Tensor]
                      ) -> Optional[torch.Tensor]:
    """The run's push sweeps' source mask: ``active`` less the retired rows
    (only while the run holds any)."""
    if not tg.run_retired:
        return active
    return tg.sealed if active is None else active & tg.sealed


def _sealed_at(tg: TieredGraph, v: torch.Tensor) -> torch.Tensor:
    """bool[...]: ``v`` is an in-range sealed vertex."""
    nvc = tg.capacity_vertices
    return tg.sealed[v.clamp(0, nvc - 1).long()] & (v >= 0) & (v < nvc)


def tiered_process_edge_push(tg: TieredGraph, x: torch.Tensor,
                             active: Optional[torch.Tensor] = None, *,
                             dense_f=_default_edge_f, combine: str = "sum",
                             impl: str = "torch", plan=None) -> torch.Tensor:
    """Push sweep over both tiers: the delta's block sweep (through
    ``plan``, the delta's sweep plan, when given) and the run's flat CSR
    sweep, merged through the semiring.  Disjoint tiers make the merge
    exact (each edge contributes in exactly one partial)."""
    a = process_edge_push(tg.delta, x, active, dense_f=dense_f,
                          combine=combine, impl=impl, plan=plan)
    if tg.run_capacity == 0:
        return a
    sweep = functools.partial(csr_push, dense_f=dense_f, combine=combine,
                              impl=impl)
    return _merge(a, _runs_sweep(tg, x, _by_sealed_source(tg, active), sweep,
                                 combine), combine)


def tiered_process_edge_pull(tg: TieredGraph, x: torch.Tensor,
                             active_dst: Optional[torch.Tensor] = None, *,
                             dense_f=_default_edge_f, combine: str = "sum",
                             impl: str = "torch", plan=None) -> torch.Tensor:
    a = process_edge_pull(tg.delta, x, active_dst, dense_f=dense_f,
                          combine=combine, impl=impl, plan=plan)
    if tg.run_capacity == 0:
        return a
    sweep = functools.partial(csr_pull, dense_f=dense_f, combine=combine,
                              impl=impl)
    b = _runs_sweep(tg, x, active_dst, sweep, combine)
    if tg.run_retired:              # a retired row sums nothing
        b = torch.where(tg.sealed.view(-1, *([1] * (b.dim() - 1))), b,
                        SEMIRINGS[combine].fill)
    return _merge(a, b, combine)


def tiered_process_edge_push_feat(tg: TieredGraph, x: torch.Tensor,
                                  active: Optional[torch.Tensor] = None, *,
                                  weighted: bool = True, impl: str = "torch",
                                  plan=None) -> torch.Tensor:
    a = process_edge_push_feat(tg.delta, x, active, weighted=weighted,
                               impl=impl, plan=plan)
    if tg.run_capacity == 0:
        return a
    sweep = functools.partial(csr_push_feat, weighted=weighted, impl=impl)
    return a + _runs_sweep(tg, x, _by_sealed_source(tg, active), sweep, "sum")


def tiered_in_degrees(tg: TieredGraph) -> torch.Tensor:
    return in_degrees(tg.delta) + tg._across(
        sum(csr_in_degrees(g, tg.sealed) for g in tg.run_list))


# ---------------------------------------------------------------------------
# Tier-aware point reads / sampling (pure, no host sync)
# ---------------------------------------------------------------------------

def tiered_read_edges(tg: TieredGraph, qsrc: torch.Tensor,
                      qdst: torch.Tensor,
                      active: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched read_edge over both tiers (at most one can find an edge)."""
    f1, w1 = read_edges(tg.delta, qsrc, qdst, active)
    if tg.run_capacity == 0:
        return f1, w1
    if tg.is_sharded:                   # at most one shard's run holds it
        from repro_torch.distributed.graph import owner_merge
        fs, ws = zip(*(csr_query(g, qsrc, qdst, active) for g in tg.runs))
        f2, w2 = owner_merge(fs, ws, tg.delta.mesh)
    else:
        f2, w2 = csr_query(tg.runs, qsrc, qdst, active)
    f2 = f2 & _sealed_at(tg, qsrc)      # a retired row holds no edge
    return f1 | f2, torch.where(f1, w1, torch.where(f2, w2, 0.0))


def tiered_rank_neighbors(tg: TieredGraph, verts: torch.Tensor,
                          ranks: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The neighbours at ``ranks`` of each vertex: sealed vertices read the
    run (one gather a draw), hot ones walk the delta's chain.  One rank
    draw serves both tiers, because each vertex's edges live in one."""
    if tg.is_sharded:
        from repro_torch.distributed.graph import sharded_rank_neighbors
        d_out, d_ok = sharded_rank_neighbors(tg.delta, verts, ranks)
    else:
        from repro_torch.graph.sampler import rank_neighbors
        d_out, d_ok = rank_neighbors(tg.delta, verts, ranks)
    if tg.run_capacity == 0:
        return d_out, d_ok
    if tg.is_sharded:                   # at most one shard's run holds v
        from repro_torch.distributed.graph import owner_merge
        outs, oks = zip(*(csr_rank_neighbors(g, verts, ranks)
                          for g in tg.runs))
        r_ok, r_out = owner_merge(oks, outs, tg.delta.mesh)
        r_out = torch.where(r_ok, r_out, NULL)
    else:
        r_out, r_ok = csr_rank_neighbors(tg.runs, verts, ranks)
    use_run = _sealed_at(tg, verts)[:, None]
    out = torch.where(use_run, r_out, d_out)
    ok = torch.where(use_run, r_ok, d_ok)
    return torch.where(ok, out, NULL), ok


def tiered_sample_neighbors(tg: TieredGraph, verts: torch.Tensor,
                            generator: torch.Generator, k: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-hop fanout draw over both tiers: ranks uniform in
    ``[0, max(v_deg, 1))`` over the tiered degrees."""
    from repro_torch.graph.sampler import draw_ranks
    return tiered_rank_neighbors(tg, verts,
                                 draw_ranks(tg, verts, generator, k))


# ---------------------------------------------------------------------------
# Cold vertices and the repartition (host-orchestrated: shapes change)
# ---------------------------------------------------------------------------

def cold_mask(tg: TieredGraph, after_epochs: int) -> torch.Tensor:
    """Vertices eligible for sealing: hot, live, carrying delta edges, and
    unwritten for at least ``after_epochs`` write generations."""
    nvc = tg.capacity_vertices
    live = torch.arange(nvc, device=tg.device) < tg.n_vertices
    age = tg.wgen - tg.v_epoch
    return (~tg.sealed) & live & (tg.delta.v_deg > 0) & (age >= after_epochs)


def _combined_coo(delta: CBList, runs: CSRGraph, sealed: torch.Tensor):
    """All edges of one (delta, run) pair as one padded COO (delta in
    GTChain order, then the run's unretired lanes)."""
    s1, d1, w1, v1 = to_coo(delta)
    s2, d2, w2, v2 = csr_to_coo(runs, sealed)
    return (torch.cat([s1, s2]), torch.cat([d1, d2]), torch.cat([w1, w2]),
            torch.cat([v1, v2]))


def _repartition(tg: TieredGraph, new_sealed: torch.Tensor) -> TieredGraph:
    """Rebuild both tiers around a new sealed set (host-side, loss-free):
    a sharded store's seal and unseal, and the reference's layout.

    The delta's block capacity is re-sized to the remaining hot demand
    (power-of-two rounded, ``DELTA_SLACK`` headroom) — sealing must *shrink*
    the delta or its sweeps would keep paying for sealed lanes.

    Under :mod:`repro_torch.obs`: one ``tier.repartition`` span that waits
    for the device, a ``tier.repartition_s`` series and histogram, a
    ``tier.repartitions`` counter, and the ``tier.sealed_fraction`` and
    ``tier.delta_blocks`` gauges refreshed on the result.
    """
    with obs.span("tier.repartition", cat="tier",
                  n_sealed=int(new_sealed.sum()) if obs.enabled() else 0
                  ) as sp:
        out = _repartition_inner(tg, new_sealed)
        if obs.enabled() and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    obs.series("tier.repartition_s").observe(sp.get("dur", 0.0))
    obs.histogram("tier.repartition_hist_s", obs.LATENCY_BUCKETS_S).observe(
        sp.get("dur", 0.0))
    obs.counter("tier.repartitions").inc()
    _refresh_gauges(out)
    return out


def _repartition_inner(tg: TieredGraph,
                       new_sealed: torch.Tensor) -> TieredGraph:
    """Split each (delta, run) pair's edges by the new sealed set and
    rebuild both tiers; a sharded store sizes every shard's tiers alike
    (the largest shard's run and hot demand) so the stacks keep one
    shape (on a mesh, the largest over the mesh)."""
    from repro_torch.distributed.graph import MAX, _all_reduce, _restack
    nvc = tg.capacity_vertices
    bw = tg.block_width
    deltas = tg.delta.views if tg.is_sharded else (tg.delta,)
    parts = []
    run_cap, nb = 0, MIN_DELTA_BLOCKS
    for delta, run in zip(deltas, tg.run_list):
        s, d, w, valid = _combined_coo(delta, run, tg.sealed)
        cold = valid & new_sealed[s.clamp(0, nvc - 1).long()]
        hot = valid & ~cold
        n_cold = int(cold.sum())
        if n_cold:
            run_cap = max(run_cap, _pow2_at_least(n_cold))
        demand = blocks_needed(s[hot], nvc, bw)
        nb = max(nb, _pow2_at_least(int(demand * DELTA_SLACK) + 1))
        parts.append((s, d, w, cold, hot))
    if tg.is_sharded and tg.delta.mesh is not None:
        run_cap, nb = (int(x) for x in _all_reduce(
            tg.delta.mesh, torch.tensor([run_cap, nb], device=tg.device),
            MAX).tolist())
    n_live = int(tg.n_vertices)
    new_deltas, runs = [], []
    for s, d, w, cold, hot in parts:
        runs.append(csr_build(s, d, w, nvc, capacity=run_cap, valid=cold)
                    if run_cap > 0 else csr_empty(nvc, 0, tg.device))
        new_deltas.append(build_from_coo(
            s, d, w, num_vertices=n_live, num_blocks=nb, block_width=bw,
            vertex_capacity=nvc, valid=hot))
    if tg.is_sharded:
        delta = dataclasses.replace(tg.delta, shards=_restack(new_deltas))
        runs = tuple(runs)
    else:
        delta = new_deltas[0]._replace(n_vertices=tg.delta.n_vertices)
        runs = runs[0]
    return dataclasses.replace(tg, delta=delta, runs=runs, sealed=new_sealed,
                               run_version=tg.run_version + 1, run_retired=0)


# ---------------------------------------------------------------------------
# Seal and unseal (on one store: moves, whose work follows what moves)
# ---------------------------------------------------------------------------

def _refresh_gauges(tg: TieredGraph) -> None:
    if obs.enabled():
        obs.gauge("tier.sealed_fraction").set(float(tg.sealed_fraction))
        obs.gauge("tier.delta_blocks").set(tg.num_blocks)


def _chains_of(delta: CBList, mask: torch.Tensor):
    """(blocks, src, dst, w): the blocks of the chains of the vertices in
    ``mask`` and their edges, sorted by (src, dst) (parallel edges in
    GTChain order, as the repartition's build keeps them)."""
    st = delta.store
    nvc = delta.capacity_vertices
    own = st.owner
    blk = (own >= 0) & (own < nvc) & mask[own.clamp(0, nvc - 1).long()]
    ids = torch.nonzero(blk).squeeze(1)
    ids = ids[torch.sort(composite_key(own[ids], st.seq[ids]))[1]]
    B = st.block_width
    live = (arange32(B, delta.device)[None, :]
            < st.count[ids][:, None]).reshape(-1)
    flat = torch.nonzero(live).squeeze(1)
    src = own[ids][flat // B]
    dst = st.keys[ids].reshape(-1)[flat]
    w = st.vals[ids].reshape(-1)[flat]
    order = torch.sort(composite_key(src, dst), stable=True)[1]
    return blk, src[order], dst[order], w[order]


def _drop_chains(delta: CBList, blk: torch.Tensor,
                 mask: torch.Tensor) -> CBList:
    """``delta`` without the chains of the vertices in ``mask`` (their
    blocks ``blk``), compacted: the chains left laid out in GTChain order
    from block 0 and every free block, reset, after them.  Freeing in
    place would copy the store as well, and would leave holes that
    break the chains' contiguity, which a compaction a flush later
    repairs: the seal takes both in one copy."""
    st = delta.store
    gone = delta._replace(store=st._replace(owner=torch.where(blk, NULL,
                                                              st.owner)),
                          v_deg=torch.where(mask, 0, delta.v_deg),
                          v_level=torch.where(mask, 0, delta.v_level),
                          v_head=torch.where(mask, NULL, delta.v_head),
                          v_tail=torch.where(mask, NULL, delta.v_tail))
    out = compact_cbl(gone)
    cst = out.store                 # fresh arrays: the freed tail is reset
    live = cst.num_blocks - int(cst.free_top)
    for x, fill in ((cst.keys, PAD), (cst.vals, 0.0), (cst.count, 0),
                    (cst.nxt, NULL), (cst.seq, 0)):
        x[live:] = fill
    return out


def seal(tg: TieredGraph, mask: torch.Tensor) -> TieredGraph:
    """Move the hot vertices in ``mask`` into the sealed CSR run.

    On one store, a move: their chains leave the delta (their blocks go
    back to the pool, the chains left compacted; the capacity stays) and
    their edges, sorted alone, merge into the run in both of its orders,
    the retired lanes dropped (:func:`~repro_torch.core.csr.csr_merge`).
    The work is the moved edges' sort, a copy of the delta's store and a
    pass over the run.  A sharded store repartitions
    (:func:`_repartition`).

    Under :mod:`repro_torch.obs`: a ``tier.seal`` span with the children
    ``tier.seal_extract`` and ``tier.seal_merge``, the
    ``seal.seal_count{reason=policy}`` (vertices) and
    ``seal.seal_edges{reason=policy}`` counters.
    """
    mask = torch.as_tensor(mask, device=tg.device).to(torch.bool)
    if tg.is_sharded:
        if not bool(mask.any()):
            return tg
        n_new = int((mask & ~tg.sealed).sum())
        obs.counter("seal.seal_count", reason="policy",
                    bucket=obs.count_bucket(n_new)).inc(n_new)
        return _repartition(tg, tg.sealed | mask)
    mask = mask & ~tg.sealed
    n_new = int(mask.sum())
    if not n_new:
        return tg
    with obs.span("tier.seal", cat="tier", vertices=n_new):
        with obs.span("tier.seal_extract", cat="tier"):
            blk, s, d, w = _chains_of(tg.delta, mask)
            delta = _drop_chains(tg.delta, blk, mask)
        with obs.span("tier.seal_merge", cat="tier", edges=s.numel()):
            runs = csr_merge(tg.runs, tg.sealed, s, d, w)
    obs.counter("seal.seal_count", reason="policy",
                bucket=obs.count_bucket(n_new)).inc(n_new)
    obs.counter("seal.seal_edges", reason="policy").inc(s.numel())
    out = dataclasses.replace(tg, delta=delta, runs=runs,
                              sealed=tg.sealed | mask,
                              run_version=tg.run_version + 1, run_retired=0)
    _refresh_gauges(out)
    return out


def _run_rows(tg: TieredGraph, hit: torch.Tensor):
    """The run rows of the sealed vertices in ``hit``: ``((blocks, free),
    verts, deg, k, dst, w)``.  ``verts`` (i64) are the vertices in order,
    ``deg`` their row counts, the rows (contiguous under ``offsets``, so
    in (src, dst) order) those of ``verts[k]``; ``blocks`` the delta blocks
    they take as fresh chains and ``free`` the delta's free blocks (one
    host read in all: the vertices are placed by their rank, and each row
    finds its vertex by a search, not a per-vertex loop)."""
    g = tg.runs
    nvc = tg.capacity_vertices
    B = tg.block_width
    dev = tg.device
    deg_all = torch.where(hit, g.offsets[1:nvc + 1] - g.offsets[:nvc], 0)
    n_hit, n, n_blocks, free = torch.stack([
        hit.sum(), deg_all.sum(), ((deg_all + B - 1) // B).sum(),
        tg.delta.store.free_top.long()]).tolist()
    slot = torch.where(hit, torch.cumsum(hit, 0) - 1, n_hit)
    verts = torch.zeros(n_hit + 1, dtype=torch.int64, device=dev).scatter_(
        0, slot, torch.arange(nvc, device=dev))[:n_hit]
    deg = deg_all[verts].long()
    cum = torch.cumsum(deg, 0)
    j = torch.arange(n, device=dev)
    k = torch.searchsorted(cum, j, right=True)
    lane = g.offsets[verts].long()[k] + j - (cum - deg)[k]
    return (n_blocks, free), verts, deg, k, g.indices[lane], g.weights[lane]


def _fit(delta: CBList, short: int) -> CBList:
    """``delta`` with ``short`` more free blocks at least: its block
    capacity doubled as often as that takes, as maintenance grows it (on
    the service the pre-flush grow, which counts :func:`unseal_blocks`,
    has made the room already)."""
    if short <= 0:
        return delta
    from repro_torch.core.cblist import grow
    nb = delta.store.num_blocks
    target = 2 * nb
    while target - nb < short:
        target *= 2
    return grow(delta, num_blocks=target)


def _append_chains(delta: CBList, verts: torch.Tensor, deg: torch.Tensor,
                   k: torch.Tensor, dst: torch.Tensor, w: torch.Tensor,
                   n_blocks: int) -> CBList:
    """``delta`` with fresh chains for ``verts`` (distinct, ascending,
    their delta chains empty): ``deg`` rows each, the rows ``(dst, w)`` of
    ``verts[k]`` in (src, dst) order, laid out block after block from the
    free stack, which holds the ``n_blocks`` = Σ ceil(deg / B) they take.
    The layout is the one the insert pass gives the same rows, but the
    rows come sorted, so nothing is sorted, and the store's keys and
    values are copied once."""
    if not n_blocks:
        return delta
    st = delta.store
    B = st.block_width
    dev = delta.device
    nblk = (deg + B - 1) // B
    cum_blk = torch.cumsum(nblk, 0)
    first = cum_blk - nblk                          # each vertex's first slot
    st, ids = bs.alloc_blocks(st, n_blocks,
                              torch.tensor(n_blocks, device=dev))
    slot = torch.arange(n_blocks, device=dev)
    kb = torch.searchsorted(cum_blk, slot, right=True)
    q = slot - first[kb]
    v = verts[kb]
    blk = ids.long()
    owner, seq, count, nxt = (st.owner.clone(), st.seq.clone(),
                              st.count.clone(), st.nxt.clone())
    owner[blk] = v.to(I32)
    seq[blk] = (delta.v_level[v] + q).to(I32)
    count[blk] = (deg[kb] - q * B).clamp(max=B).to(I32)
    nxt[blk] = torch.where(q == nblk[kb] - 1, NULL, ids.roll(-1))
    flat = (first[k] * B + torch.arange(k.numel(), device=dev)
            - (torch.cumsum(deg, 0) - deg)[k])
    kt = torch.full((n_blocks * B,), PAD, dtype=I32, device=dev)
    vt = torch.zeros(n_blocks * B, dtype=torch.float32, device=dev)
    kt[flat] = dst
    vt[flat] = w
    keys, vals = st.keys.clone(), st.vals.clone()
    keys[blk] = kt.view(n_blocks, B)
    vals[blk] = vt.view(n_blocks, B)
    has = verts[nblk > 0]
    v_deg, v_level = delta.v_deg.clone(), delta.v_level.clone()
    v_head, v_tail = delta.v_head.clone(), delta.v_tail.clone()
    v_deg[verts] += deg.to(I32)
    v_level[verts] += nblk.to(I32)
    v_head[has] = ids[first[nblk > 0]]
    v_tail[has] = ids[cum_blk[nblk > 0] - 1]
    return delta._replace(
        store=st._replace(keys=keys, vals=vals, count=count, owner=owner,
                          nxt=nxt, seq=seq),
        v_deg=v_deg, v_level=v_level, v_head=v_head, v_tail=v_tail)


def unseal(tg: TieredGraph, mask: torch.Tensor, *,
           reason: str = "manual") -> TieredGraph:
    """Move the sealed vertices in ``mask`` back into the delta.

    On one store, a move: each vertex's run rows (contiguous under
    ``offsets``, and its delta chain empty by the tier invariant) become
    a fresh delta chain (:func:`_append_chains`: no locate, no dedupe, no
    sort), and stay in the run retired until the next seal.  The delta
    grows first when its free blocks cannot take them (:func:`_fit`), so
    no moved edge is ever dropped.  The work is the moved rows' and one
    copy of the delta's store.  A sharded store repartitions
    (:func:`_repartition`).

    Under :mod:`repro_torch.obs`: a ``tier.unseal`` span, the
    ``seal.unseal_count{reason}`` (vertices) and
    ``seal.unseal_edges{reason}`` counters.
    """
    hit = torch.as_tensor(mask, device=tg.device).to(torch.bool) & tg.sealed
    if tg.is_sharded:
        n_hit = int(hit.sum())
        if not n_hit:
            return tg
        obs.counter("seal.unseal_count", reason=reason,
                    bucket=obs.count_bucket(n_hit)).inc(n_hit)
        return _repartition(tg, tg.sealed & ~hit)
    with obs.span("tier.unseal", cat="tier"):
        (n_blocks, free), verts, deg, k, dst, w = _run_rows(tg, hit)
        if not verts.numel():
            return tg
        delta = _append_chains(_fit(tg.delta, n_blocks - free), verts, deg,
                               k, dst, w, n_blocks)
    n_hit, n = verts.numel(), dst.numel()
    obs.counter("seal.unseal_count", reason=reason,
                bucket=obs.count_bucket(n_hit)).inc(n_hit)
    obs.counter("seal.unseal_edges", reason=reason).inc(n)
    out = dataclasses.replace(tg, delta=delta, sealed=tg.sealed & ~hit,
                              run_version=tg.run_version + 1,
                              run_retired=tg.run_retired + n)
    _refresh_gauges(out)
    return out


# ---------------------------------------------------------------------------
# Tier-aware updates (host-orchestrated: writes unseal their targets first)
# ---------------------------------------------------------------------------

def _write_rows(tg: TieredGraph, src: torch.Tensor,
                active: torch.Tensor) -> torch.Tensor:
    """Rows of the in-range sources of the active writes."""
    nvc = tg.capacity_vertices
    return src[active & (src >= 0) & (src < nvc)].long()


def _written_sealed(tg: TieredGraph, src: torch.Tensor,
                    active: torch.Tensor) -> torch.Tensor:
    """bool[NV]: the sealed vertices a write batch touches (by source)."""
    touched = torch.zeros(tg.capacity_vertices, dtype=torch.bool,
                          device=tg.device)
    touched[_write_rows(tg, src, active)] = True
    return touched & tg.sealed


def unseal_blocks(tg: TieredGraph, src: torch.Tensor,
                  active: torch.Tensor) -> int:
    """Delta blocks the write batch's unseal takes (a host read; 0 on a
    sharded store, whose repartition sizes the delta itself): the
    service's pre-flush grow counts them beside the batch's inserts."""
    if tg.is_sharded or tg.run_capacity == 0:
        return 0
    B = tg.block_width
    deg = csr_degrees(tg.runs)
    hit = _written_sealed(tg, src, active)
    return int(torch.where(hit, (deg + B - 1) // B, 0).sum())


def _unseal_written(tg: TieredGraph, src: torch.Tensor,
                    active: torch.Tensor) -> TieredGraph:
    """Unseal the sealed vertices a write batch touches (by source): the
    churn signal the seal policy must not fight
    (``seal.unseal_count{reason=write}``)."""
    return unseal(tg, _written_sealed(tg, src, active), reason="write")


def _stamp(tg: TieredGraph, src: torch.Tensor, active: torch.Tensor,
           delta: CBList) -> TieredGraph:
    """Advance the write generation and stamp the touched sources."""
    wgen = tg.wgen + 1
    v_epoch = tg.v_epoch.clone()
    v_epoch[_write_rows(tg, src, active)] = wgen
    return dataclasses.replace(tg, delta=delta, v_epoch=v_epoch, wgen=wgen)


def tiered_batch_update_stats(tg: TieredGraph, src: torch.Tensor,
                              dst: torch.Tensor,
                              w: Optional[torch.Tensor] = None,
                              op: Optional[torch.Tensor] = None
                              ) -> Tuple[TieredGraph, UpdateStats]:
    """BatchUpdate over tiered storage (host-orchestrated).

    Writes whose source is sealed first *unseal* it (:func:`unseal`, so
    the batch applies to a delta that owns every touched chain); the delta
    then absorbs the batch unchanged (a ``tier.delta_update`` span).  Both
    phases are pure functions of their input, so the service's
    grow-and-retry replays identically on a grown copy.
    """
    if op is None:
        op = torch.full(src.shape, INSERT, dtype=I32, device=src.device)
    tg = _unseal_written(tg, src, op != NOP)
    with obs.span("tier.delta_update", cat="tier"):
        delta, stats = batch_update_stats(tg.delta, src, dst, w, op)
    return _stamp(tg, src, op != NOP, delta), stats


def tiered_upsert_edges(tg: TieredGraph, src, dst, w=None,
                        valid: Optional[torch.Tensor] = None) -> TieredGraph:
    """Insert-or-replace over tiered storage (host-orchestrated)."""
    if valid is None:
        valid = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    tg = _unseal_written(tg, src, valid)
    delta = upsert_edges(tg.delta, src, dst, w, valid)
    return _stamp(tg, src, valid, delta)


def _csr_purge_vertices(g: CSRGraph, vids: torch.Tensor,
                        sealed: torch.Tensor) -> CSRGraph:
    """Drop every run edge incident to ``vids`` (NULL entries inert) and
    the retired lanes; the packed prefix is restored at unchanged
    capacity."""
    ok = _live_lanes(g, sealed)
    bad = torch.isin(g.row, vids) | (torch.isin(g.indices, vids) & ok)
    out, _ = _csr_build(g.row, g.indices, g.weights, ok & ~bad, nv=g.nv,
                        capacity=g.capacity)
    return out


def tiered_delete_vertices(tg: TieredGraph,
                           vids: torch.Tensor) -> TieredGraph:
    """UpdateVertex(delete) over both tiers: the delta frees chains and
    sweeps in-edges, the run drops every incident lane (and the retired
    ones)."""
    vids = vids.to(I32)
    delta = delete_vertices(tg.delta, vids)
    runs = tg.runs
    if tg.run_capacity > 0:
        runs = (tuple(_csr_purge_vertices(g, vids, tg.sealed)
                      for g in tg.runs) if tg.is_sharded
                else _csr_purge_vertices(tg.runs, vids, tg.sealed))
    nvc = tg.capacity_vertices
    rows = vids[(vids != NULL) & (vids >= 0) & (vids < nvc)].long()
    sealed = tg.sealed.clone()
    sealed[rows] = False
    wgen = tg.wgen + 1
    v_epoch = tg.v_epoch.clone()
    v_epoch[rows] = wgen
    return dataclasses.replace(tg, delta=delta, runs=runs, sealed=sealed,
                               v_epoch=v_epoch, wgen=wgen,
                               run_version=tg.run_version + 1, run_retired=0)


def tiered_add_vertices(tg: TieredGraph, k) -> TieredGraph:
    from repro_torch.core.updates import add_vertices
    return dataclasses.replace(tg, delta=add_vertices(tg.delta, k))


# ---------------------------------------------------------------------------
# Maintenance transforms on the delta (tier bookkeeping preserved)
# ---------------------------------------------------------------------------

def _csr_grow_nv(g: CSRGraph, new_nv: int) -> CSRGraph:
    """Extend the run's vertex space (offsets pad flat, the pad marker
    moves; the lanes and the push stream keep their order)."""
    if new_nv <= g.nv:
        return g
    k = new_nv - g.nv
    offsets = torch.cat([g.offsets, g.offsets[-1:].expand(k)])
    push_ptr = torch.cat([g.push_ptr, g.push_ptr[-1:].expand(k)])
    return CSRGraph(offsets=offsets, indices=g.indices, weights=g.weights,
                    row=torch.where(g.row == g.nv, new_nv, g.row), nv=new_nv,
                    push_src=g.push_src, push_w=g.push_w, push_ptr=push_ptr,
                    n_live=g.n_live)


def tiered_grow(tg: TieredGraph, num_blocks: Optional[int] = None,
                vertex_capacity: Optional[int] = None) -> TieredGraph:
    """Grow the delta's capacity; the run tier only tracks the vertex-space
    extension (sealed data never moves on a grow)."""
    if tg.is_sharded:
        from repro_torch.distributed.graph import grow_sharded
        delta = grow_sharded(tg.delta, num_blocks=num_blocks,
                             vertex_capacity=vertex_capacity)
    else:
        from repro_torch.core.cblist import grow
        delta = grow(tg.delta, num_blocks=num_blocks,
                     vertex_capacity=vertex_capacity)
    runs, sealed, v_epoch = tg.runs, tg.sealed, tg.v_epoch
    nvc = tg.capacity_vertices
    if vertex_capacity is not None and vertex_capacity > nvc:
        k = vertex_capacity - nvc
        dev = tg.device
        sealed = torch.cat([sealed, torch.zeros(k, dtype=torch.bool,
                                                device=dev)])
        v_epoch = torch.cat([v_epoch, torch.zeros(k, dtype=I32, device=dev)])
        runs = (tuple(_csr_grow_nv(g, vertex_capacity) for g in runs)
                if tg.is_sharded else _csr_grow_nv(runs, vertex_capacity))
    return dataclasses.replace(tg, delta=delta, runs=runs, sealed=sealed,
                               v_epoch=v_epoch)
