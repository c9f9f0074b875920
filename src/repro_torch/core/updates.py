"""Batched graph updates on CBList (BatchUpdate / UpdateEdge / UpdateVertex).

Update tasks are classified by source vertex with one sort by (src, dst)
plus segment arithmetic; the per-task interleaving of the paper becomes
data parallelism over the batch.

  * deletes: chain-walk *locate* (the FindNeighbor coroutine of Alg. 2,
    vectorised over the batch), then lane masking and an in-block re-sort;
  * inserts: tail-slack fill first, then newly allocated blocks (O(1)
    append); blocks stay sorted internally and chains may overlap in range
    until the next rebuild.

Mutators are pure: they clone before they write, so a caller's CBList (a
pinned snapshot, or the service's pre-update state kept for the grow-retry)
is never changed.  Every entry point also takes a
:class:`~repro_torch.core.tiered.TieredGraph` and dispatches to its
``tiered_*`` counterpart (writes to sealed vertices unseal them first), and
a :class:`~repro_torch.distributed.graph.ShardedCBList`, whose writes route
to the shard that owns their source.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import I32, NULL, PAD, arange32, full32
from repro_torch.core.cblist import CBList, exclusive_cumsum
from repro_torch.kernels import chain_walk

INSERT = 1
DELETE = -1
NOP = 0


class UpdateStats(NamedTuple):
    """Per-batch accounting of :func:`batch_update_stats`.

    ``dropped_edges`` counts inserts that found no free block; the returned
    CBList stays consistent (it lacks those edges), and the caller grows
    capacity and re-applies the batch to the pre-update CBList.
    """
    dropped_edges: torch.Tensor    # i32[]
    applied_inserts: torch.Tensor  # i32[]
    applied_deletes: torch.Tensor  # i32[]


def _locate(cbl: CBList, qsrc: torch.Tensor, qdst: torch.Tensor,
            active: torch.Tensor):
    """Chain-walk locate of (src, dst) -> (found_blk, found_lane), NULL when
    absent: the ``chain_walk`` kernel on the card, its plain host loop on
    the CPU (first hit in chain order wins)."""
    st = cbl.store
    return chain_walk.locate(st.keys, st.nxt, cbl.v_head, qsrc.contiguous(),
                             qdst.contiguous(), active.contiguous())


def read_edges(cbl: CBList, qsrc: torch.Tensor, qdst: torch.Tensor,
               active: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched read_edge(v_src, v_dst): (found, weight).  Lanes with
    ``active`` False report not found without walking.  Makes no host sync
    on the card."""
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import TieredGraph, tiered_read_edges
        if isinstance(cbl, TieredGraph):
            return tiered_read_edges(cbl, qsrc, qdst, active)
        from repro_torch.distributed.graph import sharded_read_edges
        return sharded_read_edges(cbl, qsrc, qdst, active)
    if active is None:
        active = torch.ones(qsrc.shape, dtype=torch.bool, device=qsrc.device)
    fblk, flane = _locate(cbl, qsrc, qdst, active)
    found = fblk != NULL
    w = cbl.store.vals[fblk.clamp(min=0).long(), flane.clamp(min=0).long()]
    return found, torch.where(found, w, 0.0)


def _dedupe_first(src, dst, mask):
    """Keep only the first occurrence of each (src, dst) among mask=True."""
    pad = torch.full_like(src, PAD)
    key = bs.composite_key(torch.where(mask, src, pad),
                           torch.where(mask, dst, pad))
    skey, order = torch.sort(key, stable=True)
    first = torch.ones_like(mask)
    first[1:] = skey[1:] != skey[:-1]
    keep = torch.zeros_like(mask)
    keep[order] = first & mask[order]
    return keep & mask


def _apply_deletes(cbl: CBList, src, dst, mask):
    mask = _dedupe_first(src, dst, mask)
    fblk, flane = _locate(cbl, src, dst, mask)
    found = mask & (fblk != NULL)
    st = cbl.store
    nb = st.num_blocks
    rows, lanes = fblk[found].long(), flane[found].long()
    keys = st.keys.clone()
    vals = st.vals.clone()
    keys[rows, lanes] = PAD
    vals[rows, lanes] = 0.0
    count = st.count - bs.segment_count(fblk, found, nb)
    st = st._replace(keys=keys, vals=vals, count=count)
    st = bs.sort_blocks(st, fblk[found])
    removed_per_v = bs.segment_count(src, found, cbl.capacity_vertices)
    return (cbl._replace(store=st, v_deg=cbl.v_deg - removed_per_v),
            found.sum().to(I32))


def _apply_inserts(cbl: CBList, src, dst, w, mask):
    U = src.shape[0]
    st = cbl.store
    B = st.block_width
    nb = st.num_blocks
    nvc = cbl.capacity_vertices
    dev = cbl.device

    # ---- classify by source vertex: sort by (src, dst), pads last --------
    pad = torch.full_like(src, PAD)
    order = bs.stable_argsort(bs.composite_key(torch.where(mask, src, pad),
                                               torch.where(mask, dst, pad)))
    s, d, ww, ok = src[order], dst[order], w[order], mask[order]
    # a source outside [0, capacity) has no vertex row: its lanes read the
    # row an index gather reads (negative ids count from the end, the rest
    # clamp) so that ``placed`` and the counts are the JAX package's, and
    # they are never stored (it writes them into some block)
    s_safe = torch.where(ok, s, torch.zeros_like(s)).long()
    s_safe = torch.where(s_safe < 0, s_safe + nvc, s_safe).clamp(0, nvc - 1)
    s_in = (s >= 0) & (s < nvc)

    c = bs.segment_count(s, ok, nvc)

    tail = cbl.v_tail
    has_tail = tail != NULL
    tail_safe = tail.clamp(min=0).long()
    tail_cnt = torch.where(has_tail, st.count[tail_safe], 0)
    slack = torch.where(has_tail, B - tail_cnt, 0)
    used_slack = torch.minimum(slack, c)
    need = (c - slack).clamp(min=0)
    nb_new = -(-need // B)                               # ceil

    # ---- allocate new blocks (free-stack pop, GTChain-ascending) ---------
    # The free stack pops in slot order, so allocation failures are a
    # *suffix* of the slot sequence: each vertex gets a prefix of its
    # requested chain extension, and an allocated block always receives
    # all of its intended edges.
    avail = st.free_top                                  # blocks left pre-pop
    total_new = nb_new.sum().to(I32)
    st, nid = bs.alloc_blocks(st, U, total_new)          # i32[U], NULL past end
    offs = exclusive_cumsum(nb_new)                      # per-vertex first slot
    cum = torch.cumsum(nb_new, 0).to(I32)
    j = arange32(U, dev)
    v_of_j = torch.searchsorted(cum, j, right=True).to(I32)
    j_ok = j < total_new
    alloc_ok = j_ok & (j < avail)                        # nid[j] != NULL
    v_safe = torch.where(j_ok, v_of_j.clamp(max=nvc - 1),
                         torch.zeros_like(v_of_j)).long()
    q = j - offs[v_safe]                                 # chain-local index

    a_ids = nid[alloc_ok].long()
    owner = st.owner.clone()
    owner[a_ids] = v_safe[alloc_ok].to(I32)              # j_ok holds here
    seq = st.seq.clone()
    seq[a_ids] = (cbl.v_level[v_safe] + q)[alloc_ok]
    # chain links among new blocks: slot j -> slot j+1 when same vertex
    # (nid[j+1] is NULL when slot j+1 failed — the right end-of-chain value)
    nxt_same = torch.zeros(U, dtype=torch.bool, device=dev)
    nxt_same[:-1] = v_of_j[1:] == v_of_j[:-1]
    nxt_tgt = full32(U, NULL, dev)
    nxt_tgt[:-1] = nid[1:]
    nxt = st.nxt.clone()
    nxt[a_ids] = torch.where(nxt_same & j_ok, nxt_tgt, NULL)[alloc_ok]
    # link old tail -> first new block / set head when chain was empty
    is_first = alloc_ok & (q == 0)
    old_tail = tail[v_safe]
    link = is_first & (old_tail != NULL)
    nxt[old_tail[link].long()] = nid[link]
    head = is_first & (old_tail == NULL)
    v_head = cbl.v_head.clone()
    v_head[v_safe[head]] = nid[head]
    # per-vertex blocks actually allocated (prefix of the requested chain)
    nb_got = bs.segment_count(v_safe, alloc_ok, nvc)
    is_last = alloc_ok & (q == nb_got[v_safe] - 1)
    v_tail = cbl.v_tail.clone()
    v_tail[v_safe[is_last]] = nid[is_last]

    # new block fill counts
    new_cnt = (need[v_safe] - q * B).clamp(0, B)
    count = st.count.clone()
    count[a_ids] = torch.where(j_ok, new_cnt, 0)[alloc_ok]
    # old tail gains used_slack
    bump = (used_slack > 0) & has_tail
    count[tail[bump].long()] += used_slack[bump]

    # ---- place edges ------------------------------------------------------
    vstart = exclusive_cumsum(c)
    r = arange32(U, dev) - vstart[s_safe]                # per-vertex rank
    in_slack = r < slack[s_safe]
    r2 = r - slack[s_safe]
    slot = offs[s_safe] + torch.div(r2, B, rounding_mode="floor")
    new_blk = nid[slot.clamp(0, U - 1).long()]
    placed = ok & (in_slack | (slot < avail))            # edge has a real home
    dropped = (ok & ~placed).sum().to(I32)
    placed = placed & s_in                               # counted, not stored
    e_blk = torch.where(in_slack, tail[s_safe], new_blk)
    e_lane = torch.where(in_slack, tail_cnt[s_safe] + r, r2 % B)
    rows = e_blk[placed].long()
    lanes = e_lane.clamp(0, B - 1)[placed].long()
    keys = st.keys.clone()
    vals = st.vals.clone()
    keys[rows, lanes] = d[placed]
    vals[rows, lanes] = ww[placed]

    st = st._replace(keys=keys, vals=vals, count=count, owner=owner,
                     nxt=nxt, seq=seq)
    # restore in-block sorted order for every touched block
    st = bs.sort_blocks(st, torch.cat([e_blk[placed], nid[alloc_ok]]))

    c_placed = bs.segment_count(s, placed, nvc)
    return (cbl._replace(store=st, v_deg=cbl.v_deg + c_placed,
                         v_level=cbl.v_level + nb_got,
                         v_head=v_head, v_tail=v_tail),
            dropped)


def _defaults(src, w, op):
    if w is None:
        w = torch.ones(src.shape, dtype=torch.float32, device=src.device)
    if op is None:
        op = torch.full(src.shape, INSERT, dtype=I32, device=src.device)
    return w, op


def batch_update_stats(cbl: CBList, src: torch.Tensor, dst: torch.Tensor,
                       w: Optional[torch.Tensor] = None,
                       op: Optional[torch.Tensor] = None
                       ) -> Tuple[CBList, UpdateStats]:
    """Apply a batch of edge updates (paper's BatchUpdate) and count it.

    ``op``: +1 insert, -1 delete, 0 nop.  All deletions run before all
    insertions, whatever their position in the batch; inserts of present
    edges create parallel edges (:func:`upsert_edges` replaces).
    ``stats.dropped_edges > 0`` means the free stack ran out mid-batch: grow
    capacity and re-apply the batch to the *pre-update* CBList.
    """
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import (TieredGraph,
                                             tiered_batch_update_stats)
        if isinstance(cbl, TieredGraph):
            return tiered_batch_update_stats(cbl, src, dst, w, op)
        from repro_torch.distributed.graph import sharded_batch_update_stats
        return sharded_batch_update_stats(cbl, src, dst, w, op)
    w, op = _defaults(src, w, op)
    cbl, n_del = _apply_deletes(cbl, src, dst, op == DELETE)
    cbl, dropped = _apply_inserts(cbl, src, dst, w, op == INSERT)
    n_ins = (op == INSERT).sum().to(I32) - dropped
    return cbl, UpdateStats(dropped_edges=dropped, applied_inserts=n_ins,
                            applied_deletes=n_del)


def batch_update(cbl: CBList, src: torch.Tensor, dst: torch.Tensor,
                 w: Optional[torch.Tensor] = None,
                 op: Optional[torch.Tensor] = None) -> CBList:
    """Apply a batch of edge updates (paper's BatchUpdate): all deletes,
    then all inserts, whatever their position in the batch; inserts past
    the allocator's capacity are dropped consistently
    (:func:`batch_update_stats` counts them)."""
    cbl, _ = batch_update_stats(cbl, src, dst, w, op)
    return cbl


def upsert_edges(cbl: CBList, src, dst, w=None,
                 valid: Optional[torch.Tensor] = None) -> CBList:
    """Insert-or-replace: deletes any existing (src, dst) first."""
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import TieredGraph, tiered_upsert_edges
        if isinstance(cbl, TieredGraph):
            return tiered_upsert_edges(cbl, src, dst, w, valid)
        from repro_torch.distributed.graph import sharded_upsert_edges
        return sharded_upsert_edges(cbl, src, dst, w, valid)
    w, _ = _defaults(src, w, None)
    if valid is None:
        valid = torch.ones(src.shape, dtype=torch.bool, device=src.device)
    cbl, _ = _apply_deletes(cbl, src, dst, valid)
    cbl, _ = _apply_inserts(cbl, src, dst, w, valid)
    return cbl


def _delete_vertex_chains(cbl: CBList, vids: torch.Tensor) -> CBList:
    """Free the victims' whole chains and clear their vertex-table rows."""
    st = cbl.store
    victims = vids[vids != NULL]
    is_victim_blk = torch.isin(st.owner, victims)
    blk_ids = torch.where(is_victim_blk, arange32(st.num_blocks, cbl.device),
                          NULL)
    st = bs.free_blocks(st, blk_ids)
    rows = victims[victims < cbl.capacity_vertices].long()

    def clear(x, fill):
        x = x.clone()
        x[rows] = fill
        return x

    return cbl._replace(store=st, v_deg=clear(cbl.v_deg, 0),
                        v_level=clear(cbl.v_level, 0),
                        v_head=clear(cbl.v_head, NULL),
                        v_tail=clear(cbl.v_tail, NULL))


def _sweep_in_edges(cbl: CBList, vids: torch.Tensor) -> CBList:
    """Masked sweep of every block for keys in ``vids`` with per-owner
    degree correction (runs after the chain free)."""
    st = cbl.store
    nvc = cbl.capacity_vertices
    vs = torch.sort(torch.where(vids == NULL, PAD, vids))[0]
    pos = torch.searchsorted(vs, st.keys)
    hit = vs[pos.clamp(max=vs.shape[0] - 1)] == st.keys
    hit = hit & (st.keys != PAD)
    removed_per_blk = hit.sum(1).to(I32)
    keys = torch.where(hit, PAD, st.keys)
    vals = torch.where(hit, 0.0, st.vals)
    keys, order = torch.sort(keys, dim=1, stable=True)
    vals = torch.gather(vals, 1, order)
    removed_per_v = bs.segment_sum_int(
        removed_per_blk, torch.where(st.owner == NULL, nvc, st.owner), nvc)
    st = st._replace(keys=keys, vals=vals, count=st.count - removed_per_blk)
    return cbl._replace(store=st, v_deg=cbl.v_deg - removed_per_v)


def delete_vertices(cbl: CBList, vids: torch.Tensor) -> CBList:
    """UpdateVertex(delete): frees the out-chains of ``vids`` (NULL entries
    ignored) and sweeps their in-edges out of every block."""
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import (TieredGraph,
                                             tiered_delete_vertices)
        if isinstance(cbl, TieredGraph):
            return tiered_delete_vertices(cbl, vids)
        from repro_torch.distributed.graph import sharded_delete_vertices
        return sharded_delete_vertices(cbl, vids)
    return _sweep_in_edges(_delete_vertex_chains(cbl, vids), vids)


def add_vertices(cbl: CBList, k) -> CBList:
    """UpdateVertex(add): append-only (aligned to max logical id)."""
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import TieredGraph, tiered_add_vertices
        if isinstance(cbl, TieredGraph):
            return tiered_add_vertices(cbl, k)
        from repro_torch.distributed.graph import sharded_add_vertices
        return sharded_add_vertices(cbl, k)
    return cbl._replace(n_vertices=cbl.n_vertices + int(k))
