"""CBList — GastCoCo's prefetch-aware dynamic graph structure, in torch.

The vertex table (``v_deg`` / ``v_level`` / ``v_head`` / ``v_tail``) over a
:class:`~repro_torch.core.blockstore.BlockStore` whose blocks hold sorted
destination ids and edge weights.  Blocks are allocated in vertex order at
build/compact time, so the physical block array is the global traversal
chain and whole-graph sweeps iterate blocks, never vertices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import (I32, NULL, PAD, BlockStore, arange32,
                                         full32)


class CBList(NamedTuple):
    store: BlockStore
    v_deg: torch.Tensor       # i32[NV] live out-degree
    v_level: torch.Tensor     # i32[NV] number of blocks in the chain
    v_head: torch.Tensor      # i32[NV] first block (NULL if none)
    v_tail: torch.Tensor      # i32[NV] last block (NULL if none)
    n_vertices: torch.Tensor  # i32[] live logical vertices

    @property
    def capacity_vertices(self) -> int:
        return self.v_deg.shape[0]

    @property
    def block_width(self) -> int:
        return self.store.block_width

    @property
    def device(self) -> torch.device:
        return self.v_deg.device

    @property
    def num_edges(self) -> torch.Tensor:
        return self.v_deg.sum()

    @property
    def max_chain(self) -> int:
        """Static upper bound on chain length (every block on one vertex)."""
        return self.store.num_blocks


def empty(num_vertices: int, num_blocks: int, block_width: int = 128,
          vertex_capacity: Optional[int] = None, device=None) -> CBList:
    """A CBList with no edges; every block on the free stack."""
    nv = vertex_capacity or num_vertices
    return CBList(store=bs.make_store(num_blocks, block_width, device),
                  v_deg=torch.zeros(nv, dtype=I32, device=device),
                  v_level=torch.zeros(nv, dtype=I32, device=device),
                  v_head=full32(nv, NULL, device),
                  v_tail=full32(nv, NULL, device),
                  n_vertices=torch.tensor(num_vertices, dtype=I32,
                                          device=device))


def exclusive_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(x)
    out[1:] = torch.cumsum(x, 0)[:-1].to(x.dtype)
    return out


def build_from_coo(src: torch.Tensor, dst: torch.Tensor,
                   w: Optional[torch.Tensor], *, num_vertices: int,
                   num_blocks: int, block_width: int = 128,
                   vertex_capacity: Optional[int] = None,
                   valid: Optional[torch.Tensor] = None) -> CBList:
    """Bulk-load a CBList from COO edges on their device (LoadGraph).

    Blocks are laid out in (src, dst)-sorted order, so the physical array is
    exactly the GTChain.  ``num_blocks`` must cover the ceil-per-vertex
    demand (:func:`blocks_needed`); entries with ``valid == False`` are
    ignored.
    """
    dev = src.device
    E = src.shape[0]
    B = block_width
    nv = vertex_capacity or num_vertices
    src = src.to(I32)
    dst = dst.to(I32)
    w = (torch.ones(E, dtype=torch.float32, device=dev) if w is None
         else w.to(torch.float32))
    if valid is None:
        valid = torch.ones(E, dtype=torch.bool, device=dev)

    pad = full32(E, PAD, dev)
    order = bs.stable_argsort(bs.composite_key(torch.where(valid, src, pad),
                                               torch.where(valid, dst, pad)))
    s, d, ww, ok = src[order], dst[order], w[order], valid[order]

    deg = bs.segment_count(s, ok, nv)
    nbv = -(-deg // B)                                   # ceil blocks per vertex
    boff = exclusive_cumsum(nbv)                         # first block per vertex
    vstart = exclusive_cumsum(deg)                       # first edge rank per vertex

    s_safe = torch.where(ok, s, torch.zeros_like(s)).long()
    rank = arange32(E, dev) - vstart[s_safe]             # rank within vertex
    blk = boff[s_safe] + rank // B
    lane = rank % B
    placed = ok & (blk < num_blocks)                     # past capacity: dropped
    blk_p, lane_p = blk[placed].long(), lane[placed].long()

    store = bs.make_store(num_blocks, B, dev)
    keys = store.keys
    vals = store.vals
    keys[blk_p, lane_p] = d[placed]
    vals[blk_p, lane_p] = ww[placed]
    count = bs.segment_count(blk, placed, num_blocks)
    owner = store.owner
    owner[blk_p] = s[placed]
    seq = store.seq
    seq[blk_p] = (rank // B)[placed]
    # chains are physically consecutive at build time
    ids = arange32(num_blocks, dev)
    has_next = (ids + 1 < num_blocks) & (owner != NULL)
    nxt_owner = torch.roll(owner, -1)
    nxt_seq = torch.roll(seq, -1)
    nxt = torch.where(has_next & (nxt_owner == owner) & (nxt_seq == seq + 1),
                      ids + 1, full32(num_blocks, NULL, dev))

    total_blocks = nbv.sum().to(I32)
    store = BlockStore(keys=keys, vals=vals, count=count, owner=owner,
                       nxt=nxt, seq=seq, free_stack=store.free_stack,
                       free_top=num_blocks - total_blocks)
    null = full32(nv, NULL, dev)
    return CBList(store=store, v_deg=deg, v_level=nbv,
                  v_head=torch.where(nbv > 0, boff, null),
                  v_tail=torch.where(nbv > 0, boff + nbv - 1, null),
                  n_vertices=torch.tensor(num_vertices, dtype=I32,
                                          device=dev))


def to_coo(cbl: CBList, max_edges: Optional[int] = None):
    """Live edges as padded COO ``(src, dst, w, valid)`` in GTChain order.

    ``max_edges`` defaults to the exact live lane count (loss-free); a
    smaller value raises instead of silently truncating.  Entries past the
    live count have ``valid=False`` and ``src=dst=0``.
    """
    st = cbl.store
    live_edges = int(torch.where(st.owner != NULL, st.count, 0).sum())
    if max_edges is None:
        max_edges = live_edges
    elif live_edges > max_edges:
        raise ValueError(
            f"to_coo: {live_edges} live edges exceed max_edges={max_edges}; "
            f"extraction would silently drop {live_edges - max_edges} edges")
    gt = bs.gtchain_order(st)
    keys = st.keys[gt]                        # [NB, B] in GTChain order
    owner = st.owner[gt]
    lane = arange32(st.block_width, st.device)
    live = (lane[None, :] < st.count[gt][:, None]) & (owner[:, None] != NULL)
    flat = torch.nonzero(live.reshape(-1)).squeeze(1)   # GTChain order kept
    n = flat.numel()
    src = torch.zeros(max_edges, dtype=I32, device=st.device)
    dst = torch.zeros(max_edges, dtype=I32, device=st.device)
    w = torch.zeros(max_edges, dtype=torch.float32, device=st.device)
    valid = torch.zeros(max_edges, dtype=torch.bool, device=st.device)
    src[:n] = owner[flat // st.block_width]
    dst[:n] = keys.reshape(-1)[flat]
    w[:n] = st.vals[gt].reshape(-1)[flat]
    valid[:n] = True
    return src, dst, w, valid


def rebuild(cbl: CBList, max_edges: Optional[int] = None,
            num_blocks: Optional[int] = None,
            block_width: Optional[int] = None) -> CBList:
    """Full defragmenting rebuild: extract live edges and bulk-load them
    again (range-disjoint sorted chains, GTChain contiguity 1.0)."""
    s, d, w, valid = to_coo(cbl, max_edges)
    nb = num_blocks or cbl.store.num_blocks
    bw = block_width or cbl.block_width
    nv = cbl.capacity_vertices
    return build_from_coo(s, d, w, num_vertices=nv, num_blocks=nb,
                          block_width=bw, vertex_capacity=nv,
                          valid=valid)._replace(n_vertices=cbl.n_vertices)


def compact_cbl(cbl: CBList) -> CBList:
    """Defragment the store *and* remap the vertex head/tail pointers."""
    order = bs.gtchain_order(cbl.store)
    inv = bs.inverse_permutation(order).to(I32)

    def remap(ids):
        return torch.where(ids == NULL, ids, inv[ids.clamp(min=0).long()])

    return cbl._replace(store=bs.compact(cbl.store),
                        v_head=remap(cbl.v_head), v_tail=remap(cbl.v_tail))


def grow(cbl: CBList, num_blocks: Optional[int] = None,
         vertex_capacity: Optional[int] = None) -> CBList:
    """Grow block and/or vertex capacity (pure pads, ids stay valid)."""
    store = cbl.store
    if num_blocks is not None and num_blocks != store.num_blocks:
        store = bs.grow_store(store, num_blocks)
    v_deg, v_level = cbl.v_deg, cbl.v_level
    v_head, v_tail = cbl.v_head, cbl.v_tail
    nv = cbl.capacity_vertices
    if vertex_capacity is not None and vertex_capacity > nv:
        k = vertex_capacity - nv
        dev = cbl.device
        zeros = torch.zeros(k, dtype=I32, device=dev)
        nulls = full32(k, NULL, dev)
        v_deg = torch.cat([v_deg, zeros])
        v_level = torch.cat([v_level, zeros])
        v_head = torch.cat([v_head, nulls])
        v_tail = torch.cat([v_tail, nulls])
    return CBList(store=store, v_deg=v_deg, v_level=v_level,
                  v_head=v_head, v_tail=v_tail, n_vertices=cbl.n_vertices)


def blocks_needed(src: torch.Tensor, num_vertices: int,
                  block_width: int) -> int:
    """Ceil-per-vertex block demand of a COO edge list (a host int)."""
    deg = torch.bincount(src.long(), minlength=num_vertices)
    return int((-(-deg // block_width)).sum())


def degrees(cbl: CBList) -> torch.Tensor:
    return cbl.v_deg


def block_fences(store: BlockStore):
    """Per-block [min, max] key fences (the B+ interior-node analogue)."""
    lane = arange32(store.block_width, store.device)
    mask = lane[None, :] < store.count[:, None]
    lo = store.keys[:, 0]
    hi = torch.where(mask, store.keys, full32(1, -1, store.device)).amax(dim=1)
    return lo, hi
