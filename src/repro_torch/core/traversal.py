"""Traversal operations and stream partitioning (paper §2.1, §5.2).

Data-access operations (scan_vertices / scan_vertices(cond) / read_vertex /
scan_edges(v_src) and the live-lane mask every sweep uses) and the two
load-balancing partition strategies:

  * **vertex-table partition**: contiguous vertex ranges per stream; cheap
    but skew-sensitive (a super-vertex unbalances a stream);
  * **GTChain partition**: contiguous *block* ranges per stream in global
    traversal chain order; balanced because every block holds at most
    ``block_width`` edges whatever the degree skew.

The GTChain partition also places the shards of
:mod:`repro_torch.distributed.graph` (:func:`make_placement_plan`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import I32, NULL, PAD, arange32
from repro_torch.core.cblist import CBList


def lane_mask(store: bs.BlockStore) -> torch.Tensor:
    """bool[NB, B]: live edge lanes (block owned and lane < count)."""
    lane = arange32(store.block_width, store.device)
    return (lane[None, :] < store.count[:, None]) \
        & (store.owner != NULL)[:, None]


def scan_vertices(cbl: CBList) -> torch.Tensor:
    """All live logical vertex ids mask (scan_vertices())."""
    return arange32(cbl.capacity_vertices, cbl.device) < cbl.n_vertices


def read_vertex(cbl: CBList, v):
    """read_vertex(v): the vertex record."""
    return dict(deg=cbl.v_deg[v], level=cbl.v_level[v],
                head=cbl.v_head[v], tail=cbl.v_tail[v])


def scan_edges(cbl: CBList, v, max_degree: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """scan_edges(v_src): neighbours of one vertex, padded to ``max_degree``.

    A chain walk of ``ceil(max_degree / B)`` block fetches (GetNeighbors,
    Alg. 2).  Returns (dst[max_degree], w[max_degree], valid[max_degree]).
    """
    st = cbl.store
    B = st.block_width
    n_blocks = -(-max_degree // B)
    cur = cbl.v_head[v]
    ks, vs, cnt = [], [], []
    for _ in range(n_blocks):
        on = cur != NULL
        safe = cur.clamp(min=0).long()
        ks.append(torch.where(on, st.keys[safe], PAD))
        vs.append(torch.where(on, st.vals[safe], 0.0))
        cnt.append(torch.where(on, st.count[safe], 0))
        cur = torch.where(on, st.nxt[safe], NULL)
    lane = arange32(B, cbl.device)
    valid = lane[None, :] < torch.stack(cnt)[:, None]
    return (torch.stack(ks).reshape(-1)[:max_degree],
            torch.stack(vs).reshape(-1)[:max_degree],
            valid.reshape(-1)[:max_degree])


def scan_vertices_cond(cbl: CBList, cond: torch.Tensor) -> torch.Tensor:
    """scan_vertices(cond): conditional filtering during the traversal."""
    return scan_vertices(cbl) & cond


# ---------------------------------------------------------------------------
# Partition strategies (§5.2)
# ---------------------------------------------------------------------------

class Partition(NamedTuple):
    """N streams over either vertices or GTChain blocks."""
    kind: str              # "vertex" | "gtchain"
    starts: torch.Tensor   # i32[N]
    stops: torch.Tensor    # i32[N]


def vertex_table_partition(cbl: CBList, n_streams: int) -> Partition:
    """Contiguous ranges over the *live* vertices (``n_vertices``), not the
    table capacity: trailing streams over padding would hold no edges and
    make the balance statistic lie under low table fill."""
    nv = cbl.n_vertices.to(I32)
    bounds = (arange32(n_streams + 1, cbl.device) * nv) // n_streams
    return Partition("vertex", bounds[:-1], bounds[1:])


def gtchain_partition(cbl: CBList, n_streams: int) -> Partition:
    """Fine-grained partition: equal **block** counts per stream (X/N
    blocks)."""
    live = (cbl.store.owner != NULL).sum()
    bounds = torch.arange(n_streams + 1, dtype=torch.float32,
                          device=cbl.device) / n_streams     # i / N, 1.0 last
    bounds = (bounds * live.to(torch.float32)).to(I32)
    return Partition("gtchain", bounds[:-1], bounds[1:])


# ---------------------------------------------------------------------------
# Placement plan: the GTChain partition promoted from a statistic to the
# placement of data and work (repro_torch.distributed.graph consumes it)
# ---------------------------------------------------------------------------

class PlacementPlan(NamedTuple):
    """GTChain-balanced shard placement for a CBList.

    Shard boundaries fall on vertex boundaries (a chain lives wholly on the
    shard owning its vertex) but are chosen by cumulative block count, so
    every shard holds about ``total_blocks / n_shards`` blocks whatever the
    degree skew.  Ids stay global: a shard-local CBList keeps the whole
    vertex-id space and holds only the chains it owns.
    """
    n_shards: int                    # shard count
    vertex_bounds: tuple             # (n_shards + 1,) host ints
    vertex_shard: torch.Tensor       # i32[NV_cap] vertex -> owning shard
    block_shard: torch.Tensor        # i32[NB] block -> shard (NULL = free)
    halo: Optional[torch.Tensor]     # bool[S, NV_cap] or None (opt-in)
    blocks_per_shard: tuple          # per-shard live block counts (host)


def make_placement_plan(cbl: CBList, n_shards: int,
                        with_halo: bool = False) -> PlacementPlan:
    """Derive the block-balanced vertex cut on the device.

    Boundary k is the first vertex whose cumulative chain-block count
    reaches ``k / n_shards`` of the total: the GTChain partition rounded
    outward to vertex boundaries, so chains never straddle a shard.  The
    bounds and per-shard block counts come back to the host in one read.

    ``with_halo=True`` also builds the halo sets (shard s stores an edge
    into v owned by another shard); the sweeps never need them, and
    :func:`repro_torch.distributed.graph.halo_masks` gives the live
    statistic.
    """
    dev = cbl.device
    nvc = cbl.capacity_vertices
    cum = torch.cumsum(cbl.v_level.double(), 0)
    total = cum[-1] if nvc else torch.zeros((), dtype=torch.float64,
                                            device=dev)
    targets = (torch.arange(1, n_shards, dtype=torch.float64, device=dev)
               * (total / max(n_shards, 1)))
    inner = torch.searchsorted(cum, targets)
    bounds = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), inner,
                        torch.full((1,), nvc, dtype=torch.int64,
                                   device=dev)])
    bounds = torch.cummax(bounds, 0)[0]              # monotone (empty ok)
    vertex_shard = torch.searchsorted(bounds[1:], torch.arange(
        nvc, dtype=torch.int64, device=dev), right=True)
    vertex_shard = vertex_shard.clamp(max=n_shards - 1).to(I32)
    owner = cbl.store.owner
    block_shard = torch.where(owner == NULL, NULL,
                              vertex_shard[owner.clamp(min=0).long()])
    per = torch.bincount(block_shard[block_shard != NULL].long(),
                         minlength=n_shards)[:n_shards]
    host = torch.cat([bounds, per]).tolist()

    halo = None
    if with_halo:
        st = cbl.store
        live = lane_mask(st)
        src_shard = block_shard[:, None].expand_as(st.keys)
        dst = st.keys.clamp(0, nvc - 1).long()
        remote = live & (vertex_shard[dst] != src_shard)
        halo = torch.zeros((n_shards, nvc), dtype=torch.bool, device=dev)
        halo[src_shard[remote].long(), dst[remote]] = True

    return PlacementPlan(
        n_shards=n_shards,
        vertex_bounds=tuple(int(b) for b in host[:n_shards + 1]),
        vertex_shard=vertex_shard, block_shard=block_shard, halo=halo,
        blocks_per_shard=tuple(int(b) for b in host[n_shards + 1:]))


def partition_balance(cbl: CBList, part: Partition) -> torch.Tensor:
    """Max/mean edges per stream (1.0 = perfect): the paper's motivation
    for the GTChain partition is driving this toward 1 under degree
    skew."""
    zero = torch.zeros(1, dtype=torch.int64, device=cbl.device)
    if part.kind == "vertex":
        csum = torch.cat([zero, torch.cumsum(cbl.v_deg, 0)])
    else:
        order = bs.gtchain_order(cbl.store)
        csum = torch.cat([zero, torch.cumsum(cbl.store.count[order], 0)])
    per = (csum[part.stops.long()] - csum[part.starts.long()]).to(I32)
    mean = (per.sum().to(torch.float32) / per.shape[0]).clamp(min=1)
    return per.max().to(torch.float32) / mean
