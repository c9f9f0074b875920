"""Fanout neighbour sampling over CBList chains (GraphSAGE-style).

For each seed vertex draw up to ``fanout[h]`` neighbours per hop.  A draw
is a rank ``r ~ U[0, deg)`` and a chain walk to the block holding rank
``r`` (blocks are rank-contiguous per chain): O(level) dependent block
fetches, the pointer chase the paper's prefetch targets.  The walk is the
``chain_walk`` kernel's rank entry point on the card.

The draw and the walk are separate functions, so a test can hand
:func:`rank_neighbors` the ranks that another generator drew.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.blockstore import I32, NULL
from repro_torch.core.cblist import CBList
from repro_torch.kernels import chain_walk


class SampledGraph(NamedTuple):
    """Padded sampled subgraph in layered COO (hop h edges: layer == h)."""
    src: torch.Tensor     # i32[E_max] (global vertex ids)
    dst: torch.Tensor     # i32[E_max]
    layer: torch.Tensor   # i32[E_max]
    valid: torch.Tensor   # bool[E_max]
    seeds: torch.Tensor   # i32[n_seeds]


def _vertex_rows(cbl: CBList, verts: torch.Tensor) -> torch.Tensor:
    """Vertex-table rows of ``verts`` as an index gather reads them:
    negative ids count from the end, the rest clamp into the table."""
    nv = cbl.capacity_vertices
    v = verts.long()
    return torch.where(v < 0, v + nv, v).clamp(0, nv - 1)


def draw_ranks(cbl: CBList, verts: torch.Tensor, generator: torch.Generator,
               k: int) -> torch.Tensor:
    """i32[V, k] ranks uniform in ``[0, max(deg, 1))`` per vertex."""
    deg = cbl.v_deg[_vertex_rows(cbl, verts)].clamp(min=1)
    u = torch.rand((verts.shape[0], k), generator=generator,
                   dtype=torch.float64, device=cbl.device)
    return torch.minimum((u * deg[:, None]).to(I32), (deg - 1)[:, None])


def rank_neighbors(cbl: CBList, verts: torch.Tensor, ranks: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neighbours i32[V, k], valid bool[V, k]): the key at each rank of
    each vertex's chain; vertices with degree 0 yield no samples."""
    rows = _vertex_rows(cbl, verts)
    deg = cbl.v_deg[rows]
    heads = torch.where(deg > 0, cbl.v_head[rows], NULL).to(I32)
    st = cbl.store
    out = chain_walk.rank_walk(st.keys, st.count, st.nxt,
                               heads.contiguous(), ranks.to(I32).contiguous())
    return out, (deg > 0)[:, None] & (out != NULL)


def _sample_neighbors(cbl: CBList, verts: torch.Tensor,
                      generator: torch.Generator, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw up to k neighbours (with replacement) per vertex in ``verts``
    (over both tiers of a :class:`~repro_torch.core.tiered.TieredGraph`,
    routed to the owning shard on a
    :class:`~repro_torch.distributed.graph.ShardedCBList`)."""
    if not isinstance(cbl, CBList):
        from repro_torch.core.tiered import (TieredGraph,
                                             tiered_sample_neighbors)
        if isinstance(cbl, TieredGraph):
            return tiered_sample_neighbors(cbl, verts, generator, k)
        from repro_torch.distributed.graph import sharded_sample_neighbors
        return sharded_sample_neighbors(cbl, verts, generator, k)
    return rank_neighbors(cbl, verts, draw_ranks(cbl, verts, generator, k))


def sample_subgraph(cbl: CBList, seeds: torch.Tensor,
                    generator: torch.Generator,
                    fanout: Sequence[int] = (15, 10)) -> SampledGraph:
    """Layered fanout sampling from ``seeds``; fixed shapes per fanout.

    The frontier's validity mask carries across hops: a lane whose draw
    failed (or whose parent lane was already invalid) is parked at vertex 0
    as shape padding, and every edge it emits downstream stays invalid.
    """
    frontier = seeds.to(I32)
    alive = torch.ones(seeds.shape, dtype=torch.bool, device=seeds.device)
    srcs, dsts, layers, valids = [], [], [], []
    for h, k in enumerate(fanout):
        nbrs, ok = _sample_neighbors(cbl, frontier, generator, k)
        ok = ok & alive[:, None]
        src = frontier.repeat_interleave(k)
        srcs.append(src)
        dsts.append(nbrs.reshape(-1))
        layers.append(torch.full(src.shape, h, dtype=I32,
                                 device=src.device))
        valids.append(ok.reshape(-1))
        alive = ok.reshape(-1)
        frontier = torch.where(alive, nbrs.reshape(-1), 0)
    return SampledGraph(src=torch.cat(srcs), dst=torch.cat(dsts),
                        layer=torch.cat(layers), valid=torch.cat(valids),
                        seeds=seeds)
