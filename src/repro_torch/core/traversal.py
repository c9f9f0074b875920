"""Traversal operations over a CBList (paper §2.1): scan_vertices,
read_vertex, scan_edges(v_src) and the live-lane mask every sweep uses."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import NULL, PAD, arange32
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
