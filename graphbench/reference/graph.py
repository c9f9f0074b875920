"""Plain PyTorch reference of the graph store and its analytics.

Independent of the program under test: it reads only the benchmark's own
stream (the live edge window as ``(src, dst, w)``) and computes what the
service must answer over it, on whatever device the tensors lie on.

* :func:`edge_table` / :func:`lookup` -- the live edge set as sorted keys
  with their weights, and point reads against it;
* :func:`pagerank` -- power iteration to a tolerance, damping 0.85, a
  vertex without out-edges spreading its rank over every vertex;
* :func:`bfs` -- directed levels from one source, -1 where unreached;
* :func:`sssp` -- directed weighted distances (Bellman-Ford over the
  vertices whose distance fell), ``inf`` where unreached;
* :func:`wcc` -- weakly connected components, each vertex labelled with
  the least vertex id of its component.

``store=`` holds the values in a lower precision between steps: the
control of the check (``torch.bfloat16``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def _held(x: torch.Tensor, store: Optional[torch.dtype]) -> torch.Tensor:
    return x if store is None else x.to(store).to(x.dtype)


def edge_table(src, dst, w, nv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(keys, w)``: the live edges' int64 keys ``src * nv + dst`` sorted,
    and their weights in that order."""
    keys, order = torch.sort(src.long() * nv + dst.long())
    return keys, w[order]


def lookup(table, qsrc, qdst, nv: int):
    """``(found, w)`` of each query pair in ``edge_table``'s table (w 0
    where absent)."""
    keys, w = table
    q = qsrc.long() * nv + qdst.long()
    pos = torch.searchsorted(keys, q).clamp(max=max(keys.numel() - 1, 0))
    found = keys[pos] == q if keys.numel() else torch.zeros_like(
        q, dtype=torch.bool)
    return found, torch.where(found, w[pos], torch.zeros_like(w[pos]))


def pagerank(src, dst, nv: int, *, damping: float = 0.85,
             dtype=torch.float64, store: Optional[torch.dtype] = None,
             tol: float = 1e-11, max_iters: int = 1000) -> torch.Tensor:
    """Ranks over the directed edges, from ``1 / nv``, until the L1 change
    of an iteration is under ``tol`` (or ``max_iters``)."""
    s, t = src.long(), dst.long()
    deg = torch.bincount(s, minlength=nv)
    inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1).to(dtype),
                      torch.zeros((), dtype=dtype, device=deg.device))
    dangling = deg == 0
    r = torch.full((nv,), 1.0 / nv, dtype=dtype, device=s.device)
    for _ in range(max_iters):
        acc = torch.zeros_like(r).index_add_(0, t, _held(r * inv, store)[s])
        new = _held((1 - damping) / nv
                    + damping * (acc + r[dangling].sum() / nv), store)
        delta = float((new - r).abs().sum())
        r = new
        if delta < tol:
            break
    return r


def bfs(src, dst, nv: int, source: int) -> torch.Tensor:
    """i32 levels from ``source`` over the directed edges, -1 unreached."""
    s, t = src.long(), dst.long()
    level = torch.full((nv,), -1, dtype=torch.int32, device=s.device)
    level[source] = 0
    frontier = torch.zeros(nv, dtype=torch.bool, device=s.device)
    frontier[source] = True
    depth = 0
    while bool(frontier.any()):
        depth += 1
        reached = torch.zeros_like(frontier)
        reached[t[frontier[s]]] = True
        frontier = reached & (level < 0)
        level[frontier] = depth
    return level


def sssp(src, dst, w, nv: int, source: int, *, dtype=torch.float64,
         store: Optional[torch.dtype] = None) -> torch.Tensor:
    """Distances from ``source`` over the directed weighted edges."""
    s, t = src.long(), dst.long()
    wt = _held(w.to(dtype), store)
    dist = torch.full((nv,), float("inf"), dtype=dtype, device=s.device)
    dist[source] = 0
    active = torch.zeros(nv, dtype=torch.bool, device=s.device)
    active[source] = True
    while bool(active.any()):
        m = active[s]
        new = dist.scatter_reduce(0, t[m], dist[s[m]] + wt[m], "amin")
        new = _held(new, store)
        active = new < dist
        dist = torch.minimum(dist, new)
    return dist


def wcc(src, dst, nv: int) -> torch.Tensor:
    """int64 least vertex id of each vertex's weakly connected component."""
    s, t = src.long(), dst.long()
    label = torch.arange(nv, device=s.device)
    while True:
        low = torch.minimum(label[s], label[t])
        new = label.scatter_reduce(0, t, low, "amin")
        new = new.scatter_reduce(0, s, low, "amin")
        new = new[new]                      # a label is a vertex of its part
        if torch.equal(new, label):
            return label
        label = new
