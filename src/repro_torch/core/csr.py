"""Sealed-CSR runs: the immutable, contiguous cold tier of the storage stack,
in torch.

The tiered store (:mod:`repro_torch.core.tiered`) seals cold vertices into
an immutable CSR run under the mutable CBList delta.  Contiguity buys the
fastest scans (one flat segment reduction over a dense edge array, no block
padding, no chain walks) at the price of in-place updates, which the sealed
tier never needs: a write *unseals* the vertex back into the delta.

Layout: a padded, fixed-capacity CSR.

  * ``offsets`` — i32[NV+1] row starts over the *live* prefix,
  * ``indices`` — i32[E_cap] destination ids, (src, dst)-sorted, live
    entries packed at the front,
  * ``weights`` — f32[E_cap],
  * ``row``     — i32[E_cap] source id per lane (``nv`` on padding lanes).

Beside them each run keeps what its reads and sweeps need, built once when
the run is made (never per call):

  * ``key`` — i64[E_cap], the (row, dst) composite key of every lane, sorted
    (padding lanes hold ``(nv, 0)``, past every live key), so a point read
    is one ``torch.searchsorted`` on the device;
  * the destination-ordered push stream ``push_src`` / ``push_w`` /
    ``push_ptr``: the live lanes whose destination is in range,
    stable-sorted by destination, as source and weight, with each
    destination's span — the layout of the engine's ``SweepPlan`` lanes, so
    a push sweep gathers ``x[src]`` with ``gather_rows`` and sums with
    ``segment_sum_csr`` without sorting;
  * ``n_live`` — the live lane count as a host int.

A pull sweep sums by ``row``, which is already the run's order, so it runs
``segment_sum_csr`` over ``offsets`` itself.  Merge-path partitions of both
streams are made once per feature width and cached on the run.

Every sweep takes ``impl=``: ``"torch"`` is the oracle (``index_add_`` /
``scatter_reduce`` over the lanes, as the JAX package's ``"xla"``),
``"cuda"`` sends the ``combine="sum"`` sweeps through the two kernels (their
plain versions when the tensors lie on the CPU).  ``min``/``max`` combines
stay on ``SEMIRINGS[...].segment_reduce``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Optional, Tuple

import torch

from repro_torch.backend import resolve_impl
from repro_torch.core.blockstore import (I32, NULL, PAD, arange32,
                                         composite_key, segment_count)
from repro_torch.core.engine import (SEMIRINGS, _default_edge_f,
                                     _gather_values)
from repro_torch.kernels import plan_patch
from repro_torch.kernels.segment_matmul.ops import (INT32_MAX,
                                                    csr_items_per_cta,
                                                    merge_path_partition,
                                                    segment_sum_csr)


@dataclasses.dataclass(frozen=True, eq=False)
class CSRGraph:
    """Immutable padded CSR over a static vertex space.

    Live edges are a packed, (src, dst)-sorted prefix of the lane arrays;
    padding lanes carry ``row == nv``.  The derived fields (``key``, the
    push stream, ``n_live``) are built from the four lane arrays when not
    given.
    """
    offsets: torch.Tensor   # i32[NV+1]
    indices: torch.Tensor   # i32[E_cap]
    weights: torch.Tensor   # f32[E_cap]
    row: torch.Tensor       # i32[E_cap]  source per lane; nv on padding
    nv: int
    key: Optional[torch.Tensor] = None        # i64[E_cap] sorted (row, dst)
    push_src: Optional[torch.Tensor] = None   # i32[P] source, dst order
    push_w: Optional[torch.Tensor] = None     # f32[P]
    push_ptr: Optional[torch.Tensor] = None   # i32[NV+1]
    n_live: Optional[int] = None
    _parts: dict = dataclasses.field(default_factory=dict, init=False,
                                     repr=False)

    def __post_init__(self):
        if self.n_live is None:
            object.__setattr__(self, "n_live", int(self.offsets[-1]))
        if self.key is None:
            object.__setattr__(self, "key",
                               composite_key(self.row, self.indices))
        if self.push_src is None:
            for name, value in zip(("push_src", "push_w", "push_ptr"),
                                   _push_stream(self)):
                object.__setattr__(self, name, value)

    @property
    def capacity(self) -> int:
        """Static lane capacity."""
        return self.indices.shape[0]

    @property
    def num_edges(self) -> torch.Tensor:
        return self.offsets[-1]

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def partition(self, stream: str, F: int) -> torch.Tensor:
        """Merge-path partition of the ``"push"`` stream (``push_ptr``) or
        the ``"pull"`` stream (``offsets``) at feature width ``F``."""
        cache_key = (stream, csr_items_per_cta(F))
        if cache_key not in self._parts:
            ptr = self.push_ptr if stream == "push" else self.offsets
            self._parts[cache_key] = merge_path_partition(ptr, cache_key[1])
        return self._parts[cache_key]


def _push_stream(g: CSRGraph):
    """(src, w, row_ptr) of the live lanes with an in-range destination,
    stable-sorted by destination: the engine's ``SweepPlan`` lanes layout."""
    nv = g.nv
    live = g.row[:g.n_live]
    dst = g.indices[:g.n_live]
    lanes = torch.nonzero((dst >= 0) & (dst < nv)).squeeze(1)
    if lanes.numel() > INT32_MAX:
        raise ValueError(f"csr run: {lanes.numel()} lanes do not fit an "
                         "int32 stream")
    sorted_dst, order = torch.sort(dst[lanes], stable=True)
    lanes = lanes[order]
    row_ptr = torch.searchsorted(sorted_dst, arange32(nv + 1, g.device),
                                 out_int32=True)
    return live[lanes].contiguous(), g.weights[lanes].contiguous(), row_ptr


def csr_empty(nv: int, capacity: int = 0, device=None) -> CSRGraph:
    return CSRGraph(offsets=torch.zeros(nv + 1, dtype=I32, device=device),
                    indices=torch.zeros(capacity, dtype=I32, device=device),
                    weights=torch.zeros(capacity, dtype=torch.float32,
                                        device=device),
                    row=torch.full((capacity,), nv, dtype=I32, device=device),
                    nv=nv)


def _csr_build(src, dst, w, valid, *, nv: int,
               capacity: int) -> Tuple[CSRGraph, int]:
    """(src, dst)-sort with invalid lanes last, keep the first ``capacity``
    lanes; (run, valid edges that did not fit)."""
    E = src.shape[0]
    if E < capacity:                        # pad inputs up to capacity
        pad = capacity - E

        def ext(x, fill):
            return torch.cat([x, torch.full((pad,), fill, dtype=x.dtype,
                                            device=x.device)])
        src, dst, w, valid = ext(src, 0), ext(dst, 0), ext(w, 0.0), \
            ext(valid, False)
    s_key = torch.where(valid, src, nv)
    d_key = torch.where(valid, dst, PAD)
    order = torch.sort(composite_key(s_key, d_key), stable=True)[1][:capacity]
    s, d, ww, ok = src[order], dst[order], w[order], valid[order]
    seg = torch.where(ok, s, nv)
    counts = segment_count(seg, ok, nv)
    offsets = torch.zeros(nv + 1, dtype=I32, device=src.device)
    offsets[1:] = torch.cumsum(counts, 0)
    g = CSRGraph(offsets=offsets,
                 indices=torch.where(ok, d, 0).to(I32),
                 weights=torch.where(ok, ww, 0.0),
                 row=torch.where(ok, s, nv).to(I32), nv=nv)
    return g, int(valid.sum() - ok.sum())


def csr_build_counted(src, dst, w=None, nv: Optional[int] = None, *,
                      capacity: Optional[int] = None,
                      valid=None) -> Tuple[CSRGraph, int]:
    """Bulk-load a CSR run; returns ``(csr, dropped)`` where ``dropped`` (a
    host int) is the number of valid edges that did not fit ``capacity``."""
    if nv is None:
        raise ValueError("csr_build needs nv (the static vertex capacity)")
    src = torch.as_tensor(src).to(I32)
    dst = torch.as_tensor(dst, device=src.device).to(I32)
    w = (torch.ones(src.shape, dtype=torch.float32, device=src.device)
         if w is None else torch.as_tensor(w, device=src.device)
         .to(torch.float32))
    valid = (torch.ones(src.shape, dtype=torch.bool, device=src.device)
             if valid is None else torch.as_tensor(valid, device=src.device)
             .to(torch.bool))
    return _csr_build(src, dst, w, valid, nv=int(nv),
                      capacity=int(capacity or src.shape[0]))


def csr_build(src, dst, w=None, nv: Optional[int] = None, *,
              capacity: Optional[int] = None, valid=None) -> CSRGraph:
    """Bulk-load a CSR run (loss-checked: raises on overflow)."""
    g, dropped = csr_build_counted(src, dst, w, nv, capacity=capacity,
                                   valid=valid)
    if dropped:
        raise ValueError(
            f"csr_build: {dropped} live edges exceed the lane capacity "
            f"{g.capacity} — size capacity from the live edge count")
    return g


def csr_degrees(g: CSRGraph,
                live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Out-degrees (the vertex-table surface of the sealed tier); with
    ``live`` (bool[nv]) the rows of the vertices it leaves out read 0."""
    deg = g.offsets[1:] - g.offsets[:-1]
    return deg if live is None else torch.where(live, deg, 0)


def _live_lanes(g: CSRGraph, live: Optional[torch.Tensor]) -> torch.Tensor:
    """bool[E_cap]: the lanes that hold an edge, and with ``live`` only
    those whose row it keeps."""
    ok = g.row != g.nv
    if live is not None:
        ok = ok & live[torch.where(ok, g.row, 0).long()]
    return ok


def csr_to_coo(g: CSRGraph, live: Optional[torch.Tensor] = None):
    """Live edges as padded COO ``(src, dst, w, valid)`` — already packed
    (with ``live``, the lanes of the rows it leaves out are not valid)."""
    ok = _live_lanes(g, live)
    return (torch.where(ok, g.row, 0), torch.where(ok, g.indices, 0),
            torch.where(ok, g.weights, 0.0), ok)


# ---------------------------------------------------------------------------
# Point reads
# ---------------------------------------------------------------------------

def csr_query(g: CSRGraph, qs: torch.Tensor, qd: torch.Tensor,
              active: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched read_edge: (found, weight) of each (qs, qd) in the run.

    One ``searchsorted`` of the queries' (src, dst) keys in the run's sorted
    lane keys: the lower bound is the JAX package's per-row bisect's (the
    first of parallel edges).  Lanes with ``active`` False report not
    found.  No host sync.
    """
    if g.capacity == 0:
        return (torch.zeros(qs.shape, dtype=torch.bool, device=qs.device),
                torch.zeros(qs.shape, dtype=torch.float32, device=qs.device))
    q = composite_key(qs, qd)
    pos = torch.searchsorted(g.key, q).clamp_(max=g.capacity - 1)
    found = (g.key[pos] == q) & (qs >= 0) & (qs < g.nv)
    if active is not None:
        found = found & active
    return found, torch.where(found, g.weights[pos], 0.0)


# ---------------------------------------------------------------------------
# Sweeps (the fast-tier ProcessEdge: flat segment reductions)
# ---------------------------------------------------------------------------

def _fill(g: CSRGraph, x: torch.Tensor, combine: str) -> torch.Tensor:
    return torch.full((g.nv,) + tuple(x.shape[1:]), SEMIRINGS[combine].fill,
                      dtype=x.dtype, device=x.device)


def _stream_sum(g: CSRGraph, stream: str, msg: torch.Tensor) -> torch.Tensor:
    """Segment sum of ``msg`` (the ``stream``'s order) by ``segment_sum_csr``."""
    flat = msg.reshape(msg.shape[0], math.prod(msg.shape[1:])).contiguous()
    ptr = g.push_ptr if stream == "push" else g.offsets
    out = segment_sum_csr(flat, ptr, g.partition(stream, flat.shape[1]))
    return out.reshape((g.nv,) + tuple(msg.shape[1:]))


def csr_push(g: CSRGraph, x: torch.Tensor,
             active: Optional[torch.Tensor] = None, *,
             dense_f: Optional[Callable] = None, combine: str = "sum",
             impl: str = "torch") -> torch.Tensor:
    """Push sweep over the run: y[dst] = combine of dense_f(x[src], w).

    On the kernel route (``impl="cuda"``, sum) ``x[src]`` is gathered in the
    run's destination order by ``gather_rows`` and summed by
    ``segment_sum_csr``: no sort, no block padding.
    """
    impl = resolve_impl(impl)
    dense_f = dense_f or _default_edge_f
    if g.capacity == 0:
        return _fill(g, x, combine)
    if impl == "cuda" and combine == "sum":
        xs = _gather_values(x, g.push_src, impl)
        msg = torch.broadcast_to(dense_f(xs, g.push_w), xs.shape)
        if active is not None:
            msg = torch.where(active.index_select(0, g.push_src), msg, 0.0)
        return _stream_sum(g, "push", msg)
    nv = g.nv
    ok = g.row != nv
    row_safe = torch.where(ok, g.row, 0).long()
    xs = x[row_safe]
    if active is not None:
        ok = ok & active[row_safe]
    msg = torch.where(ok, dense_f(xs, g.weights), SEMIRINGS[combine].fill)
    seg = torch.where(ok, g.indices, nv)
    return SEMIRINGS[combine].segment_reduce(msg, seg, nv)


def csr_pull(g: CSRGraph, x: torch.Tensor,
             active_dst: Optional[torch.Tensor] = None, *,
             dense_f: Optional[Callable] = None, combine: str = "sum",
             impl: str = "torch") -> torch.Tensor:
    """Pull sweep over the run: y[src] = combine of dense_f(x[dst], w).

    Sums by ``row``, the run's own order: on the kernel route one
    ``segment_sum_csr`` over ``offsets``.
    """
    impl = resolve_impl(impl)
    dense_f = dense_f or _default_edge_f
    if g.capacity == 0:
        return _fill(g, x, combine)
    nv = g.nv
    if impl == "cuda" and combine == "sum":
        n = g.n_live
        dst_safe = g.indices[:n].clamp(0, nv - 1)
        xd = _gather_values(x, dst_safe, impl)
        msg = torch.broadcast_to(dense_f(xd, g.weights[:n]), xd.shape)
        if active_dst is not None:
            msg = torch.where(active_dst.index_select(0, dst_safe), msg, 0.0)
        return _stream_sum(g, "pull", msg)
    ok = g.row != nv
    dst_safe = g.indices.clamp(0, nv - 1).long()
    xd = x[dst_safe]
    if active_dst is not None:
        ok = ok & active_dst[dst_safe]
    msg = torch.where(ok, dense_f(xd, g.weights), SEMIRINGS[combine].fill)
    seg = torch.where(ok, g.row, nv)
    return SEMIRINGS[combine].segment_reduce(msg, seg, nv)


def csr_push_feat(g: CSRGraph, x: torch.Tensor,
                  active: Optional[torch.Tensor] = None, *,
                  weighted: bool = True, impl: str = "torch") -> torch.Tensor:
    """Feature-matrix push over the run: y[dst, :] += x[src, :] * w."""
    impl = resolve_impl(impl)
    nv = g.nv
    if g.capacity == 0:
        return torch.zeros((nv, x.shape[1]), dtype=x.dtype, device=x.device)
    if impl == "cuda":
        xs = _gather_values(x, g.push_src, impl)           # [P, F]
        msg = xs * g.push_w[:, None] if weighted else xs
        if active is not None:
            msg = torch.where(active.index_select(0, g.push_src)[:, None],
                              msg, 0.0)
        return _stream_sum(g, "push", msg)
    ok = g.row != nv
    row_safe = torch.where(ok, g.row, 0).long()
    xs = x[row_safe]
    if active is not None:
        ok = ok & active[row_safe]
    scale = g.weights if weighted else torch.ones_like(g.weights)
    msg = xs * torch.where(ok, scale, 0.0)[:, None]
    seg = torch.where(ok, g.indices, nv)
    return SEMIRINGS["sum"].segment_reduce(msg, seg, nv)


def csr_in_degrees(g: CSRGraph,
                   live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """In-degrees over the run's lanes (with ``live``, the lanes of its
    rows only)."""
    if g.capacity == 0:
        return torch.zeros(g.nv, dtype=I32, device=g.device)
    ok = _live_lanes(g, live)
    return segment_count(torch.where(ok, g.indices, g.nv), ok, g.nv)


def csr_pagerank_sweep(g: CSRGraph, x: torch.Tensor,
                       impl: str = "torch") -> torch.Tensor:
    """One PageRank push sweep over the run."""
    return csr_push(g, x, impl=impl)


# ---------------------------------------------------------------------------
# Sampling (k-hop over the sealed tier: O(1) per draw — no chain walk)
# ---------------------------------------------------------------------------

def _row_degrees(g: CSRGraph, verts: torch.Tensor):
    """(clamped rows, degrees) of ``verts``; out-of-range ids have degree 0."""
    vs = verts.clamp(0, g.nv - 1).long()
    deg = g.offsets[vs + 1] - g.offsets[vs]
    return vs, torch.where((verts >= 0) & (verts < g.nv), deg, 0)


def csr_rank_neighbors(g: CSRGraph, verts: torch.Tensor, ranks: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(neighbours i32[V, k], valid bool[V, k]): the rank-r neighbour of v is
    ``indices[offsets[v] + r]``, one gather (no chain walk)."""
    V, k = ranks.shape
    if g.capacity == 0:
        return (torch.full((V, k), NULL, dtype=I32, device=verts.device),
                torch.zeros((V, k), dtype=torch.bool, device=verts.device))
    vs, deg = _row_degrees(g, verts)
    idx = (g.offsets[vs][:, None] + ranks).clamp(0, g.capacity - 1)
    out = g.indices[idx.long()]
    valid = (deg > 0)[:, None].expand(V, k)
    return torch.where(valid, out, NULL), valid


def csr_draw_ranks(g: CSRGraph, verts: torch.Tensor,
                   generator: torch.Generator, k: int) -> torch.Tensor:
    """i32[V, k] ranks uniform in ``[0, max(deg, 1))`` per vertex."""
    deg = (_row_degrees(g, verts)[1] if g.capacity
           else torch.zeros(verts.shape, dtype=I32, device=verts.device))
    deg = deg.clamp(min=1)
    u = torch.rand((verts.shape[0], k), generator=generator,
                   dtype=torch.float64, device=verts.device)
    return torch.minimum((u * deg[:, None]).to(I32), (deg - 1)[:, None])


def csr_sample_neighbors(g: CSRGraph, verts: torch.Tensor,
                         generator: Optional[torch.Generator] = None,
                         k: Optional[int] = None,
                         ranks: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw up to ``k`` neighbours (with replacement) per vertex, from
    ``generator`` or at the given ``ranks``."""
    if ranks is None:
        ranks = csr_draw_ranks(g, verts, generator, k)
    return csr_rank_neighbors(g, verts, ranks)


# ---------------------------------------------------------------------------
# Merge (a seal's move into the run: a pass over the run, no sort of it)
# ---------------------------------------------------------------------------

def csr_merge(g: CSRGraph, live: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, w: torch.Tensor) -> CSRGraph:
    """The run of ``g``'s lanes whose row ``live`` (bool[nv]) keeps, and of
    the edges ``(src, dst, w)``, in both of a run's orders.

    The edges are sorted by (src, dst), their sources lie in ``[0, nv)``,
    and none is a row ``live`` keeps (each vertex's edges lie in one of the
    two).  Source order: a kept lane moves by its row's shift and a new
    edge lands at its row's start plus its rank, so nothing of the run is
    sorted again.  The push stream: the lanes of the rows left out are
    dropped and the new edges with an in-range destination, stable-sorted
    by destination, are placed by the sweep plan's patch kernels
    (``plan_patch.locate_lanes`` and ``merge_lanes``), one pass over the
    old stream.  The lanes left out go at the merge.
    """
    nv, dev = g.nv, g.device
    n_old = g.n_live
    row_o = g.row[:n_old].long()
    keep = live[row_o]
    deg_keep = csr_degrees(g, live)
    moved = segment_count(src, torch.ones(src.shape, dtype=torch.bool,
                                          device=dev), nv)
    offsets = torch.zeros(nv + 1, dtype=I32, device=dev)
    offsets[1:] = torch.cumsum(deg_keep + moved, 0)
    n_new = int(offsets[-1])                                  # a host sync

    # source order: kept lanes shifted by their row, new edges by rank
    shift = (offsets[:-1] - g.offsets[:-1]).long()
    pos_o = (torch.arange(n_old, device=dev) + shift[row_o])[keep]
    first = torch.zeros(nv, dtype=torch.int64, device=dev)
    first[1:] = torch.cumsum(moved[:-1], 0)
    s64 = src.long()
    pos_n = (offsets[:-1].long()[s64]
             + torch.arange(src.numel(), device=dev) - first[s64])
    indices = torch.empty(n_new, dtype=I32, device=dev)
    weights = torch.empty(n_new, dtype=torch.float32, device=dev)
    indices[pos_o] = g.indices[:n_old][keep]
    weights[pos_o] = g.weights[:n_old][keep]
    indices[pos_n] = dst.to(I32)
    weights[pos_n] = w.to(torch.float32)
    row = torch.repeat_interleave(arange32(nv, dev),
                                  (deg_keep + moved).long(),
                                  output_size=n_new)

    # the push stream: (dst, src) order of the new edges to place
    lanes = torch.nonzero((dst >= 0) & (dst < nv)).squeeze(1)
    rd, order = torch.sort(dst[lanes].to(I32), stable=True)
    lanes = lanes[order]
    rs, rw = src[lanes].to(I32), w[lanes].to(torch.float32)
    if g.push_src.numel() == 0:
        push_src, push_w = rs.contiguous(), rw.contiguous()
        push_ptr = torch.searchsorted(rd, arange32(nv + 1, dev),
                                      out_int32=True)
    else:
        push_src, push_w, push_ptr = _merge_push(g, live, keep, rd, rs, rw)
    return CSRGraph(offsets=offsets, indices=indices, weights=weights,
                    row=row, nv=nv, push_src=push_src, push_w=push_w,
                    push_ptr=push_ptr, n_live=n_new)


def _merge_push(g: CSRGraph, live: torch.Tensor, keep: torch.Tensor,
                rd: torch.Tensor, rs: torch.Tensor, rw: torch.Tensor):
    """``g``'s push stream less the lanes of the rows ``live`` leaves out,
    with the records ``(rd, rs, rw)`` (sorted by (dst, src)) placed: the
    dropped lanes are records that delete the lane they name, the new
    edges records that insert before the lane ``locate_lanes`` finds, all
    sorted by that lane for ``merge_lanes``."""
    nv, dev = g.nv, g.device
    drop = torch.nonzero(~live[g.push_src.long()]).squeeze(1).to(I32)
    ins_pos, _ = plan_patch.locate_lanes(g.push_src, g.push_ptr, rd, rs)
    pos, order = torch.sort(torch.cat([drop, ins_pos]), stable=True)
    is_ins = torch.cat([torch.zeros(drop.numel(), dtype=torch.bool,
                                    device=dev),
                        torch.ones(rd.numel(), dtype=torch.bool,
                                   device=dev)])[order]
    rsrc = torch.cat([torch.zeros(drop.numel(), dtype=I32, device=dev),
                      rs])[order].contiguous()
    rww = torch.cat([torch.zeros(drop.numel(), dtype=torch.float32,
                                 device=dev), rw])[order].contiguous()
    zero = torch.zeros(1, dtype=I32, device=dev)
    cum_found = torch.cat([zero, torch.cumsum(~is_ins, 0, dtype=I32)])
    cum_ins = torch.cat([zero, torch.cumsum(is_ins, 0, dtype=I32)])
    n_lanes = g.push_src.numel() - drop.numel() + rd.numel()
    push_src, push_w = plan_patch.merge_lanes(
        g.push_src, g.push_w, pos.contiguous(), cum_found, cum_ins, rsrc,
        rww, n_lanes)
    # each destination's span: less its dropped lanes, plus its new edges
    gone = g.indices[:g.n_live][~keep]
    gone = gone[(gone >= 0) & (gone < nv)]
    net = torch.zeros(nv + 1, dtype=I32, device=dev)
    net.index_add_(0, gone.long() + 1,
                   torch.full(gone.shape, -1, dtype=I32, device=dev))
    net.index_add_(0, rd.long() + 1,
                   torch.ones(rd.shape, dtype=I32, device=dev))
    return push_src, push_w, g.push_ptr + torch.cumsum(net, 0, dtype=I32)


# ---------------------------------------------------------------------------
# Rebuild-on-insert (the O(E) update path the tiered store never takes: it
# unseals instead)
# ---------------------------------------------------------------------------

def csr_insert_batch(g: CSRGraph, src, dst, w) -> CSRGraph:
    """Full rebuild with the batch added (contiguity means O(E) movement)."""
    dev = g.device
    src = torch.as_tensor(src, device=dev).to(I32)
    s0, d0, w0, ok0 = csr_to_coo(g)
    return csr_build(torch.cat([s0, src]),
                     torch.cat([d0, torch.as_tensor(dst, device=dev)
                                .to(I32)]),
                     torch.cat([w0, torch.as_tensor(w, device=dev)
                                .to(torch.float32)]), g.nv,
                     valid=torch.cat([ok0, torch.ones(src.shape,
                                                      dtype=torch.bool,
                                                      device=dev)]))
