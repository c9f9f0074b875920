"""The paper's analytics workloads as declarative VertexPrograms, in torch.

PageRank / CC / LP = scan_vertices() + scan_edges(v)    (dense, GTChain order)
BFS / SSSP         = scan_vertices(cond) + scan_edges   (frontier, push)

Each workload is a :class:`~repro_torch.core.program.VertexProgram`;
:func:`~repro_torch.core.program.run_program` supplies the fixpoint loop,
frontier execution, ``impl=`` dispatch and the incremental warm-start /
retraction protocol.  Every program registers by name so the serving layer
reaches all of them through one registry.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.blockstore import arange32
from repro_torch.core.cblist import CBList
from repro_torch.core.engine import out_degrees
from repro_torch.core.program import (Sweep, VertexProgram, register_program,
                                      run_program)

INF = float("inf")


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# PageRank — dense sum-semiring power iteration
# ---------------------------------------------------------------------------

def _pr_setup(ctx):
    deg0 = out_degrees(ctx.cbl)
    return dict(n=ctx.cbl.n_vertices.clamp(min=1).to(torch.float32),
                deg=deg0.clamp(min=1).to(torch.float32),
                dangling_mask=ctx.live & (deg0 == 0))   # loop-invariant


def _pr_apply(ctx, r, acc):
    damping = _f32(ctx.params["damping"], r)
    n = ctx.consts["n"]
    dangling = torch.where(ctx.consts["dangling_mask"], r, 0.0).sum()
    return torch.where(ctx.live, (1 - damping) / n
                       + damping * (acc + dangling / n), 0.0)


PAGERANK = register_program(VertexProgram(
    name="pagerank",
    setup=_pr_setup,
    init=lambda ctx: torch.where(ctx.live, 1.0 / ctx.consts["n"], 0.0),
    sweeps=(Sweep(direction="push", combine="sum",
                  message=lambda xs, w: xs,
                  pre=lambda ctx, r: torch.where(ctx.live,
                                                 r / ctx.consts["deg"], 0.0),
                  apply=_pr_apply),),
    progress=lambda ctx, old, new:
        (new - old).abs().sum() > ctx.params["tol"],
    defaults=(("damping", 0.85), ("tol", 1e-6)),
    default_max_iters=20,
    warm_validity="always", warm_fill=0.0))


# ---------------------------------------------------------------------------
# BFS / SSSP — frontier min-semiring relaxation (+ retraction when warm)
# ---------------------------------------------------------------------------

def _is_source(ctx):
    return arange32(ctx.nv, ctx.cbl.device) == int(ctx.params["source"])


def _source_row(ctx):
    """The cold start's source as a scatter at ``source`` places it: a
    negative id counts from the end, an id still out of range marks no
    vertex."""
    src = int(ctx.params["source"])
    return arange32(ctx.nv, ctx.cbl.device) == (src + ctx.nv if src < 0
                                                 else src)


def _sp_init(ctx):
    return torch.where(_source_row(ctx), 0.0, INF)


def _sp_anchor(ctx):
    return _is_source(ctx), 0.0


def _bfs_warm(ctx, prev):
    dist = torch.where(prev < 0, INF, prev.to(torch.float32))
    return torch.where(_is_source(ctx), 0.0, dist)


BFS = register_program(VertexProgram(
    name="bfs",
    init=_sp_init, frontier_init=_source_row,
    sweeps=(Sweep(direction="push", combine="min",
                  message=lambda xs, w: xs + 1.0, use_frontier=True,
                  apply=lambda ctx, s, acc: torch.minimum(s, acc)),),
    task="frontier", needs_source=True, default_max_iters=64,
    finalize=lambda ctx, s: torch.where(torch.isinf(s), -1,
                                        s.to(torch.int32)).to(torch.int32),
    warm_validity="always", warm_init=_bfs_warm,
    warm_frontier=lambda ctx, s: torch.isfinite(s),
    retract="unsupported_min", anchor=_sp_anchor, warm_fill=-1))


SSSP = register_program(VertexProgram(
    name="sssp",
    init=_sp_init, frontier_init=_source_row,
    sweeps=(Sweep(direction="push", combine="min",
                  message=lambda xs, w: xs + w, use_frontier=True,
                  apply=lambda ctx, s, acc: torch.minimum(s, acc)),),
    task="frontier", needs_source=True, default_max_iters=64,
    warm_validity="always",
    warm_init=lambda ctx, prev: torch.where(_is_source(ctx), 0.0, prev),
    warm_frontier=lambda ctx, s: torch.isfinite(s),
    retract="unsupported_min", anchor=_sp_anchor, warm_fill=INF))


# ---------------------------------------------------------------------------
# Connected components — undirected label-min propagation (push + pull)
# ---------------------------------------------------------------------------

def _ids_f32(ctx):
    return torch.arange(ctx.nv, dtype=torch.float32, device=ctx.cbl.device)


def _cc_warm(ctx, prev):
    ids = _ids_f32(ctx)
    prevf = torch.where(prev < 0, ids, prev.to(torch.float32))
    return torch.where(ctx.live, torch.minimum(prevf, ids), INF)


CONNECTED_COMPONENTS = register_program(VertexProgram(
    name="cc",
    init=lambda ctx: torch.where(ctx.live, _ids_f32(ctx), INF),
    sweeps=(Sweep(direction="push", combine="min",
                  message=lambda xs, w: xs,
                  apply=lambda ctx, s, acc: torch.minimum(s, acc)),
            # propagate back: each dst tells src its (new) label via pull
            Sweep(direction="pull", combine="min",
                  message=lambda xd, w: xd,
                  apply=lambda ctx, s, acc: torch.minimum(s, acc))),
    progress=lambda ctx, old, new: (new < old).any(),
    default_max_iters=128,
    finalize=lambda ctx, s: torch.where(ctx.live, s, -1.0).to(torch.int32),
    # insertions only merge components; a deletion can split one, which
    # min-propagation cannot undo -> cold restart
    warm_validity="inserts_only", warm_init=_cc_warm, warm_fill=-1))


# ---------------------------------------------------------------------------
# Label propagation — semi-supervised one-hot mass diffusion
# ---------------------------------------------------------------------------

def _lp_setup(ctx):
    seeds = torch.as_tensor(ctx.params["seeds"], device=ctx.cbl.device)
    mask = torch.as_tensor(ctx.params["seed_mask"], device=ctx.cbl.device)
    onehot = torch.nn.functional.one_hot(
        seeds.long(), ctx.params["num_classes"]).to(torch.float32)
    return dict(onehot=onehot * mask[:, None], seed_mask=mask.bool())


def _lp_apply(ctx, mass, agg):
    return torch.where(ctx.consts["seed_mask"][:, None], ctx.consts["onehot"],
                       agg / agg.sum(1, keepdim=True).clamp(min=1e-9))


LABEL_PROPAGATION = register_program(VertexProgram(
    name="label_propagation",
    setup=_lp_setup,
    init=lambda ctx: ctx.consts["onehot"],
    sweeps=(Sweep(direction="push_feat", weighted=True, apply=_lp_apply),),
    defaults=(("num_classes", 16),),
    default_max_iters=10,
    finalize=lambda ctx, mass: torch.where(
        ctx.live, mass.argmax(1), -1).to(torch.int32),
    warm_validity="never"))


# ---------------------------------------------------------------------------
# Triangle count — one wedge-closing sweep (single-iteration program)
# ---------------------------------------------------------------------------

def _tri_finalize(ctx, at):
    sym = ((at + at.T) > 0).to(torch.float32)
    sym = sym * (1.0 - torch.eye(ctx.nv, dtype=torch.float32,
                                 device=at.device))   # drop self-loops
    return torch.round((sym * (sym @ sym)).sum() / 6.0).to(torch.int32)


TRIANGLE_COUNT = register_program(VertexProgram(
    name="triangle_count",
    # adjacency indicator via one feature push of the identity; finalize
    # symmetrizes and counts closed wedges — every triangle contributes 6
    init=lambda ctx: torch.eye(ctx.nv, dtype=torch.float32,
                               device=ctx.cbl.device),
    sweeps=(Sweep(direction="push_feat", weighted=False),),
    progress=lambda ctx, old, new: False,
    default_max_iters=1,
    finalize=_tri_finalize,
    warm_validity="never"))


# ---------------------------------------------------------------------------
# Public drivers — thin wrappers over run_program
# ---------------------------------------------------------------------------

def pagerank(cbl: CBList, damping: float = 0.85, max_iters: int = 20,
             tol: float = 1e-6, init: Optional[torch.Tensor] = None,
             impl: Optional[str] = None, return_stats: bool = False):
    """Power-iteration PageRank; ``init`` warm-starts (incremental)."""
    return run_program(cbl, PAGERANK, warm=init, max_iters=max_iters,
                       impl=impl, return_stats=return_stats,
                       damping=damping, tol=tol)


def incremental_pagerank(cbl: CBList, prev_ranks: torch.Tensor,
                         damping: float = 0.85, max_iters: int = 20,
                         tol: float = 1e-6, impl: Optional[str] = None):
    """Dynamic-graph PageRank: warm-start from the pre-update ranks."""
    return run_program(cbl, PAGERANK, warm=prev_ranks, max_iters=max_iters,
                       impl=impl, damping=damping, tol=tol)


def bfs(cbl: CBList, source: int, max_iters: int = 64,
        impl: Optional[str] = None) -> torch.Tensor:
    """BFS levels (unreachable = -1).  Frontier push with min combine."""
    return run_program(cbl, BFS, source=source, max_iters=max_iters,
                       impl=impl)


def incremental_bfs(cbl: CBList, source: int, prev_levels: torch.Tensor,
                    max_iters: int = 64, impl: Optional[str] = None):
    """Dynamic BFS levels from the pre-update levels (-1 = unreachable)."""
    return run_program(cbl, BFS, warm=prev_levels, source=source,
                       max_iters=max_iters, impl=impl)


def sssp(cbl: CBList, source: int, max_iters: int = 64,
         impl: Optional[str] = None) -> torch.Tensor:
    """Bellman-Ford SSSP over edge weights (frontier push, min combine)."""
    return run_program(cbl, SSSP, source=source, max_iters=max_iters,
                       impl=impl)


def incremental_sssp(cbl: CBList, source: int, prev_dist: torch.Tensor,
                     max_iters: int = 64, impl: Optional[str] = None):
    """Dynamic SSSP: retraction (deletion safety) then warm relaxation;
    needs positive edge weights."""
    return run_program(cbl, SSSP, warm=prev_dist, source=source,
                       max_iters=max_iters, impl=impl)


def connected_components(cbl: CBList, max_iters: int = 128,
                         impl: Optional[str] = None) -> torch.Tensor:
    """Label-min propagation CC (edges as undirected via push + pull)."""
    return run_program(cbl, CONNECTED_COMPONENTS, max_iters=max_iters,
                       impl=impl)


def incremental_cc(cbl: CBList, prev_labels: torch.Tensor, had_deletes: bool,
                   max_iters: int = 128, impl: Optional[str] = None):
    """Dynamic CC: warm-start label-min propagation (inserts only); after
    deletes every label restarts from the vertex's own id."""
    prev = torch.full_like(prev_labels, -1) if had_deletes else prev_labels
    return run_program(cbl, CONNECTED_COMPONENTS, warm=prev.to(torch.int32),
                       max_iters=max_iters, impl=impl)


def label_propagation(cbl: CBList, seeds, seed_mask, num_classes: int = 16,
                      max_iters: int = 10,
                      impl: Optional[str] = None) -> torch.Tensor:
    """Semi-supervised LP: one-hot class mass pushed over edges, argmax.

    ``seeds``: i32[NV] class id per vertex, used where ``seed_mask``.
    """
    return run_program(cbl, LABEL_PROPAGATION, seeds=seeds,
                       seed_mask=seed_mask, num_classes=num_classes,
                       max_iters=max_iters, impl=impl)


def triangle_count(cbl: CBList, impl: Optional[str] = None) -> torch.Tensor:
    """Undirected triangle count via a wedge-closing sweep (O(NV^2) memory:
    analytics-sized graphs only)."""
    return run_program(cbl, TRIANGLE_COUNT, impl=impl)
