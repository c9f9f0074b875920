"""VertexProgram — one declarative IR and one executor for every analytics
workload, in torch.

A workload is a :class:`VertexProgram`: init, a per-iteration
:class:`Sweep` pipeline (edge message + combine semiring), apply, a
convergence predicate and an optional incremental protocol (warm-start
conversion, the ``unsupported_min`` retraction phase, the warm-start
validity rule).  :func:`run_program` is the single executor; the fixpoint
and retraction loops that the JAX package runs as ``lax.while_loop`` are
host loops here, with one device sync per iteration for the predicate.
On a graph whose shards lie over a process group the predicate is agreed
across the ranks (one MAX an iteration), so every rank runs the same
iterations and makes the same collectives.
On the kernel route (``impl="cuda"``) a program with a sum sweep lays the
graph out once per run in a :class:`~repro_torch.core.engine.SweepPlan`
that every iteration's sweeps reuse.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

import repro_torch.obs as obs
from repro_torch.core.blockstore import arange32
from repro_torch.core.cblist import CBList
from repro_torch.core.engine import (SEMIRINGS, process_edge_pull,
                                     process_edge_push, process_edge_push_feat,
                                     sweep_plan)

INF = float("inf")

WARM_VALIDITY = ("always", "inserts_only", "never")


class ProgramContext(NamedTuple):
    """Everything a program hook can see: the graph, the vertex capacity,
    the live-vertex mask, the call parameters, the ``setup`` constants and
    the sweep plan of the kernel route (None on the plain route)."""
    cbl: Any
    nv: int
    live: torch.Tensor
    params: Dict[str, Any]
    consts: Dict[str, Any]
    plan: Any = None


@dataclasses.dataclass(frozen=True)
class Sweep:
    """One edge sweep of a program iteration (see the JAX package's
    ``repro.core.program.Sweep`` for the full contract)."""
    direction: str = "push"
    combine: str = "sum"
    message: Optional[Callable] = None       # None -> engine default xs * w
    pre: Optional[Callable] = None           # (ctx, state) -> x swept
    apply: Optional[Callable] = None         # (ctx, state, acc) -> state
    use_frontier: bool = False
    weighted: bool = True                    # push_feat only

    def __post_init__(self):
        if self.direction not in ("push", "pull", "push_feat"):
            raise ValueError(f"unknown sweep direction {self.direction!r}")
        if self.combine not in SEMIRINGS:
            raise ValueError(f"unknown combine semiring {self.combine!r} "
                             f"(have {tuple(SEMIRINGS)})")


@dataclasses.dataclass(frozen=True)
class VertexProgram:
    """Declarative vertex program: what to compute, never how to loop.

    Hooks: ``setup(ctx) -> consts``, ``init(ctx) -> state``, ``sweeps``,
    ``progress(ctx, old, new) -> bool``, ``frontier_init(ctx)``,
    ``frontier_next(ctx, old, new)``, ``finalize(ctx, state)``; incremental
    protocol: ``warm_validity``, ``warm_init(ctx, prev_out)``,
    ``retract="unsupported_min"`` with ``anchor(ctx) -> (mask, value)``,
    ``warm_frontier(ctx, state)`` and ``warm_fill``.
    """
    name: str
    init: Callable
    sweeps: Tuple[Sweep, ...]
    task: str = "scan_all"
    defaults: Tuple[Tuple[str, Any], ...] = ()
    progress: Optional[Callable] = None
    frontier_init: Optional[Callable] = None
    frontier_next: Optional[Callable] = None
    setup: Optional[Callable] = None
    finalize: Optional[Callable] = None
    default_max_iters: int = 64
    needs_source: bool = False
    warm_validity: str = "always"
    warm_init: Optional[Callable] = None
    warm_frontier: Optional[Callable] = None
    retract: Optional[str] = None            # None | "unsupported_min"
    anchor: Optional[Callable] = None
    warm_fill: Any = 0.0

    def __post_init__(self):
        if not self.sweeps:
            raise ValueError(f"program {self.name!r} declares no sweeps")
        if self.warm_validity not in WARM_VALIDITY:
            raise ValueError(
                f"program {self.name!r}: warm_validity must be one of "
                f"{WARM_VALIDITY}, got {self.warm_validity!r}")
        if self.retract not in (None, "unsupported_min"):
            raise ValueError(
                f"program {self.name!r}: unknown retract {self.retract!r}")
        if self.retract == "unsupported_min" and self.anchor is None:
            raise ValueError(
                f"program {self.name!r}: retract='unsupported_min' needs an "
                "anchor hook (the pinned source set)")
        if self.retract == "unsupported_min" \
                and self.sweeps[0].combine != "min":
            raise ValueError(
                f"program {self.name!r}: retract='unsupported_min' is only "
                "sound for monotone min programs, but the primary sweep "
                f"combines with {self.sweeps[0].combine!r}")
        if (self.task == "frontier" and self.frontier_next is None
                and self.sweeps[0].combine != "min"):
            raise ValueError(
                f"program {self.name!r}: the default frontier predicate "
                "(new < old) detects min-lattice improvement only — a "
                f"{self.sweeps[0].combine!r}-semiring frontier program must "
                "declare frontier_next")
        if (self.warm_validity != "never" and self.finalize is not None
                and self.warm_init is None):
            raise ValueError(
                f"program {self.name!r}: warm starts re-enter through the "
                "previous *output*; declare warm_init to convert it back "
                "to state, or set warm_validity='never'")
        if self.task == "frontier" and self.frontier_init is None:
            raise ValueError(
                f"program {self.name!r}: frontier task needs frontier_init")

    @property
    def combine(self) -> str:
        """The program's primary semiring (first sweep's combine)."""
        return self.sweeps[0].combine


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, VertexProgram] = {}


def register_program(prog: VertexProgram, *,
                     overwrite: bool = False) -> VertexProgram:
    """Register ``prog`` by name for lookup by serving layers."""
    if not overwrite and prog.name in _REGISTRY:
        raise ValueError(f"program {prog.name!r} is already registered "
                         "(pass overwrite=True to replace)")
    _REGISTRY[prog.name] = prog
    return prog


def has_program(name: str) -> bool:
    return name in _REGISTRY


def get_program(name: str) -> VertexProgram:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown analytics workload {name!r} "
            f"(registered: {registered_programs()})") from None


def registered_programs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

def _run_sweep(ctx: ProgramContext, sw: Sweep, x, active, impl: str):
    cbl, plan = ctx.cbl, ctx.plan
    if sw.direction == "push_feat":
        return process_edge_push_feat(cbl, x, active, weighted=sw.weighted,
                                      impl=impl, plan=plan)
    entry = process_edge_push if sw.direction == "push" else process_edge_pull
    if sw.message is None:
        return entry(cbl, x, active, combine=sw.combine, impl=impl, plan=plan)
    return entry(cbl, x, active, dense_f=sw.message, combine=sw.combine,
                 impl=impl, plan=plan)


def _plan_for(cbl, prog: VertexProgram, impl: str):
    """The sweep plan the kernel route's sum sweeps share, or None.  On a
    TieredGraph it is the delta's: the sealed run keeps its own
    destination-ordered stream from the time it was built.  On a
    ShardedCBList (or a tiered one's sharded delta) it is a tuple of one
    plan a shard."""
    if impl != "cuda":
        return None
    dirs = {sw.direction for sw in prog.sweeps if sw.combine == "sum"}
    if not dirs:
        return None
    from repro_torch.core.tiered import TieredGraph
    if isinstance(cbl, TieredGraph):
        cbl = cbl.delta
    kw = dict(push=bool(dirs & {"push", "push_feat"}), pull="pull" in dirs)
    if isinstance(cbl, CBList):
        return sweep_plan(cbl, **kw)
    return tuple(sweep_plan(v, **kw) for v in cbl.views)


def _agreed(ctx: ProgramContext, cont: bool) -> bool:
    """``cont`` held on any rank when the graph lies on a mesh."""
    from repro_torch.distributed.graph import agree, mesh_of
    return agree(mesh_of(ctx.cbl), cont)


def _step(ctx: ProgramContext, prog: VertexProgram, state, frontier,
          impl: str):
    """One program iteration: the sweep pipeline + progress/frontier."""
    new = state
    for sw in prog.sweeps:
        x = sw.pre(ctx, new) if sw.pre is not None else new
        act = frontier if (frontier is not None and sw.use_frontier) else None
        acc = _run_sweep(ctx, sw, x, act, impl)
        new = sw.apply(ctx, new, acc) if sw.apply is not None else acc
    nf = None
    if frontier is not None:
        nf = (prog.frontier_next(ctx, state, new)
              if prog.frontier_next is not None else new < state)
    if prog.progress is not None:
        cont = bool(prog.progress(ctx, state, new))
    elif nf is not None:
        cont = bool(nf.any())
    else:
        return new, nf, True                 # run to max_iters (e.g. LP)
    return new, nf, _agreed(ctx, cont)


def _fixpoint(ctx: ProgramContext, prog: VertexProgram, state, frontier,
              max_iters: int, impl: str):
    """The fixpoint loop every workload shares (a host loop)."""
    iters, cont = 0, True
    while iters < max_iters and cont:
        state, frontier, cont = _step(ctx, prog, state, frontier, impl)
        iters += 1
    return state, iters


def _retract_unsupported(ctx: ProgramContext, prog: VertexProgram, state,
                         impl: str):
    """Deletion-safety phase for monotone min programs: a finite label
    outside the anchor set that no in-neighbour's message reproduces is
    raised to +inf, to a true fixpoint (NV sweeps bound termination)."""
    sw = prog.sweeps[0]
    anchor_mask, anchor_val = prog.anchor(ctx)
    it, cont = 0, True
    while it <= ctx.nv and cont:
        cand = _run_sweep(ctx, sw, state, None, impl)
        new = torch.where(anchor_mask, anchor_val,
                          torch.where(state < cand, INF, state))
        cont = _agreed(ctx, bool((new != state).any()))
        state = new
        it += 1
    return state


def run_program(cbl, prog: VertexProgram, *, warm=None,
                impl: Optional[str] = None, max_iters: Optional[int] = None,
                return_stats: bool = False, **params):
    """Execute ``prog`` on ``cbl`` to fixpoint.

    ``warm`` is a previous *output* of the same program (``"never"``
    programs ignore it).  ``impl=None`` asks the tuner.  ``**params`` reach
    the hooks through ``ctx.params``.  With ``return_stats`` the executor
    also returns the iteration count the fixpoint took.
    """
    if impl is None:
        from repro_torch.core.tuner import choose_engine_impl
        impl = choose_engine_impl(cbl, prog)
    if max_iters is None:
        max_iters = prog.default_max_iters
    if prog.needs_source and "source" not in params:
        raise ValueError(f"program {prog.name!r} needs source=<vertex id>")
    if warm is not None and prog.warm_validity == "never":
        warm = None
    for k, v in prog.defaults:
        params.setdefault(k, v)
    # locality profile at the host-side entry point (one flag check when
    # observability is off)
    obs.record_sweep(cbl, task=prog.task)

    nv = cbl.capacity_vertices
    live = arange32(nv, cbl.device) < cbl.n_vertices
    ctx = ProgramContext(cbl=cbl, nv=nv, live=live, params=params, consts={},
                         plan=_plan_for(cbl, prog, impl))
    if prog.setup is not None:
        ctx = ctx._replace(consts=prog.setup(ctx))
    frontier_mode = prog.task == "frontier"

    if warm is None:
        state = prog.init(ctx)
        frontier = prog.frontier_init(ctx) if frontier_mode else None
    else:
        state = (prog.warm_init(ctx, warm)
                 if prog.warm_init is not None else warm)
        if prog.retract == "unsupported_min":
            state = _retract_unsupported(ctx, prog, state, impl)
        frontier = (prog.warm_frontier(ctx, state)
                    if frontier_mode and prog.warm_frontier is not None
                    else (prog.frontier_init(ctx) if frontier_mode else None))

    state, iters = _fixpoint(ctx, prog, state, frontier, int(max_iters), impl)
    out = prog.finalize(ctx, state) if prog.finalize is not None else state
    return (out, iters) if return_stats else out
