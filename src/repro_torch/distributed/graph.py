"""ShardedCBList — GTChain-partitioned CBList shards, stacked on one device
or laid over the ranks of a process group.

The paper's fine-grained GTChain partition (§5.2) hands each coroutine an
equal slice of *blocks* whatever the degree skew.  Here the partition
places data and work: :func:`repro_torch.core.traversal.make_placement_plan`
cuts the vertex space at block-balanced boundaries, and every shard is a
whole CBList in the global vertex-id space holding only the chains it owns.
The shards' tensors are stacked along a leading shard axis ``[S, ...]``.

Placement.  With ``mesh=None`` one device holds the whole stack.  With a
1-D ``("shard",)`` :class:`~torch.distributed.device_mesh.DeviceMesh`
(:func:`shard_mesh`: the largest divisor of S that fits the world, over its
first ranks, as the JAX package takes the first devices) every rank runs
the same program, the JAX package's multi-controller SPMD model, and holds
only its contiguous block of ``S / nd`` shards (JAX's ``P("shard")``):
``shards`` is that block, ``v_shard`` and every result are replicated.  A
rank outside the mesh (S = 2 on four ranks) holds one empty shard, so it
runs the same code at the same shapes, and takes every replicated value
from the mesh's first rank by a broadcast.

Compute follows the data.  Every engine sweep runs per local shard through
the *unchanged* single-device sweep (``impl="cuda"`` through that shard's
:class:`~repro_torch.core.engine.SweepPlan`, so the ``segment_sum`` and
``block_gather`` kernels run on every shard), producing a partial output
over the whole vertex space.  The partials reduce along the local shard
axis with the semiring's ``lane_reduce`` and then across the mesh with its
collective (:func:`_cross_shard_combine`, the semiring's ``reduce_op``):

  * ``sum``     -- ``reduce_scatter_tensor`` + ``all_gather_into_tensor``
    (each rank sums its owned slice of the vertex space, then the slices
    are regathered) when the vertex capacity tiles the mesh axis and
    :data:`REDUCE_MODE` allows it, one ``all_reduce`` otherwise;
  * ``min/max`` -- one ``all_reduce`` (the identity fill of the local
    segment ops makes non-owned entries neutral).

Each shard's edge set is disjoint and the shards cover the graph, so the
result is the unsharded sweep's: bit for bit for min / max and integer
frontiers, up to summation order for float sums.

Updates route to the shard that owns their source (an edge lives with its
source): every rank computes the same owners, counts and route plan from
the replicated batch (:func:`sharded_batch_update_stats`), applies only its
own shards' lanes with the single-CBList ``batch_update_stats``, and the
stats are all-reduced.  Reads, deletes and the sampler run every local
shard (a shard that does not own a vertex holds no chain for it) and merge
across the mesh.  Maintenance (grow / compact / rebuild) applies per shard
and keeps every shard's shapes equal.

On a mesh every function here, and every property of the global view
(``v_deg``, ``v_level``, ``num_edges``), is collective: all ranks call it,
in the same order.  Every host decision they make reads a value the ranks
share (a replicated input or a reduced one), so the ranks take the same
branches and a collective never waits on a rank that went elsewhere.
Decisions read from a rank's own clock or device are agreed first:
:func:`agree_step` and :func:`broadcast_host` carry the serving frontend's
(:class:`repro_torch.serve.ServeFrontend`) on host tensors over gloo.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.obs as obs
from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import I32, NULL, PAD, BlockStore
from repro_torch.core.cblist import (CBList, build_from_coo, compact_cbl,
                                     to_coo)
from repro_torch.core.cblist import grow as grow_cbl
from repro_torch.core.cblist import rebuild as rebuild_cbl
from repro_torch.core.engine import (SEMIRINGS, _default_edge_f, in_degrees,
                                     process_edge_pull, process_edge_push,
                                     process_edge_push_feat)
from repro_torch.core.traversal import (PlacementPlan, lane_mask,
                                        make_placement_plan)
from repro_torch.core.updates import _defaults as _update_defaults
from repro_torch.core.updates import (DELETE, INSERT, NOP, UpdateStats,
                                      _dedupe_first, _delete_vertex_chains,
                                      _sweep_in_edges, batch_update_stats,
                                      delete_vertices, read_edges,
                                      upsert_edges)

# cross-shard combine for sum sweeps: "auto" uses reduce_scatter +
# all_gather (each rank sums its owned slice of the vertex space) when the
# vertex capacity tiles the mesh axis, else one all_reduce
REDUCE_MODE = "auto"          # "auto" | "all_reduce" | "reduce_scatter"

SUM, MIN, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX


# ---------------------------------------------------------------------------
# The mesh and its collectives
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def shard_mesh(n_shards: int, device_type: Optional[str] = None):
    """A 1-D ``("shard",)`` DeviceMesh over the first ranks of the default
    process group: the largest divisor of ``n_shards`` that fits the world
    (shards beyond the axis size stack on each rank).  None when no group
    is initialised, or under the fake group (its collectives do nothing).
    Every rank must call it alike: a mesh smaller than the world makes its
    group with a collective.  ``device_type`` defaults to the card when
    there is one."""
    if not (dist.is_available() and dist.is_initialized()) \
            or dist.get_backend() == "fake":
        return None
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    nd = max(d for d in range(1, min(n_shards, world) + 1)
             if n_shards % d == 0)
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    pg = dist.group.WORLD
    key = (id(pg), nd, device_type)
    hit = _MESHES.get(key)
    if hit is None or hit[0] is not pg:
        hit = _MESHES[key] = (pg, DeviceMesh(
            device_type, torch.arange(nd), mesh_dim_names=("shard",)))
    return hit[1]


def _member(mesh) -> bool:
    return mesh.get_coordinate() is not None


def _local_ids(mesh, n_shards: int) -> range:
    """The global ids of the shards this rank holds."""
    if mesh is None:
        return range(n_shards)
    coord = mesh.get_coordinate()
    if coord is None:
        return range(0)
    per = n_shards // mesh.size()
    return range(coord[0] * per, (coord[0] + 1) * per)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the collectives take it (bool travels as uint8)."""
    return t.view(torch.uint8) if t.dtype == torch.bool else t


def _share(mesh, t: torch.Tensor) -> torch.Tensor:
    """Hand the mesh's value of ``t`` to the ranks outside the mesh (a
    broadcast over the world from the mesh's first rank; nothing when the
    mesh spans the world)."""
    if mesh.size() < dist.get_world_size():
        dist.broadcast(_wire(t), src=int(mesh.mesh.reshape(-1)[0]))
    return t


def _all_reduce(mesh, t: torch.Tensor, op) -> torch.Tensor:
    """``t`` reduced over the mesh and replicated on every rank.  ``t`` is
    a fresh contiguous tensor the call may overwrite."""
    if mesh is None:
        return t
    if _member(mesh) and mesh.size() > 1:
        dist.all_reduce(t, op=op, group=mesh.get_group("shard"))
    return _share(mesh, t)


def gather_shards(scbl: "ShardedCBList", local: torch.Tensor) -> torch.Tensor:
    """``[S, ...]`` on every rank from each rank's ``[S_local, ...]`` rows
    (one a local shard, in shard order); ``local`` itself without a mesh."""
    mesh = scbl.mesh
    if mesh is None:
        return local
    out = local.new_empty((scbl.n_shards,) + tuple(local.shape[1:]))
    if _member(mesh):
        if mesh.size() > 1:
            dist.all_gather_into_tensor(_wire(out), _wire(local.contiguous()),
                                        group=mesh.get_group("shard"))
        else:
            out.copy_(local)
    return _share(mesh, out)


def agree(mesh, flag: bool) -> bool:
    """``flag`` held on any rank (one MAX over the world): the host branch
    of a loop that every rank must take alike.  ``flag`` itself without a
    mesh."""
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=I32,
                     device=torch.device(mesh.device_type))
    dist.all_reduce(t, op=MAX)
    return bool(t.item())


_CONTROL: dict = {}


def _control_group():
    """The group a host decision travels on: CPU tensors over gloo, so an
    agreement never waits on the device's stream.  The world itself on a
    gloo group; on another backend (NCCL) a gloo group over the world, made
    once at the first agreement (every rank reaches it alike)."""
    pg = dist.group.WORLD
    if dist.get_backend() == "gloo":
        return pg
    hit = _CONTROL.get(id(pg))
    if hit is None or hit[0] is not pg:
        hit = _CONTROL[id(pg)] = (pg, dist.new_group(backend="gloo"))
    return hit[1]


def agree_step(mesh, now: float, not_ready: bool) -> Tuple[float, bool]:
    """A serving step's host decisions, agreed in one float64 MAX over the
    world (ranks outside the mesh included): rank 0's ``now`` (the other
    ranks send -inf, so only rank 0's clock governs) and whether any rank's
    ``not_ready`` holds (its shadow flush's device work is not done).  The
    inputs themselves without a mesh, with no collective."""
    if mesh is None:
        return now, not_ready
    lead = dist.get_rank() == 0
    t = torch.tensor([now if lead else -math.inf, float(not_ready)],
                     dtype=torch.float64)
    dist.all_reduce(t, op=MAX, group=_control_group())
    now, flag = t.tolist()
    return now, bool(flag)


def broadcast_host(mesh, obj):
    """Rank 0's ``obj`` (a picklable host value) on every rank; ``obj``
    itself without a mesh."""
    if mesh is None:
        return obj
    box = [obj if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0, group=_control_group())
    return box[0]


def _cross_shard_combine(local: torch.Tensor, combine: str,
                         mesh) -> torch.Tensor:
    """Reduce this rank's partial sweep output across the mesh axis.

    The semiring declared by the program (through the sweep's ``combine``)
    maps onto the collective: min / max are one ``all_reduce``, and only
    the sum semiring earns the segment-reduce form (``reduce_scatter`` +
    ``all_gather``: each rank sums its owned slice of the remote messages)
    when the vertex capacity tiles the mesh axis."""
    n = mesh.size()
    if n == 1:
        return local
    group = mesh.get_group("shard")
    sr = SEMIRINGS[combine]
    local = local.contiguous()
    if sr.reduce_op == SUM and local.shape[0] % n == 0 \
            and REDUCE_MODE in ("auto", "reduce_scatter"):
        part = local.new_empty((local.shape[0] // n,)
                               + tuple(local.shape[1:]))
        dist.reduce_scatter_tensor(part, local, op=SUM, group=group)
        dist.all_gather_into_tensor(local, part, group=group)
        return local
    dist.all_reduce(local, op=sr.reduce_op, group=group)
    return local


def _combine(parts: Sequence[torch.Tensor], combine: str,
             mesh) -> torch.Tensor:
    """Reduce per-shard partial outputs along the local shard axis through
    the semiring, then across the mesh."""
    local = SEMIRINGS[combine].lane_reduce(torch.stack(list(parts)), 0)
    if mesh is None:
        return local
    if _member(mesh):
        local = _cross_shard_combine(local, combine, mesh)
    return _share(mesh, local)


def owner_merge(found: Sequence[torch.Tensor], vals: Sequence[torch.Tensor],
                mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hit, value) of per-shard lookups where at most one shard holds each
    answer (the owner): ``found`` as a MAX over an integer type, the values
    summed with zeros off the owner."""
    found = torch.stack(list(found))
    vals = torch.stack(list(vals))
    hit = found.any(0)
    merged = torch.where(found, vals, 0).sum(0).to(vals.dtype)
    if mesh is not None:
        hit = _all_reduce(mesh, hit.to(I32), MAX).to(torch.bool)
        merged = _all_reduce(mesh, merged, SUM)
    return hit, merged


def mesh_of(cbl):
    """The mesh a graph's shards lie on (a tiered graph's delta's), or
    None."""
    delta = getattr(cbl, "delta", cbl)
    return delta.mesh if isinstance(delta, ShardedCBList) else None


# ---------------------------------------------------------------------------
# The shard stack
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedCBList:
    """``n_shards`` shard-local CBLists stacked on a leading axis.

    ``shards`` is one CBList whose every tensor has a leading shard axis:
    all S shards without a mesh, this rank's block of ``S / nd`` on one
    (one empty shard on a rank outside the mesh).  ``v_shard`` is the
    replicated vertex -> owning-shard map (the placement plan's cut).
    Vertex ids are global; shard k's vertex table is zero / NULL outside
    the vertices it owns.
    """
    shards: CBList            # every tensor: [S_local, ...]
    v_shard: torch.Tensor     # i32[NV_cap] vertex -> owning shard
    mesh: Any = None          # 1-D ("shard",) DeviceMesh; None: one device
    n_shards: int = 0         # S (the stack's length without a mesh)

    def __post_init__(self):
        if not self.n_shards:
            if self.mesh is not None:
                raise ValueError("a ShardedCBList on a mesh needs n_shards")
            object.__setattr__(self, "n_shards", self.shards.v_deg.shape[0])

    # ---- global-graph view (the CBList surface the algorithms read) ------

    @property
    def capacity_vertices(self) -> int:
        return self.shards.v_deg.shape[1]

    @property
    def num_blocks(self) -> int:
        """Blocks *per shard* (every shard has the same capacity)."""
        return self.shards.store.keys.shape[1]

    @property
    def block_width(self) -> int:
        return self.shards.store.keys.shape[2]

    @property
    def device(self) -> torch.device:
        return self.v_shard.device

    @property
    def shard_ids(self) -> range:
        """The global ids of the shards this rank holds, in ``views``'
        order."""
        return _local_ids(self.mesh, self.n_shards)

    @property
    def n_vertices(self) -> torch.Tensor:
        return self.shards.n_vertices[0]

    @functools.cached_property
    def v_deg(self) -> torch.Tensor:
        """Global out-degrees: each vertex is owned by exactly one shard."""
        return _all_reduce(self.mesh, self.shards.v_deg.sum(0).to(I32), SUM)

    @functools.cached_property
    def v_level(self) -> torch.Tensor:
        return _all_reduce(self.mesh, self.shards.v_level.amax(0), MAX)

    @property
    def num_edges(self) -> torch.Tensor:
        return self.v_deg.sum()

    @functools.cached_property
    def views(self) -> Tuple[CBList, ...]:
        """This rank's shards as views into the stack, made once, so a
        shard's sweep plan recognises its store on every call."""
        return tuple(_index(self.shards, k)
                     for k in range(self.shards.v_deg.shape[0]))


def _index(cbl: CBList, k: int) -> CBList:
    return CBList(store=BlockStore(*(a[k] for a in cbl.store)),
                  **{f: getattr(cbl, f)[k] for f in CBList._fields
                     if f != "store"})


def _cbl_map(fn: Callable, cbl: CBList) -> CBList:
    return CBList(store=BlockStore(*(fn(a) for a in cbl.store)),
                  **{f: fn(getattr(cbl, f)) for f in CBList._fields
                     if f != "store"})


def is_sharded(cbl) -> bool:
    return isinstance(cbl, ShardedCBList)


def shard_at(scbl: ShardedCBList, k: int) -> CBList:
    """Shard k's CBList: views into the stack without a mesh; on one, a
    copy broadcast from the rank that holds it (every rank calls)."""
    if scbl.mesh is None:
        return scbl.views[k]
    ids = scbl.shard_ids
    own = k in ids
    per = scbl.n_shards // scbl.mesh.size()
    src = int(scbl.mesh.mesh.reshape(-1)[k // per])
    like = scbl.views[k - ids.start] if own else scbl.views[0]

    def one(a):
        buf = a.clone() if own else torch.empty_like(a)
        dist.broadcast(_wire(buf), src=src)
        return buf
    return _cbl_map(one, like)


def _restack(shards: Sequence[CBList]) -> CBList:
    """One CBList whose tensors stack ``shards``' along a new axis 0."""
    return CBList(
        store=BlockStore(*(torch.stack(xs) for xs in
                           zip(*(s.store for s in shards)))),
        **{f: torch.stack([getattr(s, f) for s in shards])
           for f in CBList._fields if f != "store"})


def _with_shards(scbl: ShardedCBList,
                 shards: Sequence[CBList]) -> ShardedCBList:
    return dataclasses.replace(scbl, shards=_restack(shards))


def _phantom(n_live: int, num_blocks: int, block_width: int, nvc: int,
             device) -> CBList:
    """The empty shard a rank outside the mesh holds: the stack's shapes,
    no edges."""
    e = torch.zeros(0, dtype=I32, device=device)
    return build_from_coo(e, e, None, num_vertices=n_live,
                          num_blocks=num_blocks, block_width=block_width,
                          vertex_capacity=nvc)


# ---------------------------------------------------------------------------
# Build / merge
# ---------------------------------------------------------------------------

def shard_cbl(cbl: CBList, n_shards: int, mesh=None,
              block_slack: float = 1.5, plan: Optional[PlacementPlan] = None
              ) -> Tuple[ShardedCBList, PlacementPlan]:
    """Split ``cbl`` into GTChain-balanced shards (a bulk re-load of each).

    Every shard gets the same block capacity, the largest shard's demand
    times ``block_slack`` (``max(8, ceil(demand * block_slack) + 1)``), so
    the stack has one shape; each shard's bulk load keeps global vertex ids
    and the live-vertex count, so shard-local sweeps give globally indexed
    partial results.  The COO is partitioned on the device, in its GTChain
    order, by one stable sort of the owning shard.  On a ``mesh`` (whose
    size divides ``n_shards``) ``cbl`` is the replicated source and each
    rank builds only its own shards.
    """
    live_blocks, demand = (int(x) for x in torch.stack([
        (cbl.store.owner != NULL).sum(), cbl.v_level.long().sum()]).tolist())
    if live_blocks != demand:
        raise ValueError(
            f"shard_cbl: vertex table claims {demand} chain blocks but only "
            f"{live_blocks} are live — the source CBList silently dropped "
            "edges at build time (num_blocks below the ceil-per-vertex "
            "demand); rebuild it with enough blocks before sharding")
    if mesh is not None and n_shards % mesh.size():
        raise ValueError(f"shard_cbl: a mesh of {mesh.size()} ranks does "
                         f"not divide {n_shards} shards")
    if plan is None:
        plan = make_placement_plan(cbl, n_shards)
    nvc = cbl.capacity_vertices
    bw = cbl.block_width
    s, d, w, valid = to_coo(cbl, cbl.store.num_blocks * bw)
    n_live = int(cbl.n_vertices)
    demand = max(plan.blocks_per_shard) if plan.blocks_per_shard else 0
    nb_shard = max(8, int(math.ceil(demand * block_slack)) + 1)

    vs = plan.vertex_shard
    owner_shard = torch.where(valid, vs[s.clamp(0, nvc - 1).long()],
                              n_shards)
    order = bs.stable_argsort(owner_shard)
    ends = torch.bincount(owner_shard.long(), minlength=n_shards + 1)[
        :n_shards].cumsum(0).tolist()
    starts = [0] + ends[:-1]
    shards = []
    for k in _local_ids(mesh, n_shards):
        ix = order[starts[k]:ends[k]]
        shards.append(build_from_coo(
            s[ix], d[ix], w[ix], num_vertices=n_live, num_blocks=nb_shard,
            block_width=bw, vertex_capacity=nvc))
    if not shards:                       # a rank outside the mesh
        shards.append(_phantom(n_live, nb_shard, bw, nvc, cbl.device))
    return (ShardedCBList(shards=_restack(shards), v_shard=vs.clone(),
                          mesh=mesh, n_shards=n_shards), plan)


def unshard(scbl: ShardedCBList, num_blocks: Optional[int] = None,
            block_width: Optional[int] = None) -> CBList:
    """Merge the shards back into one CBList (a bulk re-load; on a mesh
    every rank gathers every shard's COO and builds the whole graph)."""
    per = scbl.num_blocks * scbl.block_width
    parts = [to_coo(v, per) for v in scbl.views]
    s, d, w, valid = (torch.cat([p[i] for p in parts]) for i in range(4))
    if scbl.mesh is not None:
        s, d, w, valid = (gather_shards(scbl, a.reshape(len(parts), per))
                          .reshape(-1) for a in (s, d, w, valid))
    nb = num_blocks or scbl.n_shards * scbl.num_blocks
    return build_from_coo(
        s, d, w, num_vertices=int(scbl.n_vertices), num_blocks=nb,
        block_width=block_width or scbl.block_width,
        vertex_capacity=scbl.capacity_vertices, valid=valid)


# ---------------------------------------------------------------------------
# Placement statistics (tuner inputs)
# ---------------------------------------------------------------------------

def _remote_lanes(scbl: ShardedCBList, view: CBList, k: int):
    """(remote bool[NB, B], live bool[NB, B], dst) of shard k: live lanes
    whose destination another shard owns."""
    st = view.store
    mask = lane_mask(st)
    dst = st.keys.clamp(0, scbl.capacity_vertices - 1).long()
    return mask & (scbl.v_shard[dst] != k), mask, dst


def cut_fraction(scbl: ShardedCBList) -> torch.Tensor:
    """Fraction of live edges whose destination another shard owns: the
    messages that cross the cut (the tuner's remote-message term)."""
    rem = tot = torch.zeros((), dtype=torch.int64, device=scbl.device)
    for k, v in zip(scbl.shard_ids, scbl.views):
        remote, mask, _ = _remote_lanes(scbl, v, k)
        rem = rem + remote.sum()
        tot = tot + mask.sum()
    rem, tot = _all_reduce(scbl.mesh, torch.stack([rem, tot]), SUM)
    return rem.to(torch.float32) / tot.clamp(min=1).to(torch.float32)


def shard_contiguity(scbl: ShardedCBList) -> torch.Tensor:
    """Mean per-shard GTChain contiguity (the tuner's P_h, shard-locally)."""
    return gather_shards(scbl, torch.stack([bs.gtchain_contiguity(v.store)
                                            for v in scbl.views])).mean()


def halo_masks(scbl: ShardedCBList) -> torch.Tensor:
    """bool[S, NV]: the halo sets (shard s stores an edge into v owned
    elsewhere)."""
    out = torch.zeros((len(scbl.views), scbl.capacity_vertices),
                      dtype=torch.bool, device=scbl.device)
    for j, (k, v) in enumerate(zip(scbl.shard_ids, scbl.views)):
        remote, _, dst = _remote_lanes(scbl, v, k)
        out[j, dst[remote]] = True
    return gather_shards(scbl, out)


# ---------------------------------------------------------------------------
# Sharded engine sweeps
# ---------------------------------------------------------------------------

def _sharded_sweep(scbl: ShardedCBList, x: torch.Tensor, active,
                   sweep: Callable, combine: str, plan=None) -> torch.Tensor:
    """Run ``sweep(cbl_k, x, active, plan_k) -> partial[NV(,F)]`` on every
    local shard and combine across the cut.  ``plan`` is a tuple of sweep
    plans, one a local shard, or None."""
    plans = plan if plan is not None else (None,) * len(scbl.views)
    return _combine([sweep(v, x, active, p)
                     for v, p in zip(scbl.views, plans)], combine, scbl.mesh)


def sharded_runs_sweep(runs, mesh, x: torch.Tensor, active, sweep: Callable,
                       combine: str) -> torch.Tensor:
    """Run a CSR sweep per shard-local sealed run and combine across the
    cut: the sealed tier of a sharded TieredGraph keeps one run a local
    shard (``runs``, a tuple), each holding the sealed vertices that shard
    owns, on the delta's ``mesh``."""
    return _combine([sweep(g, x, active) for g in runs], combine, mesh)


def sharded_process_edge_push(scbl: ShardedCBList, x: torch.Tensor,
                              active: Optional[torch.Tensor] = None, *,
                              dense_f: Callable = _default_edge_f,
                              combine: str = "sum", impl: str = "torch",
                              plan=None) -> torch.Tensor:
    """Sharded push sweep: each block's owner is shard-resident, so the
    gathers stay local and only the destination-side reduction crosses the
    cut."""
    def sweep(cbl, xx, act, p):
        return process_edge_push(cbl, xx, act, dense_f=dense_f,
                                 combine=combine, impl=impl, plan=p)
    return _sharded_sweep(scbl, x, active, sweep, combine, plan)


def sharded_process_edge_pull(scbl: ShardedCBList, x: torch.Tensor,
                              active_dst: Optional[torch.Tensor] = None, *,
                              dense_f: Callable = _default_edge_f,
                              combine: str = "sum", impl: str = "torch",
                              plan=None) -> torch.Tensor:
    """Sharded pull sweep: the x[dst] gather reads the whole value vector
    (remote destinations too), the y[src] reduction is shard-local, and
    the combine only reconciles the disjoint owned slices."""
    def sweep(cbl, xx, act, p):
        return process_edge_pull(cbl, xx, act, dense_f=dense_f,
                                 combine=combine, impl=impl, plan=p)
    return _sharded_sweep(scbl, x, active_dst, sweep, combine, plan)


def sharded_process_edge_push_feat(scbl: ShardedCBList, x: torch.Tensor,
                                   active: Optional[torch.Tensor] = None, *,
                                   weighted: bool = True, impl: str = "torch",
                                   plan=None) -> torch.Tensor:
    def sweep(cbl, xx, act, p):
        return process_edge_push_feat(cbl, xx, act, weighted=weighted,
                                      impl=impl, plan=p)
    return _sharded_sweep(scbl, x, active, sweep, "sum", plan)


def sharded_in_degrees(scbl: ShardedCBList) -> torch.Tensor:
    return _all_reduce(scbl.mesh, torch.stack(
        [in_degrees(v) for v in scbl.views]).sum(0).to(I32), SUM)


# ---------------------------------------------------------------------------
# Sharded update / read paths (routing by owning shard)
# ---------------------------------------------------------------------------

def _owner_counts(v_shard: torch.Tensor, src: torch.Tensor, op: torch.Tensor,
                  n_shards: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(owner[L], active records per shard[S]) in one pass: the routing
    statistic the lane-capacity decision needs."""
    nvc = v_shard.shape[0]
    owner = v_shard[src.clamp(0, nvc - 1).long()]
    active = op != NOP
    counts = torch.bincount(owner[active].long(), minlength=n_shards)[
        :n_shards].to(I32)
    return owner, counts


def _dedupe_delete_ops(src: torch.Tensor, dst: torch.Tensor,
                       op: torch.Tensor) -> torch.Tensor:
    """Turn duplicate DELETE records of one (src, dst) into NOPs.

    The single-batch path dedupes deletes inside ``_apply_deletes`` (only
    the first occurrence removes an edge); once a routed batch spills
    across rounds, duplicates could land in different rounds and each
    remove one parallel edge, so the spill path dedupes globally first.
    """
    is_del = op == DELETE
    keep = _dedupe_first(src, dst, is_del)
    return torch.where(is_del & ~keep, NOP, op)


def _route_compact(owner: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
                   w: torch.Tensor, op: torch.Tensor, *, n_shards: int,
                   lane_cap: int, n_rounds: int):
    """Owner-compacted routing: pack each shard's records into its own
    ``lane_cap`` lanes by one stable sort and segment offsets.

    Each field comes out ``[n_rounds, n_shards, lane_cap]`` (NOP-padded):
    round r, shard k holds that shard's records ranked
    ``[r * lane_cap, (r + 1) * lane_cap)`` in batch order, except that
    DELETEs sort ahead of INSERTs within a shard, so a round split keeps
    the all-deletes-then-all-inserts phase order.  Records past
    ``n_rounds * lane_cap`` of a shard are dropped (the caller sizes
    ``n_rounds`` from the measured per-shard maximum).
    """
    L = src.shape[0]
    dev = src.device
    active = op != NOP
    phase = torch.where(op == DELETE, 0, 1)
    key = torch.where(active, owner.long() * 2 + phase, 2 * n_shards)
    order = bs.stable_argsort(key)
    owner_s = torch.where(active[order], owner[order], n_shards).to(I32)
    starts = torch.searchsorted(owner_s, torch.arange(
        n_shards, dtype=I32, device=dev)).to(I32)
    idx = torch.arange(L, dtype=I32, device=dev)
    rank = idx - starts[owner_s.clamp(max=n_shards - 1).long()]
    rnd, lane = rank // lane_cap, rank % lane_cap
    ok = (owner_s < n_shards) & (rnd < n_rounds)
    cap = n_rounds * n_shards * lane_cap
    flat = ((rnd * n_shards + owner_s) * lane_cap + lane)[ok].long()
    shape = (n_rounds, n_shards, lane_cap)

    def scatter(vals, fill, dtype):
        out = torch.full((cap,), fill, dtype=dtype, device=dev)
        out[flat] = vals[order][ok].to(dtype)
        return out.reshape(shape)

    return (scatter(src, 0, I32), scatter(dst, 0, I32),
            scatter(w, 0.0, torch.float32), scatter(op, NOP, I32))


# lane-cap hysteresis per (n_shards, batch_len): per-flush active counts
# jitter across power-of-two boundaries, so reuse the previous (larger)
# bucket while the measured need stays within 4x of it, and rebucket only on
# real growth or a sustained 4x shrink (the JAX package keeps its compile
# cache bounded this way; here it keeps the routed shapes steady)
_ROUTE_CAP_STICKY: dict = {}


def _sticky_lane_cap(n_shards: int, batch_len: int, lane_cap: int) -> int:
    key = (n_shards, batch_len)
    prev = _ROUTE_CAP_STICKY.get(key)
    if prev is not None and lane_cap < prev <= 4 * lane_cap:
        lane_cap = prev
    _ROUTE_CAP_STICKY[key] = lane_cap
    return lane_cap


def _attribute_shard_upserts(sp, counts: np.ndarray,
                             lanes_per_shard: int) -> None:
    """Split one measurement of the shard loop into per-shard spans and
    series, in proportion to each shard's routed-lane count."""
    total_dur = float(sp.get("dur", 0.0))
    t = float(sp.get("ts", 0.0))
    tot = int(counts.sum())
    for k in range(len(counts)):
        lanes = int(counts[k])
        dur = total_dur * (lanes / tot if tot else 1.0 / len(counts))
        obs.attribute("flush.upsert.shard", t, dur, cat="shard", shard=k,
                      lanes=lanes, attributed=True)
        obs.counter("flush.routed_lanes", shard=k).inc(lanes)
        obs.counter("flush.upsert_lanes", shard=k).inc(lanes_per_shard)
        obs.series("flush.upsert_s", shard=k).observe(dur)
        t += dur


def _defaults(src, dst, w, op):
    w, op = _update_defaults(src, w, op)
    return src.to(I32), dst.to(I32), w.to(torch.float32), op.to(I32)


def sharded_batch_update_stats(scbl: ShardedCBList, src: torch.Tensor,
                               dst: torch.Tensor,
                               w: Optional[torch.Tensor] = None,
                               op: Optional[torch.Tensor] = None
                               ) -> Tuple[ShardedCBList, UpdateStats]:
    """Owner-compacted BatchUpdate: route, pack, apply per shard.

      1. one pass computes owners and per-shard active counts (one host
         read; on a mesh every rank computes the same from the replicated
         batch);
      2. :func:`repro_torch.core.tuner.choose_route_plan` picks the
         per-shard lane capacity (power-of-two bucketed, ceiling-clamped)
         and the spill-round count from the measured skew;
      3. one stable sort and segment offsets pack each shard's records into
         its own lanes (:func:`_route_compact`): per-shard work is
         O(records / shard), not O(records);
      4. each round applies each local shard's lanes with the single-CBList
         ``batch_update_stats`` (a shard with no records in a round is left
         as it is, which is what an all-NOP batch does to it), and the
         stats are summed over the mesh.

    Updates never cross the cut, so the routed result is the single-shard
    one; DELETE records sort ahead of INSERTs per shard (and duplicate
    deletes are deduped on the spill path), so round splits keep the
    delete-phase-then-insert-phase order.

    Under :mod:`repro_torch.obs`: ``flush.route`` and ``flush.upsert.fused``
    spans, per-shard ``flush.upsert.shard`` spans attributed from the
    loop's measurement by routed-lane weight, ``flush.routed_lanes`` /
    ``flush.upsert_lanes`` counters, and ``flush.spill_rounds`` /
    ``flush.shard_skew`` / ``flush.route_occupancy`` telemetry.  Obs on or
    off, the arithmetic is the same.
    """
    from repro_torch.core.tuner import choose_route_plan
    src, dst, w, op = _defaults(src, dst, w, op)
    S = scbl.n_shards
    L = int(src.shape[0])

    with obs.span("flush.route", cat="shard", lanes=L):
        owner, counts = _owner_counts(scbl.v_shard, src, op, S)
        counts_np = np.asarray(counts.tolist(), dtype=np.int64)
        max_c = int(counts_np.max())
        route = choose_route_plan(S, L, max_records=max_c,
                                  total_records=int(counts_np.sum()))
        cap = _sticky_lane_cap(S, L, route.lane_cap)
        if cap != route.lane_cap:
            route = dataclasses.replace(
                route, lane_cap=cap, n_rounds=max(1, -(-max_c // cap)))
        if route.n_rounds > 1:
            op = _dedupe_delete_ops(src, dst, op)
        r_src, r_dst, r_w, r_op = _route_compact(
            owner, src, dst, w, op, n_shards=S, lane_cap=route.lane_cap,
            n_rounds=route.n_rounds)
    obs.counter("flush.spill_rounds").inc(route.n_rounds - 1)
    obs.series("flush.shard_skew").observe(route.skew)
    # routed-lane utilisation: active records over provisioned lanes (low
    # values mean the lane cap is sized for skew the batch did not have)
    obs.series("flush.route_occupancy").observe(
        float(counts_np.sum()) / max(route.n_rounds * route.lane_cap * S, 1))

    views = list(scbl.views)
    ids = scbl.shard_ids
    zero = torch.zeros((), dtype=I32, device=src.device)
    dropped = inserts = deletes = zero
    with obs.span("flush.upsert.fused", cat="shard", rounds=route.n_rounds,
                  lane_cap=route.lane_cap) as sp:
        for r in range(route.n_rounds):
            for k in ids:
                if counts_np[k] <= r * route.lane_cap:
                    continue
                j = k - ids.start
                views[j], st = batch_update_stats(
                    views[j], r_src[r, k], r_dst[r, k], r_w[r, k],
                    r_op[r, k])
                dropped = dropped + st.dropped_edges
                inserts = inserts + st.applied_inserts
                deletes = deletes + st.applied_deletes
        out = _with_shards(scbl, views)
        if obs.enabled() and out.device.type == "cuda":
            torch.cuda.synchronize(out.device)
    if obs.enabled():
        _attribute_shard_upserts(sp, counts_np,
                                 route.n_rounds * route.lane_cap)
    stats = _all_reduce(scbl.mesh, torch.stack([dropped, inserts, deletes])
                        .to(I32), SUM)
    return out, UpdateStats(dropped_edges=stats[0], applied_inserts=stats[1],
                            applied_deletes=stats[2])


def sharded_read_edges(scbl: ShardedCBList, qsrc: torch.Tensor,
                       qdst: torch.Tensor,
                       active: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched read_edge over every shard (only the owner can find an
    edge: another shard holds no chain for the source)."""
    found, w = zip(*(read_edges(v, qsrc, qdst, active) for v in scbl.views))
    return owner_merge(found, w, scbl.mesh)


def sharded_upsert_edges(scbl: ShardedCBList, src, dst, w=None,
                         valid: Optional[torch.Tensor] = None
                         ) -> ShardedCBList:
    """Insert-or-replace routed by owning shard, in a single round: an
    upsert's delete-then-insert of one record must not split across rounds
    (a round-2 delete would remove a round-1 insert of the same key), so
    the lane capacity covers the fullest shard."""
    from repro_torch.core.tuner import MIN_ROUTE_LANES, _pow2_at_least
    valid = (torch.ones(src.shape, dtype=torch.bool, device=src.device)
             if valid is None else valid.to(torch.bool))
    op = torch.where(valid, INSERT, NOP).to(I32)
    src, dst, w, op = _defaults(src, dst, w, op)
    S = scbl.n_shards
    owner, counts = _owner_counts(scbl.v_shard, src, op, S)
    counts_np = np.asarray(counts.tolist(), dtype=np.int64)
    lane_cap = _pow2_at_least(max(MIN_ROUTE_LANES, int(counts_np.max())))
    r_src, r_dst, r_w, r_op = _route_compact(
        owner, src, dst, w, op, n_shards=S, lane_cap=lane_cap, n_rounds=1)
    views = list(scbl.views)
    ids = scbl.shard_ids
    for k in ids:
        if counts_np[k] > 0:
            views[k - ids.start] = upsert_edges(
                views[k - ids.start], r_src[0, k], r_dst[0, k], r_w[0, k],
                r_op[0, k] != NOP)
    return _with_shards(scbl, views)


def _victim_in_edge_profile(scbl: ShardedCBList, vids: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(total, remote) live in-edges into the victims across all shards:
    the read-only check that gates the all-shard in-edge sweep.
    ``remote`` counts in-edges held off the victim's owner shard."""
    nvc = scbl.capacity_vertices
    vs = torch.sort(torch.where(vids == NULL, PAD, vids))[0]
    tot = rem = torch.zeros((), dtype=torch.int64, device=scbl.device)
    for k, v in zip(scbl.shard_ids, scbl.views):
        st = v.store
        mask = lane_mask(st)
        pos = torch.searchsorted(vs, st.keys)
        hit = vs[pos.clamp(max=vs.shape[0] - 1)] == st.keys
        hit = hit & mask & (st.keys != PAD)
        vo = scbl.v_shard[st.keys.clamp(0, nvc - 1).long()]
        tot = tot + hit.sum()
        rem = rem + (hit & (vo != k)).sum()
    tot, rem = _all_reduce(scbl.mesh, torch.stack([tot, rem]), SUM)
    return tot, rem


def sharded_delete_vertices(scbl: ShardedCBList,
                            vids: torch.Tensor) -> ShardedCBList:
    """UpdateVertex(delete), with the all-shard in-edge sweep gated on a
    read-only in-edge count (:func:`_victim_in_edge_profile`):

      * no victim has in-edges anywhere -> chain free and vertex-table
        clear only (``delete.insweep{scope=none}``);
      * all in-edges are owner-local and few shards own victims -> sweep
        only those shards (``scope=owners``);
      * otherwise -> free and sweep on every shard (``scope=all``).

    The three give the same graph: a shard the sweep skips holds no edge
    into any victim.  The counts are reduced over the mesh and the owners
    read from the replicated ``v_shard``, so every rank picks one scope.
    """
    vids = vids.to(I32)
    S = scbl.n_shards
    tot, rem = (int(x) for x in torch.stack(
        _victim_in_edge_profile(scbl, vids)).tolist())
    if tot == 0:
        obs.counter("delete.insweep", scope="none").inc()
        return _with_shards(scbl, [_delete_vertex_chains(v, vids)
                                   for v in scbl.views])
    if rem == 0:
        live = vids[vids != NULL]
        owners = torch.unique(scbl.v_shard[
            live.clamp(0, scbl.capacity_vertices - 1).long()]).tolist()
        if len(owners) <= max(1, S // 2):
            obs.counter("delete.insweep", scope="owners").inc()
            parts = [_delete_vertex_chains(v, vids) for v in scbl.views]
            ids = scbl.shard_ids
            for k in owners:
                if k in ids:
                    parts[k - ids.start] = _sweep_in_edges(
                        parts[k - ids.start], vids)
            return _with_shards(scbl, parts)
    obs.counter("delete.insweep", scope="all").inc()
    return _with_shards(scbl, [delete_vertices(v, vids)
                               for v in scbl.views])


def sharded_add_vertices(scbl: ShardedCBList, k) -> ShardedCBList:
    shards = scbl.shards._replace(n_vertices=scbl.shards.n_vertices + int(k))
    return dataclasses.replace(scbl, shards=shards)


# ---------------------------------------------------------------------------
# Sharded maintenance transforms (host-orchestrated, shapes may change)
# ---------------------------------------------------------------------------

def grow_sharded(scbl: ShardedCBList, num_blocks: Optional[int] = None,
                 vertex_capacity: Optional[int] = None) -> ShardedCBList:
    """Grow every shard to the same capacity (``num_blocks`` is the
    per-shard target).  New vertex ids go to the shards round-robin: they
    carry no edges yet, so any owner is balanced."""
    shards = [grow_cbl(v, num_blocks=num_blocks,
                       vertex_capacity=vertex_capacity) for v in scbl.views]
    v_shard = scbl.v_shard
    nvc = scbl.capacity_vertices
    if vertex_capacity is not None and vertex_capacity > nvc:
        fresh = torch.arange(vertex_capacity - nvc, dtype=I32,
                             device=scbl.device) % scbl.n_shards
        v_shard = torch.cat([v_shard, fresh])
    return dataclasses.replace(scbl, shards=_restack(shards),
                               v_shard=v_shard)


def compact_sharded(scbl: ShardedCBList) -> ShardedCBList:
    """Per-shard defragmentation (restores shard-local GTChain
    contiguity)."""
    return _with_shards(scbl, [compact_cbl(v) for v in scbl.views])


def rebuild_sharded(scbl: ShardedCBList,
                    max_edges: Optional[int] = None) -> ShardedCBList:
    """Per-shard defragmenting rebuild (range-disjoint sorted chains) at
    unchanged shapes."""
    me = int(max_edges or scbl.num_blocks * scbl.block_width)
    return _with_shards(scbl, [rebuild_cbl(v, max_edges=me)
                               for v in scbl.views])


# ---------------------------------------------------------------------------
# Sharded sampling (snapshot k-hop path)
# ---------------------------------------------------------------------------

def sharded_rank_neighbors(scbl: ShardedCBList, verts: torch.Tensor,
                           ranks: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The neighbours at ``ranks`` of each vertex: every shard walks its
    chains (a vertex another shard owns has an empty chain and yields
    nothing), and the merge keeps the one owner's draw."""
    from repro_torch.graph.sampler import rank_neighbors
    out, ok = zip(*(rank_neighbors(v, verts, ranks) for v in scbl.views))
    valid, merged = owner_merge(ok, out, scbl.mesh)
    return torch.where(valid, merged, NULL), valid


def sharded_sample_neighbors(scbl: ShardedCBList, verts: torch.Tensor,
                             generator: torch.Generator, k: int
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fanout draw routed to owning shards: one rank draw over the global
    degrees (the owner's chain holds every edge of its vertex), then
    :func:`sharded_rank_neighbors`.  On a mesh every rank draws from a
    generator in the same state."""
    from repro_torch.graph.sampler import draw_ranks
    return sharded_rank_neighbors(scbl, verts,
                                  draw_ranks(scbl, verts, generator, k))
