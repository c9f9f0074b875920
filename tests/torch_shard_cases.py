"""The cases of ``tests/test_torch_shard_mesh.py``: one sharded workload run
through ``repro_torch`` at a shard count S, its results as a flat
``{name: ndarray}``.

Without a process group ``shard_mesh`` is None and the shards stack on the
one device (the reference); on a gloo group every rank runs the same calls
over its own shards.  The module imports torch and the port only, so the
gloo ranks load it without JAX.  The inputs are made with numpy from seeds
(the graph of tests/test_sharded_multidevice.py, the spill batch of
tests/test_torch_sharded.py), so the test builds the JAX references from
the same arrays.
"""
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

import repro_torch.core as tcore
import repro_torch.distributed.graph as tdist
import repro_torch.obs as tobs
from repro_torch import interop
from repro_torch.core import engine as teng
from repro_torch.graph import algorithms as talg
from repro_torch.graph.sampler import sample_subgraph
from repro_torch.stream import GraphService
from repro_torch.stream.maintenance import MaintenancePolicy, decide

NV, NB, BW = 48, 96, 8
SHARD_COUNTS = (1, 2, 4, 8)
MODES = ("auto", "all_reduce", "reduce_scatter")
# real-valued sums (the last part of a result's name), held within rtol:
# the summation order differs
SUMS = frozenset(("push", "push_active", "pull", "push_feat", "pagerank",
                  "pagerank_cuda"))
SERVICE_POLICY = dict(contiguity_floor=0.97, overlap_ceiling=0.3)


def graph_inputs():
    """tests/test_sharded_multidevice.py's graph, update batch and reads."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, NV, 300)
    dst = rng.integers(0, NV, 300)
    pairs = sorted(set(zip(src.tolist(), dst.tolist())))
    src = np.array([p[0] for p in pairs], np.int32)
    dst = np.array([p[1] for p in pairs], np.int32)
    w = rng.random(len(src)).astype(np.float32) + 0.1
    us = rng.integers(0, NV, 32).astype(np.int32)
    ud = rng.integers(0, NV, 32).astype(np.int32)
    uw = rng.random(32).astype(np.float32) + 0.1
    op = np.where(rng.random(32) < 0.3, -1, 1).astype(np.int32)
    qs = rng.integers(0, NV, 64).astype(np.int32)
    qd = rng.integers(0, NV, 64).astype(np.int32)
    return dict(src=src, dst=dst, w=w, us=us, ud=ud, uw=uw, op=op, qs=qs,
                qd=qd)


def sweep_inputs():
    rng = np.random.default_rng(3)
    return dict(x=rng.random(NV).astype(np.float32),
                xf=rng.random((NV, 4)).astype(np.float32),
                act=rng.random(NV) < 0.5,
                seeds=(np.arange(NV) % 4).astype(np.int32),
                seed_mask=np.arange(NV) % 5 == 0)


def service_batches():
    """Two update batches for the service (20 % deletes of live pairs)."""
    inp = graph_inputs()
    rng = np.random.default_rng(1)
    out = []
    for _ in range(2):
        n_del = 12
        pick = rng.choice(len(inp["src"]), n_del, replace=False)
        s = np.concatenate([rng.integers(0, NV, 48), inp["src"][pick]])
        d = np.concatenate([rng.integers(0, NV, 48), inp["dst"][pick]])
        w = rng.random(60).astype(np.float32) + 0.1
        op = np.concatenate([np.ones(48), -np.ones(n_del)])
        out.append(tuple(a.astype(t) for a, t in
                         ((s, np.int32), (d, np.int32), (w, np.float32),
                          (op, np.int32))))
    return out


def delete_inputs():
    """tests/test_torch_sharded.py's delete-scope graph (64 vertices)."""
    rng = np.random.default_rng(13)
    src = rng.integers(0, 64, 120).astype(np.int32)
    dst = rng.integers(0, 64, 120).astype(np.int32)
    w = rng.random(120).astype(np.float32) + 0.1
    return src, dst, w


def delete_victims(v_shard: np.ndarray, dst: np.ndarray):
    """(scope, extra edge or None, victims) for the three scopes."""
    lonely = [v for v in range(64) if v not in set(dst.tolist())]
    v_none, v_own, v_all = lonely[:3]
    u_own = next(u for u in range(64)
                 if u != v_own and v_shard[u] == v_shard[v_own])
    u_all = next((u for u in range(64) if v_shard[u] != v_shard[v_all]),
                 None)
    cases = [("none", None, [v_none]), ("owners", (u_own, v_own), [v_own])]
    if u_all is not None:                # S = 1 has no remote owner
        cases.append(("all", (u_all, v_all), [v_all]))
    return cases


def t(x) -> torch.Tensor:
    return torch.as_tensor(np.array(x))


def _cbl(src, dst, w, nv=NV, nb=NB, bw=BW):
    return tcore.build_from_coo(t(src), t(dst), None if w is None else t(w),
                                num_vertices=nv, num_blocks=nb,
                                block_width=bw)


def _put(out: dict, name: str, value) -> None:
    """Flatten a tensor, a (nested) dict of arrays or a number into
    ``out``."""
    if isinstance(value, dict):
        for k, v in value.items():
            _put(out, f"{name}.{k}", v)
    elif isinstance(value, torch.Tensor):
        out[name] = value.detach().cpu().numpy()
    else:
        out[name] = np.asarray(value)


def _stack(out: dict, name: str, g) -> None:
    """Every shard's arrays (gathered on a mesh) and ``v_shard``; a
    CBList's arrays (a service at S = 1 does not shard)."""
    _put(out, name, interop.sharded_to_numpy(g)
         if isinstance(g, tdist.ShardedCBList) else interop.cbl_to_numpy(g))


def _report(out: dict, name: str, rep) -> None:
    _put(out, name, np.array([rep.epoch, rep.watermark, rep.applied_inserts,
                              rep.applied_deletes, rep.grow_retries]))
    out[f"{name}.maintenance"] = np.array(rep.maintenance.kind)


def stats_row(stats: dict) -> np.ndarray:
    """A service's stats as sorted ``name=value`` strings."""
    return np.array([f"{k}={v}" for k, v in sorted(stats.items())])


def _counting_reduce_scatter(calls: dict):
    real = dist.reduce_scatter_tensor

    def counted(*a, **k):
        calls["n"] += 1
        return real(*a, **k)
    return real, counted


def sums(out: dict, sc, tag: str) -> None:
    """The sum sweeps and PageRank (both routes) under one REDUCE_MODE."""
    si = sweep_inputs()
    x, xf, act = t(si["x"]), t(si["xf"]), t(si["act"])
    _put(out, f"{tag}.push", teng.process_edge_push(sc, x))
    _put(out, f"{tag}.push_active", teng.process_edge_push(sc, x, act))
    _put(out, f"{tag}.pull", teng.process_edge_pull(sc, x, act))
    _put(out, f"{tag}.push_feat", teng.process_edge_push_feat(sc, xf))
    _put(out, f"{tag}.pagerank", talg.pagerank(sc, max_iters=10))
    ranks, iters = talg.pagerank(sc, max_iters=10, impl="cuda",
                                 return_stats=True)
    _put(out, f"{tag}.pagerank_cuda", ranks)
    _put(out, f"{tag}.pagerank_iters", iters)


def run(S: int) -> dict:
    """Every case at shard count S; the results keyed by name."""
    out = {}
    inp = graph_inputs()
    si = sweep_inputs()
    mesh = tdist.shard_mesh(S, "cpu")
    base = _cbl(inp["src"], inp["dst"], inp["w"])
    sc, _ = tdist.shard_cbl(base, S, mesh=mesh)
    out["local.ids"] = np.array(list(sc.shard_ids), np.int64)
    out["local.n_views"] = np.array(len(sc.views))
    _put(out, "local.stack", interop.cbl_to_numpy(sc.shards))
    out["mesh_size"] = np.array(0 if mesh is None else mesh.size())

    # the global view, placement statistics, merge
    _stack(out, "stack", sc)
    for k in ("n_vertices", "v_deg", "v_level", "num_edges"):
        _put(out, f"view.{k}", getattr(sc, k))
    for k in range(S):
        _put(out, f"shard_at.{k}", interop.cbl_to_numpy(tdist.shard_at(sc,
                                                                       k)))
    _put(out, "unshard", interop.cbl_to_numpy(tdist.unshard(sc)))
    _put(out, "cut_fraction", tdist.cut_fraction(sc))
    _put(out, "contiguity", tdist.shard_contiguity(sc))
    _put(out, "halo", tdist.halo_masks(sc))
    back = interop.sharded_from_arrays(interop.sharded_to_numpy(sc),
                                       device="cpu", mesh=mesh)
    _stack(out, "interop", back)

    # sweeps: min / max and in-degrees, the sums under each reduce mode
    x = t(si["x"])
    for combine in ("min", "max"):
        _put(out, f"push_{combine}",
             teng.process_edge_push(sc, x, combine=combine))
        _put(out, f"pull_{combine}",
             teng.process_edge_pull(sc, x, combine=combine))
    _put(out, "in_degrees", teng.in_degrees(sc))
    calls = {"n": 0}
    real, counted = _counting_reduce_scatter(calls)
    saved = tdist.REDUCE_MODE
    dist.reduce_scatter_tensor = counted
    try:
        for mode in MODES:
            tdist.REDUCE_MODE = mode
            calls["n"] = 0
            sums(out, sc, mode)
            out[f"local.reduce_scatters.{mode}"] = np.array(calls["n"])
    finally:
        dist.reduce_scatter_tensor = real
        tdist.REDUCE_MODE = saved

    # the integer programs
    _put(out, "bfs", talg.bfs(sc, 0))
    _put(out, "sssp", talg.sssp(sc, 1))
    _put(out, "cc", talg.connected_components(sc))
    _put(out, "lp", talg.label_propagation(sc, t(si["seeds"]),
                                           t(si["seed_mask"]), num_classes=4))
    _put(out, "triangles", talg.triangle_count(sc))
    seeds = t(np.arange(0, NV, 5).astype(np.int32))
    sg = sample_subgraph(sc, seeds, torch.Generator().manual_seed(3),
                         fanout=(4, 3))
    _put(out, "sample", {f: getattr(sg, f) for f in sg._fields})

    # the write path: a batch, reads, upsert / add / grow / compact /
    # rebuild, the maintenance decision
    us, ud, uw, op = (t(inp[k]) for k in ("us", "ud", "uw", "op"))
    b, st = tcore.batch_update_stats(sc, us, ud, uw, op)
    _put(out, "update.stats", torch.stack(list(st)))
    _stack(out, "update", b)
    f, wq = tcore.read_edges(b, t(inp["qs"]), t(inp["qd"]))
    _put(out, "read.found", f)
    _put(out, "read.w", wq)
    valid = t(np.arange(32) % 7 != 0)
    _stack(out, "upsert", tcore.upsert_edges(sc, us, ud, uw, valid))
    _stack(out, "add", tcore.add_vertices(sc, 3))
    _stack(out, "grow_blocks", tdist.grow_sharded(sc, num_blocks=2 * NB))
    grown = tdist.grow_sharded(sc, vertex_capacity=NV + 2)
    _stack(out, "grow_vertices", grown)
    xg = t(np.concatenate([si["x"], np.ones(2, np.float32)]))
    calls["n"] = 0
    dist.reduce_scatter_tensor = counted
    try:
        _put(out, "grown.push", teng.process_edge_push(grown, xg))
    finally:
        dist.reduce_scatter_tensor = real
    out["local.reduce_scatters.grown"] = np.array(calls["n"])
    _stack(out, "compact", tdist.compact_sharded(b))
    _stack(out, "rebuild", tdist.rebuild_sharded(b))
    policy = MaintenancePolicy(contiguity_floor=0.99)
    for headroom_only in (True, False):
        for pending in (0, 200):
            a = decide(b, pending, policy, headroom_only)
            out[f"decide.{int(headroom_only)}.{pending}"] = np.array(
                [a.kind, a.reason, a.num_blocks, a.vertex_capacity])

    # the skewed spill batch (tests/test_torch_sharded.py): every record
    # keyed to one hub, 35 free lanes on its shard, 61 inserts dropped
    one = np.array([0], np.int32)
    sp, _ = tdist.shard_cbl(_cbl(one, one, None, nv=24, nb=64, bw=4), S,
                            mesh=mesh, block_slack=8.0)
    tobs.reset()
    tobs.enable()
    try:
        got, st = tcore.batch_update_stats(
            sp, t(np.zeros(96, np.int32)), t(np.arange(96, dtype=np.int32)
                                             % 24), None,
            t(np.ones(96, np.int32)))
        spills = tobs.registry().snapshot()["counters"][
            "flush.spill_rounds"]
    finally:
        tobs.disable()
        tobs.reset()
    _put(out, "spill.stats", torch.stack(list(st)))
    out["spill.rounds"] = np.array(spills)
    _stack(out, "spill", got)

    # the three delete scopes
    dsrc, ddst, dw = delete_inputs()
    dsc, _ = tdist.shard_cbl(_cbl(dsrc, ddst, dw, nv=64, nb=128, bw=4), S,
                             mesh=mesh)
    for scope, extra, vids in delete_victims(
            dsc.v_shard.numpy(), ddst):
        g = dsc
        if extra is not None:
            g = tcore.batch_update_stats(
                g, t(np.array([extra[0]], np.int32)),
                t(np.array([extra[1]], np.int32)))[0]
        tobs.reset()
        tobs.enable()
        try:
            g = tcore.delete_vertices(g, t(np.array(vids, np.int32)))
            scopes = [k for k in tobs.registry().snapshot()["counters"]
                      if k.startswith("delete.insweep")]
        finally:
            tobs.disable()
            tobs.reset()
        out[f"delete.{scope}.scope"] = np.array(scopes)
        _stack(out, f"delete.{scope}", g)

    # the service: flushes (compact / rebuild policy), reads, analytics
    svc = GraphService.from_coo(
        inp["src"], inp["dst"], inp["w"], num_vertices=NV, block_width=4,
        log_capacity=256, n_shards=S, device="cpu",
        policy=MaintenancePolicy(**SERVICE_POLICY))
    if S > 1:
        assert svc.snapshot.cbl.mesh is mesh
    for r, batch in enumerate(service_batches()):
        svc.apply(*batch)
        _report(out, f"svc.flush{r}", svc.flush())
    q = np.concatenate([inp["qs"], inp["src"]]), \
        np.concatenate([inp["qd"], inp["dst"]])
    f, wq = svc.query_edges(*q)
    _put(out, "svc.found", f)
    _put(out, "svc.w", wq)
    _put(out, "svc.degrees", svc.query_degrees(q[0]))
    _put(out, "svc.pagerank", svc.analytics("pagerank"))
    _put(out, "svc.bfs", svc.analytics("bfs", source=2))
    _put(out, "svc.cc", svc.analytics("cc"))
    out["svc.stats"] = stats_row(dataclasses.asdict(svc.stats))
    plan = svc.plan("batch_update")
    out["svc.plan"] = np.array([plan.strategy, plan.impl, plan.n_shards,
                                plan.cut_fraction, plan.contiguity,
                                plan.route_lane_cap, plan.route_rounds])
    _stack(out, "svc.stack", svc.snapshot.cbl)

    # the tiered service: a first flush writes a few sources so the rest
    # seals, a second writes sealed ones, which unseal
    tsvc = GraphService.from_coo(
        inp["src"], inp["dst"], inp["w"], num_vertices=NV, num_blocks=NB,
        block_width=4, log_capacity=256, n_shards=S, seal_after_epochs=1,
        device="cpu")
    rng = np.random.default_rng(4)
    for r, hi in enumerate((6, NV)):
        s = rng.integers(0, hi, 12).astype(np.int32)
        d = rng.integers(0, NV, 12).astype(np.int32)
        tsvc.apply(s, d)
        _report(out, f"tier.flush{r}", tsvc.flush())
    tg = tsvc.snapshot.cbl
    f, wq = tsvc.query_edges(*q)
    _put(out, "tier.found", f)
    _put(out, "tier.w", wq)
    _put(out, "tier.in_degrees", tcore.in_degrees(tg))
    _put(out, "tier.pagerank", tsvc.analytics("pagerank"))
    out["tier.stats"] = stats_row(dataclasses.asdict(tsvc.stats))
    _put(out, "tier.state", {k: v for k, v in
                             interop.tiered_to_numpy(tg).items()
                             if k != "delta"})
    _stack(out, "tier.delta", tg.delta)
    return out
