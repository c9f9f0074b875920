"""Port parity of the sharded graph stack (``repro_torch.distributed.graph``:
GTChain-balanced CBList shards stacked on one device) against
``repro.distributed.graph`` on one JAX device, S in {2, 3, 4}.

Bit for bit: the placement plan and its halo, the partitions and their
balance, ``shard_cbl``'s stacked arrays, ``unshard``, the placement
statistics, min / max sweeps, in-degrees and the integer programs, the
router (``_owner_counts``, ``_route_compact``), the skewed spill batch's
stats and store (the reference's drops included), the three delete scopes
and their counters, upsert / add / grow / compact / rebuild, a sharded
service's flush reports, stats, storage and obs counters, and a sharded
tiered service.  Sums of real values (push / pull / push_feat, PageRank,
label propagation's mass) within rtol 1e-5: summation order.  A
``ServeFrontend`` replay over a sharded service against an unsharded one,
both in the port."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.engine as jeng  # noqa: E402
import repro.core.traversal as jtrav  # noqa: E402
import repro.distributed.graph as jdist  # noqa: E402
import repro.graph.algorithms as jalg  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.stream.maintenance as jmaint  # noqa: E402
from repro.data import update_stream  # noqa: E402
from repro.stream import GraphService as JService  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.distributed.graph as tdist  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch import backend, interop  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import traversal as ttrav  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.graph.sampler import sample_subgraph  # noqa: E402
from repro_torch.obs.locality import sweep_profile  # noqa: E402
from repro_torch.stream import GraphService as TService  # noqa: E402
from repro_torch.stream import maintenance as tmaint  # noqa: E402
from repro_torch.stream import snapshot as tsnap  # noqa: E402

from torch_parity import (assert_cbl_equal, assert_close,  # noqa: E402
                          assert_exact, assert_stats_equal, t)

# the tests/test_sharded.py graph: unique random pairs over 60 vertices
BW, NB = 8, 128
_RNG = np.random.default_rng(7)
_PAIRS = sorted(set(zip(_RNG.integers(0, 60, 420).tolist(),
                        _RNG.integers(0, 60, 420).tolist())))
NV = 60
SRC = np.array([p[0] for p in _PAIRS], np.int32)
DST = np.array([p[1] for p in _PAIRS], np.int32)
W = (_RNG.random(len(SRC)).astype(np.float32) + 0.1)
SHARDS = (2, 3, 4)


@pytest.fixture(autouse=True)
def _clean():
    yield
    for pkg in (jobs, tobs):
        pkg.disable()
        pkg.reset()
    jdist._ROUTE_CAP_STICKY.clear()
    tdist._ROUTE_CAP_STICKY.clear()


@pytest.fixture(scope="module", autouse=True)
def _drop_compile_caches():
    # many one-off shapes (shard counts, lane cubes): drop the JAX
    # executables on teardown, as tests/test_sharded_routing.py does
    yield
    jax.clear_caches()


def _cbls(src=SRC, dst=DST, w=W, nv=NV, nb=NB, bw=BW):
    j = jcore.build_from_coo(jnp.asarray(src), jnp.asarray(dst),
                             None if w is None else jnp.asarray(w),
                             num_vertices=nv, num_blocks=nb, block_width=bw)
    return j, interop.cbl_from_arrays(j, device="cpu")


@pytest.fixture(scope="module")
def base():
    return _cbls()


@pytest.fixture(scope="module")
def sharded(base):
    j, p = base
    return {S: (jdist.shard_cbl(j, S)[0], tdist.shard_cbl(p, S)[0])
            for S in SHARDS}


def assert_sharded_equal(j, p) -> None:
    assert_cbl_equal(j.shards, p.shards)
    assert_exact(p.v_shard, j.v_shard)


def _edges(cbl, max_edges):
    s, d, w, v = (interop.to_numpy(x) for x in (
        tcore.to_coo(cbl, max_edges) if isinstance(cbl, tcore.CBList)
        else jcore.to_coo(cbl, max_edges)))
    return sorted(zip(s[v].tolist(), d[v].tolist(),
                      np.round(w[v], 5).tolist()))


# ---------------------------------------------------------------------------
# placement, build and merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
def test_placement_plan_and_shard_cbl_are_bit_exact(base, sharded, S):
    j, p = base
    jp = jtrav.make_placement_plan(j, S, with_halo=True)
    tp = ttrav.make_placement_plan(p, S, with_halo=True)
    assert tp.n_shards == jp.n_shards
    assert tp.vertex_bounds == jp.vertex_bounds
    assert tp.blocks_per_shard == jp.blocks_per_shard
    for k in ("vertex_shard", "block_shard", "halo"):
        assert_exact(getattr(tp, k), getattr(jp, k))
    assert ttrav.make_placement_plan(p, S).halo is None
    for part in ("vertex_table_partition", "gtchain_partition"):
        jpart = getattr(jtrav, part)(j, S)
        tpart = getattr(ttrav, part)(p, S)
        assert tpart.kind == jpart.kind
        assert_exact(tpart.starts, jpart.starts)
        assert_exact(tpart.stops, jpart.stops)
        assert_exact(ttrav.partition_balance(p, tpart),
                     jtrav.partition_balance(j, jpart))
    js, ts = sharded[S]
    assert_sharded_equal(js, ts)
    assert (ts.n_shards, ts.capacity_vertices, ts.num_blocks,
            ts.block_width) == (js.n_shards, js.capacity_vertices,
                                js.num_blocks, js.block_width)
    for k in ("n_vertices", "v_deg", "v_level", "num_edges"):
        assert_exact(getattr(ts, k), getattr(js, k))
    for k in range(S):
        assert_cbl_equal(jdist.shard_at(js, k), tdist.shard_at(ts, k))
    assert_exact(tdist.halo_masks(ts), jdist.halo_masks(js))
    assert_exact(tdist.cut_fraction(ts), jdist.cut_fraction(js))
    assert_close(tdist.shard_contiguity(ts), jdist.shard_contiguity(js))
    cond = t(np.arange(NV) % 3 == 0)
    assert_exact(ttrav.scan_vertices_cond(p, cond),
                 jtrav.scan_vertices_cond(j, jnp.asarray(cond.numpy())))


@pytest.mark.parametrize("S", SHARDS)
def test_unshard_round_trips(base, sharded, S):
    js, ts = sharded[S]
    assert_cbl_equal(jdist.unshard(js), tdist.unshard(ts))
    assert_cbl_equal(jdist.unshard(js, num_blocks=NB),
                     tdist.unshard(ts, num_blocks=NB))
    assert _edges(tdist.unshard(ts), NB * BW) == _edges(base[1], NB * BW)
    slack_j = jdist.shard_cbl(base[0], S, block_slack=3.0)[0]
    slack_t = tdist.shard_cbl(base[1], S, block_slack=3.0)[0]
    assert_sharded_equal(slack_j, slack_t)


def test_shard_cbl_refuses_an_inconsistent_source():
    """A CBList built with too few blocks has a vertex table that claims
    chains the store never placed: both packages refuse to shard it."""
    j, p = _cbls(nb=24)
    with pytest.raises(ValueError, match="silently dropped"):
        jdist.shard_cbl(j, 2)
    with pytest.raises(ValueError, match="silently dropped"):
        tdist.shard_cbl(p, 2)


# ---------------------------------------------------------------------------
# sweeps and programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_sweeps_match_the_reference(sharded, S, impl):
    """``impl="cuda"`` runs the kernels' plain versions on the CPU, each
    shard through its own sweep plan."""
    js, ts = sharded[S]
    rng = np.random.default_rng(3)
    x = rng.random(NV).astype(np.float32)
    xf = rng.random((NV, 4)).astype(np.float32)
    act = rng.random(NV) < 0.5
    plan = (tuple(teng.sweep_plan(v) for v in ts.views) if impl == "cuda"
            else None)
    jx, jxf, jact = jnp.asarray(x), jnp.asarray(xf), jnp.asarray(act)
    assert_close(teng.process_edge_push(ts, t(x), impl=impl, plan=plan),
                 jeng.process_edge_push(js, jx))
    assert_close(teng.process_edge_push(ts, t(x), t(act), impl=impl,
                                        plan=plan),
                 jeng.process_edge_push(js, jx, jact))
    assert_close(teng.process_edge_pull(ts, t(x), t(act), impl=impl,
                                        plan=plan),
                 jeng.process_edge_pull(js, jx, jact))
    assert_close(teng.process_edge_push_feat(ts, t(xf), impl=impl,
                                             plan=plan),
                 jeng.process_edge_push_feat(js, jxf))
    for combine in ("min", "max"):
        assert_exact(teng.process_edge_push(ts, t(x), combine=combine,
                                            impl=impl),
                     jeng.process_edge_push(js, jx, combine=combine))
        assert_exact(teng.process_edge_pull(ts, t(x), combine=combine,
                                            impl=impl),
                     jeng.process_edge_pull(js, jx, combine=combine))
    assert_exact(teng.in_degrees(ts), jeng.in_degrees(js))


@pytest.mark.parametrize("S", SHARDS)
def test_programs_match_the_reference(sharded, S):
    js, ts = sharded[S]
    assert_close(talg.pagerank(ts, max_iters=10), jalg.pagerank(js,
                                                                max_iters=10))
    assert_exact(talg.bfs(ts, 0), jalg.bfs(js, jnp.int32(0)))
    assert_exact(talg.sssp(ts, 1), jalg.sssp(js, jnp.int32(1)))
    assert_exact(talg.connected_components(ts),
                 jalg.connected_components(js))
    seeds = (np.arange(NV) % 4).astype(np.int32)
    mask = np.arange(NV) % 5 == 0
    assert_exact(talg.label_propagation(ts, t(seeds), t(mask),
                                        num_classes=4),
                 jalg.label_propagation(js, seeds, mask, num_classes=4))
    assert_exact(talg.triangle_count(ts), jalg.triangle_count(js))


def test_kernel_route_programs_build_one_plan_a_shard(sharded):
    """On the kernel route a program lays each shard out once per run (one
    sweep plan a shard), whatever its iteration count."""
    js, ts = sharded[3]
    backend.reset_launch_counts()
    ranks, iters = talg.pagerank(ts, max_iters=10, impl="cuda",
                                 return_stats=True)
    assert iters > 1 and backend.PLAN_BUILDS == 3
    assert_close(ranks, jalg.pagerank(js, max_iters=10))
    assert_exact(talg.connected_components(ts, impl="cuda"),
                 jalg.connected_components(js))


# ---------------------------------------------------------------------------
# the router and the write path
# ---------------------------------------------------------------------------

def _batch(n, nv=NV, seed=0, nop=0.1, dele=0.3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, nv, n).astype(np.int32)
    dst = rng.integers(0, nv, n).astype(np.int32)
    w = rng.random(n).astype(np.float32)
    u = rng.random(n)
    op = np.where(u < nop, 0, np.where(u < nop + dele, -1, 1)).astype(
        np.int32)
    return src, dst, w, op


@pytest.mark.parametrize("S,lane_cap,n_rounds", [(2, 8, 4), (3, 16, 2),
                                                 (4, 8, 1)])
def test_owner_counts_and_route_compact_are_bit_exact(sharded, S, lane_cap,
                                                      n_rounds):
    js, ts = sharded[S]
    src, dst, w, op = _batch(90, nv=NV + 4, seed=S)
    src[:3] = (-2, NV + 1, NV + 3)                 # clipped onto owners
    jo, jc = jdist._owner_counts(js.v_shard, jnp.asarray(src),
                                 jnp.asarray(op), S)
    to, tc = tdist._owner_counts(ts.v_shard, t(src), t(op), S)
    assert_exact(to, jo)
    assert_exact(tc, jc)
    ref = jdist._route_compact(jo, *map(jnp.asarray, (src, dst, w, op)),
                               n_shards=S, lane_cap=lane_cap,
                               n_rounds=n_rounds)
    got = tdist._route_compact(to, *map(t, (src, dst, w, op)), n_shards=S,
                               lane_cap=lane_cap, n_rounds=n_rounds)
    for g, r in zip(got, ref):
        assert_exact(g, r)
    assert_exact(tdist._dedupe_delete_ops(t(src), t(dst), t(op)),
                 jdist._dedupe_delete_ops(*map(jnp.asarray, (src, dst, op))))


def _hub_batch(hub, n=96, seed=0):
    rng = np.random.default_rng(seed)
    us = np.full(n, hub, np.int32)
    ud = rng.integers(0, 24, n).astype(np.int32)
    op = rng.choice(np.array([1, 1, -1], np.int32), n)
    return us, ud, op


@pytest.mark.parametrize("S,slack", [(3, 8.0), (4, 8.0)])
def test_skewed_spill_batch_matches_the_sharded_reference(S, slack):
    """Every record keyed to one hub: one shard takes the whole batch and
    the router spills.  At ``block_slack=8`` a shard has
    ``max(8, ceil(1 * 8) + 1) = 9`` blocks of width 4, so the hub's chain
    has 35 free lanes and the reference drops 61 of its 96 inserts (the
    falsifying example of tests/test_sharded_property.py): the port holds
    the reference's sharded result, drops and store included."""
    ej, ep = _cbls(np.array([0], np.int32), np.array([0], np.int32), None,
                   nv=24, nb=64, bw=4)
    us = np.zeros(96, np.int32)
    ud = np.arange(96, dtype=np.int32) % 24
    op = np.ones(96, np.int32)
    js = jdist.shard_cbl(ej, S, block_slack=slack)[0]
    ts = tdist.shard_cbl(ep, S, block_slack=slack)[0]
    jout, jst = jcore.batch_update_stats(js, jnp.asarray(us),
                                         jnp.asarray(ud), None,
                                         jnp.asarray(op))
    tobs.enable()
    tout, tst = tcore.batch_update_stats(ts, t(us), t(ud), None, t(op))
    assert tobs.registry().snapshot()["counters"]["flush.spill_rounds"] >= 1
    tobs.disable()
    assert tuple(int(x) for x in tst) == tuple(int(x) for x in jst) \
        == (61, 35, 0)
    assert_sharded_equal(jout, tout)


@pytest.mark.parametrize("S,hub,seed", [(3, 0, 0), (4, 5, 1), (2, 17, 2)])
def test_skewed_spill_batch_matches_the_unsharded_oracle(S, hub, seed):
    """The same skew at a slack where no shard drops: stats equal the
    unsharded ``batch_update_stats`` and the edge sets agree; and the store
    equals the reference's sharded store bit for bit."""
    src, dst, _, _ = _batch(40, nv=24, seed=seed, nop=0.0, dele=0.0)
    ej, ep = _cbls(src, dst, None, nv=24, nb=64, bw=4)
    us, ud, op = _hub_batch(hub, seed=seed)
    oracle, ost = tcore.batch_update_stats(ep, t(us), t(ud), None, t(op))
    ts = tdist.shard_cbl(ep, S, block_slack=64.0)[0]
    js = jdist.shard_cbl(ej, S, block_slack=64.0)[0]
    tout, tst = tcore.batch_update_stats(ts, t(us), t(ud), None, t(op))
    jout, jst = jcore.batch_update_stats(js, *map(jnp.asarray, (us, ud)),
                                         None, jnp.asarray(op))
    assert tuple(int(x) for x in tst) == tuple(int(x) for x in ost) \
        == tuple(int(x) for x in jst)
    assert int(ost.dropped_edges) == 0
    assert_sharded_equal(jout, tout)
    me = 64 * 4 * S
    assert _edges(tdist.unshard(tout, num_blocks=64 * S), me) \
        == _edges(oracle, me)


def _delete_scope(pkg):
    counters = pkg.registry().snapshot()["counters"]
    scopes = [k for k in counters if k.startswith("delete.insweep")]
    assert len(scopes) == 1, scopes
    return scopes[0]


@pytest.mark.parametrize("S", [2, 4])
def test_delete_scopes_match_the_reference(S):
    """Victims with no in-edges (scope none), with in-edges held on their
    owner only (owners) and with a remote in-edge (all): the same scope and
    the same store in both packages."""
    nv = 64
    rng = np.random.default_rng(13)
    src = rng.integers(0, nv, 120).astype(np.int32)
    dst = rng.integers(0, nv, 120).astype(np.int32)
    ej, ep = _cbls(src, dst, rng.random(120).astype(np.float32) + 0.1,
                   nv=nv, nb=128, bw=4)
    js, ts = jdist.shard_cbl(ej, S)[0], tdist.shard_cbl(ep, S)[0]
    vs = interop.to_numpy(ts.v_shard)[:nv]
    lonely = [v for v in range(nv) if v not in set(dst.tolist())]
    v_none, v_own, v_all = lonely[:3]
    u_own = next(u for u in range(nv) if u != v_own and vs[u] == vs[v_own])
    u_all = next(u for u in range(nv) if vs[u] != vs[v_all])

    def add_edge(u, v):
        s, d = np.array([u], np.int32), np.array([v], np.int32)
        return (jcore.batch_update_stats(js, jnp.asarray(s),
                                         jnp.asarray(d))[0],
                tcore.batch_update_stats(ts, t(s), t(d))[0])

    for want, (jb, tb), vids in (("none", (js, ts), [v_none]),
                                 ("owners", add_edge(u_own, v_own), [v_own]),
                                 ("all", add_edge(u_all, v_all), [v_all])):
        outs = []
        for pkg, core, b, conv in ((jobs, jcore, jb, jnp.asarray),
                                   (tobs, tcore, tb, t)):
            pkg.reset()
            pkg.enable()
            outs.append(core.delete_vertices(b, conv(np.array(vids,
                                                              np.int32))))
            assert _delete_scope(pkg) == f"delete.insweep{{scope={want}}}"
            pkg.disable()
        assert_sharded_equal(*outs)


@pytest.mark.parametrize("S", [3])
def test_upsert_add_and_maintenance_transforms_are_bit_exact(sharded, S):
    js, ts = sharded[S]
    src, dst, w, _ = _batch(30, seed=S + 10)
    valid = np.arange(30) % 7 != 0
    assert_sharded_equal(
        jcore.upsert_edges(js, *map(jnp.asarray, (src, dst, w, valid))),
        tcore.upsert_edges(ts, *map(t, (src, dst, w, valid))))
    assert_sharded_equal(jcore.add_vertices(js, 3),
                         tcore.add_vertices(ts, 3))
    assert_sharded_equal(jdist.grow_sharded(js, num_blocks=2 * NB),
                         tdist.grow_sharded(ts, num_blocks=2 * NB))
    assert_sharded_equal(jdist.grow_sharded(js, vertex_capacity=NV + 9),
                         tdist.grow_sharded(ts, vertex_capacity=NV + 9))
    s2, d2, w2, op2 = _batch(60, seed=S + 20, nop=0.0)
    jb = jcore.batch_update_stats(js, *map(jnp.asarray, (s2, d2, w2, op2)))[0]
    tb = tcore.batch_update_stats(ts, *map(t, (s2, d2, w2, op2)))[0]
    assert_sharded_equal(jb, tb)
    assert_sharded_equal(jdist.compact_sharded(jb), tdist.compact_sharded(tb))
    assert_sharded_equal(jdist.rebuild_sharded(jb),
                         tdist.rebuild_sharded(tb))
    for headroom_only in (True, False):
        for pending in (0, 200):
            assert tuple(tmaint.decide(tb, pending, tmaint.MaintenancePolicy(
                contiguity_floor=0.99), headroom_only)) == tuple(
                jmaint.decide(jb, pending, jmaint.MaintenancePolicy(
                    contiguity_floor=0.99), headroom_only))
    qs = np.concatenate([s2, src]).astype(np.int32)
    qd = np.concatenate([d2, dst]).astype(np.int32)
    for got, ref in zip(tcore.read_edges(tb, t(qs), t(qd)),
                        jcore.read_edges(jb, jnp.asarray(qs),
                                         jnp.asarray(qd))):
        assert_exact(got, ref)


def test_sampler_routes_to_the_owner(base, sharded):
    """One rank draw over the global degrees, each vertex's chain walked
    on its owner: the same sample as the unsharded graph's."""
    _, p = base
    _, ts = sharded[4]
    seeds = t(np.arange(0, NV, 5).astype(np.int32))
    a = sample_subgraph(ts, seeds, torch.Generator().manual_seed(3),
                        fanout=(4, 3))
    b = sample_subgraph(p, seeds, torch.Generator().manual_seed(3),
                        fanout=(4, 3))
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    found, _ = tcore.read_edges(ts, a.src[a.valid], a.dst[a.valid])
    assert bool(found.all()) and int(a.valid.sum()) > 0


# ---------------------------------------------------------------------------
# the sharded service
# ---------------------------------------------------------------------------

def _counters(pkg):
    rep = pkg.report()
    return {k: v for k, v in rep["metrics"]["counters"].items()
            if k.startswith(("flush.", "maint.", "delete.", "log."))}


def test_sharded_service_matches_the_reference():
    """Flushes through ``GraphService(n_shards=3)`` in both packages under
    observability, with a policy that compacts and rebuilds: reports,
    stats, storage, reads, analytics and counters equal."""
    policy = dict(contiguity_floor=0.97, overlap_ceiling=0.3)
    kw = dict(num_vertices=NV, block_width=4, log_capacity=512, n_shards=3)
    j = JService.from_coo(SRC, DST, W, policy=jmaint.MaintenancePolicy(
        **policy), **kw)
    p = TService.from_coo(SRC, DST, W, policy=tmaint.MaintenancePolicy(
        **policy), device="cpu", **kw)
    assert_sharded_equal(j.snapshot.cbl, p.snapshot.cbl)
    kinds = set()
    for pkg in (jobs, tobs):
        pkg.enable()
    for s, d, uw, op in update_stream(NV, (SRC, DST), 150, 2, seed=1):
        j.apply(s, d, uw, op)
        p.apply(s, d, uw, op)
        jr, pr = j.flush(), p.flush()
        assert pr._replace(maintenance=None) == jr._replace(maintenance=None)
        assert tuple(pr.maintenance) == tuple(jr.maintenance)
        kinds.add(pr.maintenance.kind)
    assert _counters(tobs) == _counters(jobs)
    for pkg in (jobs, tobs):
        pkg.disable()
    assert kinds & {"compact", "rebuild"}
    assert_stats_equal(j.stats, p.stats)
    assert_sharded_equal(j.snapshot.cbl, p.snapshot.cbl)
    qs = np.concatenate([SRC, np.arange(NV)]).astype(np.int32)
    qd = np.concatenate([DST, np.arange(NV)[::-1]]).astype(np.int32)
    for got, ref in zip(p.query_edges(qs, qd), j.query_edges(qs, qd)):
        assert_exact(got, ref)
    assert_exact(p.query_degrees(qs), j.query_degrees(qs))
    assert_close(p.analytics("pagerank"), j.analytics("pagerank"))
    assert_exact(p.analytics("bfs", source=2), j.analytics("bfs", source=2))
    assert_exact(p.analytics("cc"), j.analytics("cc"))
    ref, got = jobs.sweep_profile(j.snapshot.cbl), \
        sweep_profile(p.snapshot.cbl)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k


def test_sharded_service_grow_retry_and_refusal():
    """A flush that overflows every shard grows the whole stack and
    retries loss-free, as the reference does; a shard stack handed over
    with another shard count is refused."""
    rng = np.random.default_rng(2)
    us = rng.integers(0, 32, 256).astype(np.int32)
    ud = rng.integers(0, 32, 256).astype(np.int32)
    kw = dict(num_vertices=32, num_blocks=16, block_width=8,
              log_capacity=512, n_shards=2)
    j = JService.from_coo(np.array([0, 1], np.int32),
                          np.array([1, 2], np.int32), None, **kw)
    p = TService.from_coo(np.array([0, 1], np.int32),
                          np.array([1, 2], np.int32), None, device="cpu",
                          **kw)
    for svc in (j, p):
        svc.apply(us, ud)
    jr, pr = j.flush(), p.flush()
    assert pr._replace(maintenance=None) == jr._replace(maintenance=None)
    assert pr.grow_retries >= 1 or p.stats.grows >= 1
    assert_stats_equal(j.stats, p.stats)
    assert_sharded_equal(j.snapshot.cbl, p.snapshot.cbl)
    found, _ = p.query_edges(us, ud)
    assert bool(found.all())
    with pytest.raises(ValueError, match="already sharded"):
        TService(p.snapshot.cbl, n_shards=4)
    assert TService(p.snapshot.cbl).plan("scan_all").n_shards == 2


def test_serve_frontend_replay_over_a_sharded_service():
    """The tiered test's two-tenant trace through a sharded and an
    unsharded port service: sharding is invisible to reads, so values and
    versions agree bit for bit.  Per-shard maintenance reorders a chain's
    neighbours (a shard compacts or rebuilds on its own statistics), so
    k-hop draws are held to their shape only."""
    from test_torch_tiered import (DST as TDST, KINDS,  # noqa: F401
                                   NV as TNV, SRC as TSRC, _replay, _trace)
    trace = _trace()
    sharded_svc, plain_svc = (TService.from_coo(
        TSRC, TDST, None, num_vertices=TNV, num_blocks=96, block_width=4,
        log_capacity=128, device="cpu", **kw)
        for kw in ({"n_shards": 3}, {}))
    (sf, st), (pf, pt) = _replay(tserve, sharded_svc, trace), \
        _replay(tserve, plain_svc, trace)
    for (_, k, *_), a, b in zip(trace, pt, st):
        assert a.done and b.done and a.version == b.version, (a, b)
        if k == 4:
            torch.testing.assert_close(b.value, a.value, rtol=1e-5,
                                       atol=1e-7)
        elif k == 2:
            assert a.value == b.value
        elif k == 3:
            assert b.value["src"].shape == a.value["src"].shape
            assert b.value["valid"].shape == a.value["valid"].shape
        else:
            for key in a.value:
                assert np.array_equal(b.value[key], a.value[key]), key
    assert sf.report()["service"] == pf.report()["service"]
    assert isinstance(sharded_svc.snapshot.cbl, tdist.ShardedCBList)


def _tiered_state_equal(j, p):
    assert_sharded_equal(j.delta, p.delta)
    assert isinstance(p.runs, tuple) and len(p.runs) == j.delta.n_shards
    for k, run in enumerate(p.runs):
        for f in ("offsets", "indices", "weights", "row"):
            assert_exact(getattr(run, f), np.asarray(getattr(j.runs, f))[k])
    assert_exact(p.sealed, j.sealed)
    assert_exact(p.v_epoch, j.v_epoch)
    assert (p.wgen, p.run_version) == (int(j.wgen), int(j.run_version))


def test_sharded_tiered_service_matches_the_reference():
    """``GraphService(n_shards=2, seal_after_epochs=1)``: a first flush
    writes a few sources, so the rest seals; a second writes some sealed
    vertices, which unseal.  The tiered shard stack, its per-shard runs,
    reports, stats and reads match the reference bit for bit, PageRank
    within rtol."""
    kw = dict(num_vertices=NV, num_blocks=NB, block_width=4,
              log_capacity=256, n_shards=2, seal_after_epochs=1)
    j = JService.from_coo(SRC, DST, W, **kw)
    p = TService.from_coo(SRC, DST, W, device="cpu", **kw)
    assert p.snapshot.cbl.is_sharded
    rng = np.random.default_rng(4)
    for hi in (6, NV):
        s = rng.integers(0, hi, 12).astype(np.int32)
        d = rng.integers(0, NV, 12).astype(np.int32)
        j.apply(s, d)
        p.apply(s, d)
        jr, pr = j.flush(), p.flush()
        assert pr._replace(maintenance=None) == jr._replace(maintenance=None)
        assert tuple(pr.maintenance) == tuple(jr.maintenance)
        assert p.snapshot.tier_version == j.snapshot.tier_version
    assert p.stats.seals >= 1 and p.stats.unseals >= 1
    assert_stats_equal(j.stats, p.stats)
    _tiered_state_equal(j.snapshot.cbl, p.snapshot.cbl)
    restored = interop.tiered_from_arrays(j.snapshot.cbl, device="cpu")
    _tiered_state_equal(j.snapshot.cbl, restored)
    back = interop.tiered_to_numpy(p.snapshot.cbl)
    for f in ("offsets", "indices", "weights", "row"):
        np.testing.assert_array_equal(back["runs"][f],
                                      np.asarray(getattr(j.snapshot.cbl.runs,
                                                         f)))
    _tiered_state_equal(j.snapshot.cbl,
                        interop.tiered_from_arrays(back, device="cpu"))
    qs = np.concatenate([SRC, np.arange(NV)]).astype(np.int32)
    qd = np.concatenate([DST, np.arange(NV)[::-1]]).astype(np.int32)
    for got, ref in zip(p.query_edges(qs, qd), j.query_edges(qs, qd)):
        assert_exact(got, ref)
    assert_exact(p.query_degrees(qs), j.query_degrees(qs))
    assert_exact(tcore.in_degrees(p.snapshot.cbl),
                 jeng.in_degrees(j.snapshot.cbl))
    ref = j.analytics("pagerank")
    assert_close(p.analytics("pagerank"), ref)
    tg = p.snapshot.cbl
    backend.reset_launch_counts()
    assert_close(talg.pagerank(tg, impl="cuda"), ref)
    assert backend.PLAN_BUILDS == 2             # the delta's shards only
    copy = tsnap.device_replica(p.snapshot, "cpu")
    _tiered_state_equal(j.snapshot.cbl, copy.cbl)
    sg = sample_subgraph(tg, t(np.arange(0, NV, 4).astype(np.int32)),
                         torch.Generator().manual_seed(0), fanout=(3, 2))
    found, _ = tcore.read_edges(tg, sg.src[sg.valid], sg.dst[sg.valid])
    assert bool(found.all())
