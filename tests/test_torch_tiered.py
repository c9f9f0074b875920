"""Port parity of tiered storage (``repro_torch.core.tiered``: sealed CSR
runs under the CBList delta) against ``repro.core.tiered`` on one device,
mirroring ``tests/test_tiered.py`` at ``n_shards=1``.

Bit for bit: ``sealed``, ``v_epoch``, ``wgen``, ``run_version``, both
tiers' arrays and the delta's store after the repartition's seal and
unseal (``seal`` / ``unseal``), grow, compaction and rebuild.  Where the
port moves vertices instead (a write that unseals, upsert,
delete-vertices, the maintenance seal, the service's flush), the layout
differs by design (the delta keeps its capacity, the run keeps retired
lanes until a seal), so the same tiers' edge sets, degrees and every
point read are held instead.  Reads, degrees, the sampler fed the
reference's ranks, BFS / SSSP / CC, flush reports, service stats,
``tier_version`` and the ``seal.*`` counters; one ``ServeFrontend``
replay's values and versions.  PageRank and real-valued sums within rtol
1e-5 (summation order).  Seeded flushes through the moves are held
against the untiered service and the repartition of the same graph."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.engine as jeng  # noqa: E402
import repro.core.tiered as jtier  # noqa: E402
import repro.graph.algorithms as jalg  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.stream.maintenance as jmaint  # noqa: E402
from repro.graph.sampler import sample_subgraph as jsample  # noqa: E402
from repro.stream import GraphService as JService  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch import backend, interop  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import tiered as ttier  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.graph.sampler import sample_subgraph as tsample  # noqa: E402
from repro_torch.obs.locality import sweep_profile  # noqa: E402
from repro_torch.stream import GraphService as TService  # noqa: E402
from repro_torch.stream import maintenance as tmaint  # noqa: E402
from repro_torch.stream import snapshot as tsnap  # noqa: E402

from torch_parity import (assert_cbl_equal, assert_close,  # noqa: E402
                          assert_exact, assert_stats_equal, t)

# the tests/test_tiered.py graph: 160 random edges over 48 vertices
NV = 48
_RNG = np.random.default_rng(7)
SRC = _RNG.integers(0, NV, 160).astype(np.int32)
DST = _RNG.integers(0, NV, 160).astype(np.int32)
HALF = np.arange(NV) % 2 == 0


def assert_tiered_equal(j, p) -> None:
    assert_cbl_equal(j.delta, p.delta)
    for k in ("offsets", "indices", "weights", "row"):
        assert_exact(getattr(p.runs, k), getattr(j.runs, k))
    assert p.runs.nv == j.runs.nv
    assert_exact(p.sealed, j.sealed)
    assert_exact(p.v_epoch, j.v_epoch)
    assert (p.wgen, p.run_version) == (int(j.wgen), int(j.run_version))


def _tier_edges(tg):
    """Each tier's live edges as sorted ``(src, dst, weight)`` rows (a JAX
    graph read through ``interop``)."""
    if not isinstance(tg, ttier.TieredGraph):
        tg = interop.tiered_from_arrays(tg, device="cpu")
    out = []
    for s, d, w, ok in (tcore.to_coo(tg.delta),
                        tcore.csr_to_coo(tg.runs, tg.sealed)):
        out.append(sorted(zip(s[ok].tolist(), d[ok].tolist(),
                              w[ok].tolist())))
    return out


def assert_tiered_same(j, p) -> None:
    """The same edges in the same tiers, whatever the layout: each tier's
    edge set, ``sealed``, ``v_epoch``, ``wgen``, ``run_version``, the
    degrees and every point read (out-of-range sources among them); no
    sealed vertex holds a delta edge."""
    assert _tier_edges(p) == _tier_edges(j)
    assert_exact(p.sealed, j.sealed)
    assert_exact(p.v_epoch, j.v_epoch)
    assert (p.wgen, p.run_version) == (int(j.wgen), int(j.run_version))
    assert_exact(p.v_deg, j.v_deg)
    assert_exact(teng.in_degrees(p), jeng.in_degrees(j))
    assert not bool((p.sealed & (p.delta.v_deg > 0)).any())
    nv = p.capacity_vertices
    qs = np.repeat(np.arange(-1, nv + 1, dtype=np.int32), nv)
    qd = np.tile(np.arange(nv, dtype=np.int32), nv + 2)
    for got, ref in zip(tcore.read_edges(p, t(qs), t(qd)),
                        jcore.read_edges(j, jnp.asarray(qs),
                                         jnp.asarray(qd))):
        assert_exact(got, ref)


def _assert_same_delta(a, b) -> None:
    """Two deltas hold the same arrays, store and vertex table."""
    for x, y in ((a.store, b.store), (a, b)):
        for k, v in y._asdict().items():
            if torch.is_tensor(v):
                assert torch.equal(getattr(x, k), v), k


def _cbls(num_blocks=96, vertex_capacity=None):
    j = jcore.build_from_coo(jnp.asarray(SRC), jnp.asarray(DST), None,
                             num_vertices=NV, num_blocks=num_blocks,
                             block_width=4, vertex_capacity=vertex_capacity)
    return j, interop.cbl_from_arrays(j, device="cpu")


@pytest.fixture(scope="module")
def tiered():
    j, p = _cbls()
    return (jcore.seal(jcore.tier_from_cbl(j), jnp.asarray(HALF)),
            tcore.seal(tcore.tier_from_cbl(p), t(HALF)))


def test_seal_unseal_lifecycle_is_bit_exact(tiered):
    """The repartition (a sharded store's seal and unseal) bit for bit the
    reference's; the moves (one store's ``seal`` / ``unseal``) hold the
    same tiers, the delta's capacity kept and the unsealed rows retired."""
    j0, p0 = _cbls()
    jt, pt = tiered
    rep = ttier._repartition(tcore.tier_from_cbl(p0), t(HALF))
    assert_tiered_equal(jt, rep)
    assert_tiered_same(jt, pt)
    assert pt.run_version == 1 and bool((pt.sealed == t(HALF)).all())
    assert int(torch.where(t(HALF), pt.delta.v_deg, 0).sum()) == 0
    assert torch.equal(pt.v_deg, p0.v_deg)
    assert int(pt.num_edges) == int(p0.num_edges)
    assert pt.num_blocks == p0.store.num_blocks and pt.run_retired == 0
    back_j, back_p = jcore.unseal(jt, jnp.asarray(HALF)), \
        tcore.unseal(pt, t(HALF))
    assert_tiered_equal(back_j, ttier._repartition(rep, rep.sealed & ~t(HALF)))
    assert_tiered_same(back_j, back_p)
    assert back_p.run_version == 2 and int(back_p.run_edges) == 0
    assert back_p.run_retired == pt.runs.n_live > 0     # rows left retired
    assert tcore.unseal(back_p, t(HALF)) is back_p       # nothing sealed
    everything = np.ones(NV, bool)
    all_j = jcore.seal(jcore.tier_from_cbl(j0), jnp.asarray(everything))
    all_p = tcore.seal(tcore.tier_from_cbl(p0), t(everything))
    all_rep = ttier._repartition(tcore.tier_from_cbl(p0), t(everything))
    assert_tiered_equal(all_j, all_rep)
    assert_tiered_same(all_j, all_p)
    assert all_rep.num_blocks < p0.store.num_blocks   # the rebuild shrinks
    assert all_p.num_blocks == p0.store.num_blocks    # the move keeps it
    # an empty delta: its plan holds no lanes, the run carries the sweep
    assert_close(talg.pagerank(all_p, max_iters=6, impl="cuda"),
                 talg.pagerank(p0, max_iters=6, impl="torch"))


@pytest.mark.parametrize("every", [1, 3])
def test_unseal_lays_out_the_chains_the_insert_pass_would(tiered, every):
    """The unseal's fresh chains are, block for block and lane for lane,
    the ones the insert pass makes of the same run rows (which sorts them
    and each block again)."""
    from repro_torch.core.updates import _apply_inserts
    _, pt = tiered
    hit = pt.sealed & (torch.arange(NV) % every == 0)
    (n_blocks, free), verts, deg, k, dst, w = ttier._run_rows(pt, hit)
    assert torch.equal(verts, torch.nonzero(hit).squeeze(1))
    assert 0 < n_blocks <= free
    src = verts[k].to(torch.int32)
    got = ttier._append_chains(pt.delta, verts, deg, k, dst, w, n_blocks)
    want, dropped = _apply_inserts(pt.delta, src, dst, w,
                                   torch.ones(src.shape, dtype=torch.bool))
    assert int(dropped) == 0
    _assert_same_delta(got, want)


@pytest.mark.parametrize("write", ["upsert", "batch"])
def test_an_unseal_into_a_full_delta_keeps_every_edge(write):
    """A write to a sealed vertex while the delta has no free block: the
    unseal grows the delta before it moves the vertex's rows, so none is
    lost, and the graph answers as an untiered store given the same
    write does (its stats the same)."""
    _, p = _cbls()
    tg = tcore.seal(tcore.tier_from_cbl(p), t(HALF))
    hot = np.flatnonzero(~HALF).astype(np.int32)
    tg = tcore.upsert_edges(tg, t(np.repeat(hot, NV)),
                            t(np.tile(np.arange(NV, dtype=np.int32),
                                      len(hot))))
    assert int(tg.delta.store.free_top) == 0       # the delta is full
    rows = sorted(sum(_tier_edges(tg), []))
    s, d, w = (np.asarray(c, dt) for c, dt in zip(
        zip(*rows), (np.int32, np.int32, np.float32)))
    ref = tcore.build_from_coo(t(s), t(d), t(w), num_vertices=NV,
                               num_blocks=4096, block_width=4)
    deg = tg.run_degrees.numpy()
    v = int(np.flatnonzero(HALF & (deg > 4))[0])
    own = d[s == v]
    new = int(np.setdiff1d(np.arange(NV), own)[0])
    if write == "upsert":
        args = (t(np.array([v, v], np.int32)),
                t(np.array([new, own[0]], np.int32)),
                t(np.array([2.5, 3.5], np.float32)))
        got, want = (tcore.upsert_edges(g, *args) for g in (tg, ref))
    else:
        args = (t(np.array([v, v], np.int32)),
                t(np.array([new, own[1]], np.int32)), None,
                t(np.array([1, -1], np.int32)))
        (got, gs), (want, ws) = (tcore.batch_update_stats(g, *args)
                                 for g in (tg, ref))
        assert tuple(int(x) for x in gs) == tuple(int(x) for x in ws)
    assert got.num_blocks > tg.num_blocks and not bool(got.sealed[v])
    assert int(got.v_deg[v]) == int(deg[v]) + (1 if write == "upsert"
                                               else 0)
    es, ed, ew, ok = tcore.to_coo(want)
    assert sorted(sum(_tier_edges(got), [])) == sorted(zip(
        es[ok].tolist(), ed[ok].tolist(), ew[ok].tolist()))
    _same_answers(got, want, NV)


def test_a_write_unseals_its_vertex(tiered):
    jt, pt = tiered
    v = int(np.flatnonzero(HALF)[1])
    us = np.array([v, 1, v, 7], np.int32)
    ud = np.array([(v + 1) % NV, 5, int(DST[0]), 3], np.int32)
    op = np.array([1, 1, -1, 0], np.int32)
    j2, js = jcore.batch_update_stats(jt, jnp.asarray(us), jnp.asarray(ud),
                                      None, jnp.asarray(op))
    p2, ps = tcore.batch_update_stats(pt, t(us), t(ud), None, t(op))
    assert_tiered_same(j2, p2)
    assert tuple(int(x) for x in ps) == tuple(int(x) for x in js)
    assert not bool(p2.sealed[v]) and p2.run_version == pt.run_version + 1
    assert int(p2.v_epoch[v]) == p2.wgen
    for k in (1, 2):
        assert_exact(ttier.cold_mask(p2, k), jtier.cold_mask(j2, k))
    assert bool(pt.sealed[v])               # the input graph is untouched
    # a move: the run keeps v's rows, retired; the delta keeps its capacity
    assert p2.runs is pt.runs and p2.num_blocks == pt.num_blocks
    assert p2.run_retired == int(pt.run_degrees[v]) > 0


def test_upsert_delete_add_and_grow_are_bit_exact(tiered):
    jt, pt = tiered
    s, d = np.array([0, 2, 3], np.int32), np.array([9, 9, 4], np.int32)
    w = np.array([2.5, 3.5, 1.0], np.float32)
    jt = jcore.upsert_edges(jt, jnp.asarray(s), jnp.asarray(d),
                            jnp.asarray(w))
    pt = tcore.upsert_edges(pt, t(s), t(d), t(w))
    assert_tiered_same(jt, pt)
    assert pt.run_retired > 0               # 0 and 2 moved, rows retired
    victims = np.array([int(np.flatnonzero(np.asarray(jt.sealed))[0]), 5, -1],
                       np.int32)
    jt = jcore.delete_vertices(jt, jnp.asarray(victims))
    pt = tcore.delete_vertices(pt, t(victims))
    assert_tiered_same(jt, pt)
    assert pt.run_retired == 0              # the purge drops retired lanes
    blocks = pt.num_blocks
    jt = jcore.tiered_grow(jt, num_blocks=jt.num_blocks * 2,
                           vertex_capacity=NV * 2)
    pt = tcore.tiered_grow(pt, num_blocks=pt.num_blocks * 2,
                           vertex_capacity=NV * 2)
    assert_tiered_same(jt, pt)
    assert pt.num_blocks == 2 * blocks
    jt, pt = jcore.add_vertices(jt, 3), tcore.add_vertices(pt, 3)
    assert_tiered_same(jt, pt)
    qs, qd = np.repeat(np.arange(NV, dtype=np.int32), 4), \
        np.tile(SRC[:4], NV)
    for got, ref in zip(tcore.read_edges(pt, t(qs), t(qd)),
                        jcore.read_edges(jt, jnp.asarray(qs),
                                         jnp.asarray(qd))):
        assert_exact(got, ref)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_programs_match_the_reference(tiered, impl):
    jt, pt = tiered
    assert_close(talg.pagerank(pt, max_iters=8, impl=impl),
                 jalg.pagerank(jt, max_iters=8))
    assert_exact(talg.bfs(pt, 0, impl=impl), jalg.bfs(jt, jnp.int32(0)))
    assert_exact(talg.sssp(pt, 1, impl=impl), jalg.sssp(jt, jnp.int32(1)))
    assert_exact(talg.connected_components(pt, impl=impl),
                 jalg.connected_components(jt))
    assert_exact(teng.in_degrees(pt), jeng.in_degrees(jt))
    x = np.random.default_rng(1).random((NV, 5)).astype(np.float32)
    act = np.random.default_rng(2).random(NV) < 0.5
    assert_close(teng.process_edge_push_feat(pt, t(x), t(act), impl=impl),
                 jeng.process_edge_push_feat(jt, jnp.asarray(x),
                                             jnp.asarray(act)))
    assert_close(teng.process_edge_pull(pt, t(x[:, 0]), t(act), impl=impl),
                 jeng.process_edge_pull(jt, jnp.asarray(x[:, 0]),
                                        jnp.asarray(act)))


def test_reads_degrees_and_the_sampler_match_the_reference(tiered):
    jt, pt = tiered
    rng = np.random.default_rng(3)
    qs = np.concatenate([SRC, rng.integers(-2, NV + 2, 64)]).astype(np.int32)
    qd = np.concatenate([DST, rng.integers(0, NV, 64)]).astype(np.int32)
    for got, ref in zip(tcore.read_edges(pt, t(qs), t(qd)),
                        jcore.read_edges(jt, jnp.asarray(qs),
                                         jnp.asarray(qd))):
        assert_exact(got, ref)
    active = t(rng.random(len(qs)) < 0.5)
    af, aw = tcore.read_edges(pt, t(qs), t(qd), active=active)
    f, w = tcore.read_edges(pt, t(qs), t(qd))
    assert torch.equal(af, f & active) and torch.equal(
        aw, torch.where(active, w, 0.0))
    assert_exact(pt.v_deg, jt.v_deg)
    verts = rng.integers(0, NV, 40).astype(np.int32)
    key, k = jax.random.PRNGKey(4), 5
    ref_out, ref_ok = jtier.tiered_sample_neighbors(jt, jnp.asarray(verts),
                                                    key, k)
    # one draw over the tiered degrees is the draw either tier's took
    ranks = jax.random.randint(key, (len(verts), k), 0,
                               jnp.maximum(jt.v_deg[jnp.asarray(verts)],
                                           1)[:, None])
    out, ok = ttier.tiered_rank_neighbors(pt, t(verts), t(ranks))
    assert_exact(out, ref_out)
    assert_exact(ok, ref_ok)
    sealed_rows = np.asarray(jt.sealed)[verts]
    assert ok[t(sealed_rows)].any() and ok[~t(sealed_rows)].any()
    sg = tsample(pt, t(verts[:8]), torch.Generator().manual_seed(3),
                 fanout=(4, 3))
    found, _ = tcore.read_edges(pt, sg.src, sg.dst)
    assert bool(found[sg.valid].all()) and int(sg.valid.sum()) > 8
    jsg = jsample(jt, jnp.asarray(verts[:8]), jax.random.key(3),
                  fanout=(4, 3))
    assert sg.src.shape == np.asarray(jsg.src).shape


def test_maintenance_seals_like_the_reference():
    j, p = _cbls(num_blocks=256, vertex_capacity=NV * 2)
    jt, pt = jcore.tier_from_cbl(j), tcore.tier_from_cbl(p)
    jpol = jmaint.MaintenancePolicy(seal_after_epochs=2)
    tpol = tmaint.MaintenancePolicy(seal_after_epochs=2)
    assert tuple(tmaint.decide(pt, policy=tpol)) == \
        tuple(jmaint.decide(jt, policy=jpol))
    jt = dataclasses.replace(jt, wgen=jnp.asarray(5, jnp.int32))
    pt = dataclasses.replace(pt, wgen=5)
    act = tmaint.decide(pt, policy=tpol)
    assert act.kind == "seal" and tuple(act) == \
        tuple(jmaint.decide(jt, policy=jpol))
    assert tmaint.decide(pt, policy=tpol, headroom_only=True).kind == "none"
    sealed = tmaint.apply_action(pt, act, tpol)
    assert_tiered_same(jmaint.apply_action(jt, act, jpol), sealed)
    # a move: the delta keeps its capacity (the reference's shrinks), its
    # chains left compacted and its free blocks reset
    assert sealed.num_blocks == pt.num_blocks and sealed.run_retired == 0
    _assert_compacted(sealed.delta)
    assert tmaint._ACTION_PRIORITY == jmaint._ACTION_PRIORITY
    for kind in ("compact", "rebuild"):       # delta-local repairs
        a = tmaint.MaintenanceAction(kind=kind, reason="test")
        assert_tiered_equal(jmaint.apply_action(jt, a, jpol),
                            tmaint.apply_action(pt, a, tpol))


def _assert_compacted(delta) -> None:
    """The delta a seal leaves: its chains in GTChain order from block 0,
    every free block after them with no lanes, links or keys."""
    st = delta.store
    free = st.owner == -1
    n_free = int(st.free_top)
    assert int(free.sum()) == n_free > 0 and bool(free[-n_free:].all())
    assert bool((st.count[free] == 0).all() & (st.nxt[free] == -1).all()
                & (st.keys[free] == tcore.PAD).all())
    if n_free < st.num_blocks - 1:
        assert float(tcore.gtchain_contiguity(st)) == 1.0


def _seeded_batch(rng, plain, sealed, r, nv):
    """Flush ``r``'s writes: a moving window of sources (so the rest goes
    cold and seals), deletes and re-inserts (new weight) of live edges of
    sealed sources, and fresh inserts from them."""
    s, d, _, ok = tcore.to_coo(plain.snapshot.cbl)
    s, d = s[ok].numpy(), d[ok].numpy()
    cold = np.flatnonzero(sealed.numpy())
    picks = rng.choice(cold, min(3, len(cold)), replace=False) \
        if len(cold) else np.zeros(0, np.int64)
    us, ud, op = [], [], []
    for v in picks:
        own = np.flatnonzero(s == v)
        for k, o in zip(rng.choice(own, min(2, len(own)), replace=False),
                        (-1, 1)):
            us.append(v), ud.append(d[k]), op.append(o)
        us.append(v), ud.append(rng.integers(0, nv)), op.append(1)
    hot = (np.arange(4) + 4 * r) % nv
    us += list(np.repeat(hot, 2))
    ud += list(rng.integers(0, nv, 2 * len(hot)))
    op += list(np.where(rng.random(2 * len(hot)) < 0.25, -1, 1))
    n = len(us)
    return (np.asarray(us, np.int32), np.asarray(ud, np.int32),
            rng.random(n).astype(np.float32), np.asarray(op, np.int32))


def _same_answers(tg, ref, nv):
    """``tg`` answers as ``ref`` (a CBList or a TieredGraph) does: reads of
    every pair, degrees, in-degrees, BFS / SSSP / CC bit for bit, PageRank
    and the pull / push_feat sums within rtol, on both routes (a negative
    source reads the CBList's last row, as in the reference, so the reads
    start at 0)."""
    qs = np.repeat(np.arange(nv + 2, dtype=np.int32), nv)
    qd = np.tile(np.arange(nv, dtype=np.int32), nv + 2)
    for a, b in zip(tcore.read_edges(tg, t(qs), t(qd)),
                    tcore.read_edges(ref, t(qs), t(qd))):
        assert torch.equal(a, b)
    assert torch.equal(tg.v_deg, ref.v_deg)
    assert torch.equal(teng.in_degrees(tg), teng.in_degrees(ref))
    cap = tg.capacity_vertices
    assert ref.capacity_vertices == cap
    x = torch.rand((cap, 3), generator=torch.Generator().manual_seed(nv))
    act = x[:, 0] < 0.6
    for impl in ("torch", "cuda"):
        torch.testing.assert_close(talg.pagerank(tg, impl=impl),
                                   talg.pagerank(ref, impl="torch"),
                                   rtol=1e-5, atol=1e-7)
        assert torch.equal(talg.bfs(tg, 1, impl=impl), talg.bfs(ref, 1))
        assert torch.equal(talg.sssp(tg, 2, impl=impl), talg.sssp(ref, 2))
        assert torch.equal(talg.connected_components(tg, impl=impl),
                           talg.connected_components(ref))
        for fn, xin in ((teng.process_edge_pull, x[:, 0]),
                        (teng.process_edge_push_feat, x)):
            torch.testing.assert_close(fn(tg, xin, act, impl=impl),
                                       fn(ref, xin, act, impl="torch"),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moves_hold_against_the_untiered_service_and_the_repartition(seed):
    """A tiered service (K = 2) through seeded flushes whose seals and
    unseals are moves, with deletes and re-inserts of sealed edges: at
    every epoch its edges are the untiered service's and its answers are
    theirs, and the repartition of the same graph (the reference's path)
    holds the same tiers and answers too."""
    rng = np.random.default_rng(seed)
    nv = 40
    keys = np.unique(rng.integers(0, nv * nv, 220))
    src, dst = (keys // nv).astype(np.int32), (keys % nv).astype(np.int32)
    w = rng.random(len(keys)).astype(np.float32)
    mk = dict(num_vertices=nv, block_width=4, log_capacity=512,
              device="cpu")
    # seals wait for a quarter of the vertices to go cold, so the epochs
    # between them serve a run with retired lanes
    tiered = TService.from_coo(
        src, dst, w, seal_after_epochs=2,
        policy=tmaint.MaintenancePolicy(seal_min_fraction=0.25), **mk)
    plain = TService.from_coo(src, dst, w, **mk)
    retired = 0
    for r in range(10):
        batch = _seeded_batch(rng, plain, tiered.snapshot.cbl.sealed, r, nv)
        for svc in (tiered, plain):
            svc.apply(*batch[:2], batch[2], batch[3])
            report = svc.flush()
            if svc is tiered and report.maintenance.kind == "seal":
                _assert_compacted(svc.snapshot.cbl.delta)
        tg = tiered.snapshot.cbl
        retired = max(retired, tg.run_retired)
        edges = _tier_edges(tg)
        s, d, ww, ok = tcore.to_coo(plain.snapshot.cbl)
        assert sorted(edges[0] + edges[1]) == sorted(zip(
            s[ok].tolist(), d[ok].tolist(), ww[ok].tolist()))
        assert not bool((tg.sealed & (tg.delta.v_deg > 0)).any())
        oracle = ttier._repartition(tg, tg.sealed)
        assert _tier_edges(oracle) == edges and oracle.run_retired == 0
        # exported as the JAX package keeps a run: no retired lanes
        back = interop.tiered_from_arrays(interop.tiered_to_numpy(tg),
                                          device="cpu")
        assert _tier_edges(back) == edges and back.runs.n_live == (
            tg.runs.n_live - tg.run_retired)
        _same_answers(tg, plain.snapshot.cbl, nv)
        _same_answers(oracle, plain.snapshot.cbl, nv)
    st = tiered.stats
    assert st.seals >= 2 and st.unseals >= 3 and retired > 0
    assert st.unseal_edges >= st.unseals and st.seal_edges >= st.seal_vertices
    assert st.dropped_retries == 0


def _churn_view(obs_pkg, churn, seals, n):
    bus = obs_pkg.SignalBus(obs_pkg.Registry())
    for _ in range(n):
        bus.observe("unseal_churn", churn)
        bus.observe("seal_rate", seals)
    return bus.view()


@pytest.mark.parametrize("churn,seals,n", [(30.0, 2.0, 5), (0.2, 1.0, 5),
                                           (900.0, 1.0, 3), (30.0, 2.0, 2)])
def test_adapted_seal_threshold_matches_the_reference(churn, seals, n):
    jpol = jmaint.MaintenancePolicy(seal_after_epochs=3)
    tpol = tmaint.MaintenancePolicy(seal_after_epochs=3)
    jk = jpol.adapted(_churn_view(jobs, churn, seals, n)).seal_after_epochs
    tk = tpol.adapted(_churn_view(tobs, churn, seals, n)).seal_after_epochs
    assert tk == jk
    assert (tk > 3) == (churn > 1.0 and n >= tmaint.MIN_CHURN_SAMPLES)
    assert tmaint.MaintenancePolicy().adapted(
        _churn_view(tobs, churn, seals, n)).seal_after_epochs is None


def _services(**kw):
    mk = dict(num_vertices=NV, num_blocks=96, block_width=4,
              log_capacity=256)
    mk.update(kw)
    return (JService.from_coo(jnp.asarray(SRC), jnp.asarray(DST), None, **mk),
            TService.from_coo(SRC, DST, None, device="cpu", **mk))


def _tier_counters(obs_pkg):
    rep = obs_pkg.report()
    counters = {k: v for k, v in rep["metrics"]["counters"].items()
                if k.startswith(("seal.", "tier.", "maint.", "flush."))}
    gauges = {k: v for k, v in rep["metrics"]["gauges"].items()
              if k.startswith("tier.")}
    return counters, gauges, {k for k in rep["spans"]
                              if k.startswith("tier.")}


def _lifecycle(obs_pkg, svc, batches):
    """Flush ``batches`` through ``svc`` under observability with a signal
    bus attached: (flush reports, tier versions, final storage, counters,
    gauges, tier spans)."""
    obs_pkg.reset()
    obs_pkg.enable()
    try:
        out = []
        for s, d in batches:
            svc.apply(s, d)
            out.append((svc.flush(), svc.snapshot.tier_version))
        return (out, svc.snapshot.cbl) + _tier_counters(obs_pkg)
    finally:
        obs_pkg.disable()
        obs_pkg.reset()


def test_service_lifecycle_and_counters_match_the_reference(tiered):
    """A service over the half-sealed graph (K = 1): one flush writes into
    the sealed set (unseal) and leaves the rest of the hot set unwritten
    (seal); flush report, tier version, storage, stats and the seal / tier
    counters against the reference's."""
    jt, pt = tiered
    rng = np.random.default_rng(5)
    hot_written = np.flatnonzero(~HALF)[:4]
    batch = (np.concatenate([np.flatnonzero(HALF)[3:6], hot_written])
             .astype(np.int32), rng.integers(0, NV, 7).astype(np.int32))
    kw = dict(log_capacity=256, seal_after_epochs=1)
    j = JService(jt, signals=jobs.SignalBus(jobs.registry()), **kw)
    p = TService(pt, signals=tobs.SignalBus(tobs.registry()), **kw)
    ref = _lifecycle(jobs, j, [tuple(map(jnp.asarray, batch))])
    got = _lifecycle(tobs, p, [batch])
    for (jr, jv), (pr, pv) in zip(ref[0], got[0]):
        assert pr._replace(maintenance=None) == jr._replace(maintenance=None)
        assert tuple(pr.maintenance) == tuple(jr.maintenance)
        assert pv == jv
    assert got[0][-1][0].maintenance.kind == "seal"
    assert_tiered_same(ref[1], got[1])
    assert_stats_equal(j.stats, p.stats)
    assert p.stats.seals == 1 and p.stats.unseals == 3
    moved = np.flatnonzero(HALF)[3:6]
    assert p.stats.unseal_edges == int(pt.run_degrees[t(moved)].sum()) > 0
    still = torch.zeros_like(got[1].sealed)     # sealed through the flush
    still[:NV] = pt.sealed
    still[t(moved)] = False
    fresh = got[1].sealed & ~still
    assert p.stats.seal_vertices == int(fresh.sum()) > 0
    assert p.stats.seal_edges == int(got[1].run_degrees[fresh].sum()) > 0
    assert p.snapshot.tier_version == (3, 1, 7)
    (jc, jg, jspans), (tc, tg, tspans) = ref[2:], got[2:]
    # the same counters, but the repartitions the moves replace and the
    # moved edges, which the reference does not count
    assert {k: v for k, v in tc.items() if not k.startswith(
        "seal.seal_edges") and not k.startswith("seal.unseal_edges")} == \
        {k: v for k, v in jc.items() if k != "tier.repartitions"}
    assert jc["tier.repartitions"] >= 2 and "tier.repartitions" not in tc
    assert sum(v for k, v in tc.items()
               if k.startswith("seal.unseal_edges")) == p.stats.unseal_edges
    assert sum(v for k, v in tc.items()
               if k.startswith("seal.seal_edges")) == p.stats.seal_edges
    assert tg.keys() == jg.keys()
    assert tg["tier.delta_blocks"] == got[1].num_blocks == pt.num_blocks
    assert tg["tier.sealed_fraction"] == pytest.approx(
        jg["tier.sealed_fraction"], rel=1e-6)
    assert jspans == {"tier.repartition", "tier.delta_update"}
    assert tspans == {"tier.unseal", "tier.delta_update", "tier.seal",
                      "tier.seal_extract", "tier.seal_merge"}
    qs = np.concatenate([SRC, np.arange(NV)]).astype(np.int32)
    qd = np.concatenate([DST, np.arange(NV)[::-1]]).astype(np.int32)
    for got_r, ref_r in zip(p.query_edges(qs, qd), j.query_edges(qs, qd)):
        assert_exact(got_r, ref_r)
    assert_exact(p.query_degrees(qs), j.query_degrees(qs))
    assert_close(p.analytics("pagerank"), j.analytics("pagerank"))


def _trace(n=120, seed=0):
    """Two tenants over point / degree / update / k-hop / PageRank
    requests; updates from vertices 0..7 only, so the rest seals, and a
    few into the sealed set."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dt = float(rng.exponential(1 / 2000))
        tenant = "fraud" if rng.random() < 0.5 else "dashboard"
        cls = "interactive" if tenant == "fraud" else "standard"
        m = int(rng.integers(4, 17))
        k = int(rng.choice(5, p=[0.45, 0.2, 0.25, 0.07, 0.03]))
        if k == 0:
            e = rng.integers(0, len(SRC), m)
            fields = dict(qsrc=SRC[e], qdst=DST[e])
        elif k == 1:
            fields = dict(verts=rng.integers(-2, NV + 2, m).astype(np.int32))
        elif k == 2:
            hi = NV if i > n * 0.8 else 8
            fields = dict(src=rng.integers(0, hi, m).astype(np.int32),
                          dst=rng.integers(0, NV, m).astype(np.int32),
                          op=np.where(rng.random(m) < 0.2, -1, 1)
                          .astype(np.int32),
                          w=rng.random(m).astype(np.float32))
            cls = "batch"
        elif k == 3:
            fields = dict(seeds=rng.integers(0, NV, 4).astype(np.int32),
                          seed=i)
        else:
            fields = dict(name="pagerank", kw=(("max_iters", 8),))
            tenant, cls = "dashboard", "batch"
        out.append((dt, k, fields, tenant, cls))
    return out


KINDS = ("PointRead", "DegreeRead", "UpdateBatch", "KHopSample", "Analytics")


def _replay(pkg, service, trace):
    clock = pkg.ManualClock()
    plan = pkg.choose_serve_plan(2000.0, mean_lanes_per_request=12.0,
                                 log_capacity=128)
    front = pkg.ServeFrontend(service, plan, clock=clock, fanout=(3, 2))
    front.register_tenant("fraud", read_your_writes=True)
    front.register_tenant("dashboard")
    tickets = []
    for dt, k, fields, tenant, cls in trace:
        clock.advance(dt)
        tickets.append(front.submit(getattr(pkg, KINDS[k])(
            tenant=tenant, latency_class=cls, **fields)))
        front.step()
    front.drain(flush=True)
    return front, tickets


def test_serve_frontend_replay_over_tiered_storage():
    """The same trace through a tiered and an untiered service: tiering is
    invisible to reads, so values and versions agree bit for bit (k-hop
    draws walk another neighbour order in the run, so only their shape and
    validity are held)."""
    trace = _trace()
    tiered_svc, plain_svc = (TService.from_coo(
        SRC, DST, None, num_vertices=NV, num_blocks=96, block_width=4,
        log_capacity=128, device="cpu", **kw)
        for kw in ({"seal_after_epochs": 1}, {}))
    (tf, tt), (pf, pt) = _replay(tserve, tiered_svc, trace), \
        _replay(tserve, plain_svc, trace)
    for (_, k, *_), a, b in zip(trace, pt, tt):
        assert a.done and b.done and a.version == b.version, (a, b)
        if k == 0:
            assert np.array_equal(b.value["found"], a.value["found"])
            assert np.array_equal(b.value["w"], a.value["w"])
        elif k == 1:
            assert np.array_equal(b.value["deg"], a.value["deg"])
        elif k == 2:
            assert a.value == b.value
        elif k == 3:
            assert b.value["src"].shape == a.value["src"].shape
            found, _ = tcore.read_edges(tiered_svc.snapshot.cbl,
                                        t(b.value["src"]), t(b.value["dst"]))
            assert found.shape == b.value["valid"].shape
        else:
            torch.testing.assert_close(b.value, a.value, rtol=1e-5,
                                       atol=1e-7)
    assert tf.report()["service"] == pf.report()["service"]
    assert tiered_svc.stats.seals >= 1 and tiered_svc.stats.unseals >= 1
    assert tiered_svc.snapshot.tier_version[0] >= 2


def test_pagerank_builds_one_plan_for_the_delta_only(tiered):
    _, pt = tiered
    backend.reset_launch_counts()
    ranks, iters = talg.pagerank(pt, impl="cuda", return_stats=True)
    assert backend.PLAN_BUILDS == 1 and iters > 1
    plan = teng.sweep_plan(pt.delta, pull=False)
    x = torch.rand(NV, generator=torch.Generator().manual_seed(0))
    assert torch.allclose(
        teng.process_edge_push(pt, x, impl="cuda", plan=plan),
        teng.process_edge_push(pt, x, impl="torch"), rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="another CBList store"):
        teng.process_edge_push(pt, x, impl="cuda",
                               plan=teng.sweep_plan(_cbls()[1]))
    backend.reset_launch_counts()
    talg.pagerank(pt, impl="torch")
    assert backend.PLAN_BUILDS == 0


def test_snapshot_replica_locality_and_the_unported_sharded_delta(tiered):
    jt, pt = tiered
    snap = tsnap.snapshot_of(pt)
    assert snap.tier_version == (1, 0, 0)
    copy = tsnap.device_replica(snap, "cpu")
    assert copy.tier_version == snap.tier_version
    assert_tiered_same(jt, copy.cbl)
    _assert_same_delta(copy.cbl.delta, pt.delta)
    for k in ("offsets", "indices", "weights", "row", "push_src", "push_w",
              "push_ptr"):
        assert torch.equal(getattr(copy.cbl.runs, k), getattr(pt.runs, k))
    assert copy.cbl.runs.n_live == pt.runs.n_live
    from repro.obs.locality import sweep_profile as jprofile
    # the locality profile reads the layout: the repartition's is the
    # reference's
    rep = ttier._repartition(tcore.tier_from_cbl(_cbls()[1]), t(HALF))
    ref, got = jprofile(jt), sweep_profile(rep)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k
    # the sharded delta is ported: a TieredGraph over a shard stack holds
    # one run a shard and the same edges
    from repro_torch.distributed.graph import shard_cbl
    stack = ttier.tier_from_cbl(shard_cbl(pt.delta, 2)[0])
    assert stack.is_sharded and len(stack.runs) == 2
    assert int(stack.num_edges) == int(pt.delta.num_edges)
