"""Port parity of the tuner's execution and route plans
(``repro_torch.core.tuner``: ``choose_plan``, ``choose_route_plan``,
``choose_lookahead``) against ``repro.core.tuner`` on a grid of graphs,
tasks, probes and signals.

Both packages get the JAX package's probe values, so that the decision
rules are compared and not the constants.  ``impl`` and ``run_impl`` map
the reference's ``"xla"`` (off a TPU) to the port's ``"torch"`` (on the
CPU); every other field, and the decision log's records, are equal."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro.core.tuner as jtuner  # noqa: E402
import repro.distributed.graph as jdist  # noqa: E402
import repro.graph.algorithms as jalg  # noqa: E402
import repro.obs as jobs  # noqa: E402
import repro.stream.maintenance as jmaint  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.core.tiered as ttier  # noqa: E402
import repro_torch.core.tuner as ttuner  # noqa: E402
import repro_torch.distributed.graph as tdist  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.stream import GraphService as TService  # noqa: E402
from repro_torch.stream import maintenance as tmaint  # noqa: E402

from torch_parity import t  # noqa: E402

# the reference's SystemProbe values (its TPU constants), field for field;
# the port calls VMEM's place shared memory
JAX_PROBE = jtuner.SystemProbe()
PROBES = [dict(), dict(block_fetch_overhead_us=0.05,
                       scalar_prefetch_overhead_us=0.2),
          dict(remote_message_overhead_us=40.0, hbm_bw_gbps=3350.0,
               vmem_bytes=1 << 16, max_lookahead=16)]


def _probes(kw):
    jp = dataclasses.replace(JAX_PROBE, **kw)
    tkw = {("smem_bytes" if f.name == "vmem_bytes" else f.name):
           getattr(jp, f.name) for f in dataclasses.fields(jp)}
    return jp, ttuner.SystemProbe(**tkw)


IMPL = {"xla": "torch"}


def assert_plan_equal(got, ref) -> None:
    r = dataclasses.asdict(ref)
    g = dataclasses.asdict(got)
    r["impl"], r["run_impl"] = IMPL[r["impl"]], IMPL[r["run_impl"]]
    assert g == r


def _graphs():
    """(name, jax storage, port storage): a fresh build (contiguity 1), the
    same graph after scattered inserts (chains fragment), a graph of
    single-block chains, and their shard stacks."""
    rng = np.random.default_rng(7)
    src = rng.integers(0, 60, 400).astype(np.int32)
    dst = rng.integers(0, 60, 400).astype(np.int32)
    j = jcore.build_from_coo(jnp.asarray(src), jnp.asarray(dst), None,
                             num_vertices=60, num_blocks=256, block_width=8)
    p = interop.cbl_from_arrays(j, device="cpu")
    us = rng.integers(0, 60, 200).astype(np.int32)
    ud = rng.integers(0, 60, 200).astype(np.int32)
    jf = jcore.batch_update_stats(j, jnp.asarray(us), jnp.asarray(ud))[0]
    pf = tcore.batch_update_stats(p, t(us), t(ud))[0]
    s1 = np.arange(40, dtype=np.int32)
    js = jcore.build_from_coo(jnp.asarray(s1), jnp.asarray(s1[::-1].copy()),
                              None, num_vertices=40, num_blocks=64,
                              block_width=4)
    ps = interop.cbl_from_arrays(js, device="cpu")
    out = [("fresh", j, p), ("fragmented", jf, pf), ("chunks", js, ps)]
    for S in (2, 4):
        out.append((f"fresh/{S}", jdist.shard_cbl(j, S)[0],
                    tdist.shard_cbl(p, S)[0]))
    jfs = jdist.shard_cbl(jf, 3)[0]
    tfs = tdist.shard_cbl(pf, 3)[0]
    out.append(("fragmented/3",
                jcore.batch_update_stats(jfs, jnp.asarray(ud),
                                         jnp.asarray(us))[0],
                tcore.batch_update_stats(tfs, t(ud), t(us))[0]))
    return out


@pytest.fixture(scope="module")
def graphs():
    return _graphs()


TASKS = ("scan_all", "frontier", "query", "batch_update")


@pytest.mark.parametrize("probe", range(len(PROBES)))
def test_choose_plan_matches_on_a_grid(graphs, probe):
    jp, tp = _probes(PROBES[probe])
    for name, j, p in graphs:
        for task in TASKS:
            ref = jtuner.choose_plan(j, task, jp, on_tpu=False)
            got = ttuner.choose_plan(p, task, tp)
            assert_plan_equal(got, ref)
        # a VertexProgram keys the plan on its task metadata
        assert_plan_equal(ttuner.choose_plan(p, talg.BFS, tp),
                          jtuner.choose_plan(j, jalg.BFS, jp, on_tpu=False))
    kinds = {jtuner.choose_plan(j, task, jp, on_tpu=False).strategy
             for _, j, _ in graphs for task in TASKS}
    assert len(kinds) >= 2 or probe == 0


def _contiguity_view(pkg, value, n=3):
    bus = pkg.SignalBus(pkg.Registry())
    for _ in range(n):
        bus.observe("sweep_contiguity", value)
    return bus.view()


@pytest.mark.parametrize("measured", [0.2, 0.95])
def test_measured_contiguity_replaces_the_scan(graphs, measured):
    jp, tp = _probes({})
    for name, j, p in graphs[:4]:
        for task in ("scan_all", "query"):
            ref = jtuner.choose_plan(j, task, jp, on_tpu=False,
                                     signals=_contiguity_view(jobs,
                                                              measured))
            got = ttuner.choose_plan(p, task, tp,
                                     signals=_contiguity_view(tobs, measured))
            assert_plan_equal(got, ref)
            assert got.contiguity == pytest.approx(measured)


def _churn_view(pkg, churn, seals, n=5):
    bus = pkg.SignalBus(pkg.Registry())
    for _ in range(n):
        bus.observe("unseal_churn", churn)
        bus.observe("seal_rate", seals)
        bus.observe("sweep_contiguity", 0.5)
    return bus.view()


@pytest.mark.parametrize("sharded", [False, True])
def test_tiered_plan_matches_and_adapts_the_seal_threshold(graphs, sharded):
    """The tiered branch: the delta's plan, the sealed run's route and
    share, and the seal threshold adapted to measured churn through the
    policy; decision records equal."""
    _, j, p = graphs[3 if sharded else 1]
    half = np.arange(j.capacity_vertices) % 2 == 0
    jt = jcore.seal(jcore.tier_from_cbl(j), jnp.asarray(half))
    # the repartition lays out the reference's delta (one store's seal is
    # a move, which keeps the delta's capacity, and so its plan's lanes)
    pt = ttier._repartition(tcore.tier_from_cbl(p), t(half))
    jp, tp = _probes({})
    for churn in (30.0, 0.1):
        for task in TASKS:
            decisions = []
            for pkg, tuner, g, probe, maint in (
                    (jobs, jtuner, jt, jp, jmaint),
                    (tobs, ttuner, pt, tp, tmaint)):
                pkg.reset()
                pkg.enable()
                kw = dict(on_tpu=False) if tuner is jtuner else {}
                decisions.append(tuner.choose_plan(
                    g, task, probe, signals=_churn_view(pkg, churn, 2.0),
                    policy=maint.MaintenancePolicy(seal_after_epochs=3),
                    **kw))
                decisions.append(list(pkg.registry().decisions))
                pkg.disable()
                pkg.reset()
            ref, jdec, got, tdec = decisions
            assert_plan_equal(got, ref)
            assert got.sealed_fraction > 0.0
            assert got.seal_after_epochs == (3 if churn < 1 else 24)
            assert [d["kind"] for d in tdec] == [d["kind"] for d in jdec]
            assert {"choose_plan", "choose_plan.tiered"} <= \
                {d["kind"] for d in tdec}
            for a, b in zip(tdec, jdec):
                drop = {"rule", "on_tpu", "device", "ts"}
                assert {k: v for k, v in a.items() if k not in drop} == \
                    {k: (IMPL.get(v, v) if k in ("impl", "run_impl") else v)
                     for k, v in b.items() if k not in drop}


def test_route_plan_decisions_match_on_a_grid():
    for S in (1, 2, 3, 8):
        for lanes in (0, 1, 7, 64, 1000, 4096, 1 << 20):
            for max_rec in (None, 0, 1, lanes // 2, lanes, 3 * lanes):
                for total in (None, max_rec, (max_rec or 0) * S):
                    ref = jtuner.choose_route_plan(S, lanes, max_rec, total)
                    got = ttuner.choose_route_plan(S, lanes, max_rec, total)
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(ref)
                    assert got.spilled == ref.spilled
    assert (ttuner.MIN_ROUTE_LANES, ttuner.ROUTE_SLACK) == \
        (jtuner.MIN_ROUTE_LANES, jtuner.ROUTE_SLACK)
    assert ttuner.STRATEGIES == jtuner.STRATEGIES


def test_lookahead_matches_on_a_grid():
    for kw in PROBES + [dict(block_fetch_overhead_us=5.0),
                        dict(hbm_bw_gbps=10.0)]:
        jp, tp = _probes(kw)
        for block_bytes in (8, 64, 256, 1024, 4096, 1 << 16, 1 << 22):
            assert ttuner.choose_lookahead(tp, block_bytes) == \
                jtuner.choose_lookahead(jp, block_bytes)


def test_the_card_probe_and_the_service_plan(graphs):
    """The port's own probe holds the card's numbers; ``GraphService.plan``
    reads it and reports the device route ("torch" here, on the CPU)."""
    probe = ttuner.SystemProbe()
    assert probe.hbm_bw_gbps == 3350.0 and probe.smem_bytes == 228 * 1024
    assert probe.block_fetch_overhead_us == pytest.approx(2.5 * 0.150)
    _, j, p = graphs[0]
    svc = TService(p, n_shards=2, log_capacity=64)
    plan = svc.plan("batch_update")
    assert plan.n_shards == 2 and plan.impl == "torch"
    assert plan.route_lane_cap > 0 and plan.cut_fraction > 0.0
    assert svc.plan("pagerank").partition == "gtchain"
    assert svc.plan("bfs").partition == "vertex"
    custom = TService(p, probe=dataclasses.replace(
        probe, block_fetch_overhead_us=0.0), log_capacity=64)
    assert custom.plan("scan_all").strategy == "all_hard"
