"""Port parity: the serving frontend (``repro_torch.serve``) against
``repro.serve`` — the same 200-request two-tenant trace of all five
request kinds through both on a ``ManualClock``; the serve plan, the
request IR, batcher and admission; the read-your-writes overlay against
flush-then-read."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.serve as jserve  # noqa: E402
from repro.core import tuner as jtuner  # noqa: E402
from repro.stream import GraphService as JService  # noqa: E402
from repro_torch import serve as tserve  # noqa: E402
from repro_torch.core import tuner as ttuner  # noqa: E402
from repro_torch.serve import overlay as tov  # noqa: E402
from repro_torch.stream.service import GraphService as TService  # noqa: E402

from torch_parity import NV, RTOL, graph  # noqa: E402

N_REQUESTS, FANOUT = 200, (4, 3)


def _trace(seed: int = 0):
    """(dt, kind, fields, tenant, class): Poisson arrivals at 2,000 a
    second; point / degree / update / khop / analytics; half the point
    reads ask for pairs the trace updated earlier."""
    src, dst, _ = graph()
    rng = np.random.default_rng(seed)
    written, out = [], []
    for i in range(N_REQUESTS):
        dt = float(rng.exponential(1 / 2000))
        tenant = "fraud" if rng.random() < 0.5 else "dashboard"
        cls = "interactive" if tenant == "fraud" else "standard"
        n = int(rng.integers(4, 33))
        k = int(rng.choice(5, p=[0.45, 0.2, 0.25, 0.07, 0.03]))
        if k == 0:
            i_e = rng.integers(0, len(src), n)
            qs, qd = src[i_e].copy(), dst[i_e].copy()
            if written and rng.random() < 0.5:
                j = rng.integers(0, len(written), n)
                qs = np.array([written[x][0] for x in j], np.int32)
                qd = np.array([written[x][1] for x in j], np.int32)
            fields = dict(qsrc=qs, qdst=qd)
        elif k == 1:
            fields = dict(verts=rng.integers(-2, NV + 2, n).astype(np.int32))
        elif k == 2:
            i_e = rng.integers(0, len(src), n)
            us = np.where(rng.random(n) < 0.5, src[i_e],
                          rng.integers(0, NV, n)).astype(np.int32)
            ud = np.where(rng.random(n) < 0.5, dst[i_e],
                          rng.integers(0, NV, n)).astype(np.int32)
            op = np.where(rng.random(n) < 0.2, -1, 1).astype(np.int32)
            fields = dict(src=us, dst=ud, op=op,
                          w=rng.random(n).astype(np.float32))
            written += list(zip(us.tolist(), ud.tolist()))
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
    plan = pkg.choose_serve_plan(2000.0, mean_lanes_per_request=16.0,
                                 log_capacity=service._log.capacity)
    front = pkg.ServeFrontend(service, plan, clock=clock, fanout=FANOUT)
    front.register_tenant("fraud", read_your_writes=True)
    front.register_tenant("dashboard")
    tickets = []
    for dt, k, fields, tenant, cls in trace:
        clock.advance(dt)
        req = getattr(pkg, KINDS[k])(tenant=tenant, latency_class=cls,
                                     **fields)
        tickets.append(front.submit(req))
        front.step()
    front.drain(flush=True)
    return front, tickets


@pytest.fixture(scope="module")
def replays():
    src, dst, w = graph()
    trace = _trace()
    jsvc = JService.from_coo(jnp.asarray(src), jnp.asarray(dst),
                             jnp.asarray(w), num_vertices=NV, block_width=8,
                             log_capacity=1024)
    tsvc = TService.from_coo(src, dst, w, num_vertices=NV, block_width=8,
                             log_capacity=1024, device="cpu")
    return trace, _replay(jserve, jsvc, trace), _replay(tserve, tsvc, trace)


def _pairs(replays, kinds):
    trace, (_, jt), (_, tt) = replays
    return [(a, b) for (_, k, *_), a, b in zip(trace, jt, tt) if k in kinds]


def test_trace_reads_and_versions_match_bit_for_bit(replays):
    pairs = _pairs(replays, (0, 1, 2))
    assert len(pairs) > 150
    for a, b in pairs:
        assert a.done and b.done and not a.shed and not b.shed
        assert a.version == b.version, (a, b)
        if a.request.kind == "point_read":
            np.testing.assert_array_equal(b.value["found"],
                                          np.asarray(a.value["found"]))
            np.testing.assert_array_equal(b.value["w"],
                                          np.asarray(a.value["w"]))
        elif a.request.kind == "degree_read":
            np.testing.assert_array_equal(b.value["deg"],
                                          np.asarray(a.value["deg"]))
        else:
            assert a.value == b.value
    # the read-your-writes tenant saw its own pending writes: some point
    # read of fraud was served at a version older than one of its hits
    hits = [b for _, b in pairs if b.request.kind == "point_read"
            and b.request.tenant == "fraud" and b.value["found"].any()]
    assert hits


def test_trace_pagerank_and_khop(replays):
    for a, b in _pairs(replays, (4,)):
        assert a.version == b.version
        np.testing.assert_allclose(b.value.numpy(), np.asarray(a.value),
                                   rtol=RTOL, atol=1e-7)
    n_edges = 4 * FANOUT[0] * (1 + FANOUT[1])
    khops = _pairs(replays, (3,))
    assert khops
    for a, b in khops:
        assert a.version == b.version
        v = b.value
        assert v["src"].shape == (n_edges,) == np.asarray(a.value["src"]).shape
        n1 = 4 * FANOUT[0]
        # validity carries across hops; parked lanes sit at vertex 0
        parent = np.repeat(v["valid"][:n1], FANOUT[1])
        assert not (v["valid"][n1:] & ~parent).any()
        assert (v["dst"][v["valid"]] >= 0).all()


def test_trace_report_counts_match(replays):
    _, (jf, _), (tf, _) = replays
    jr, tr = jf.report(), tf.report()
    assert tr["kinds"] == jr["kinds"]
    assert tr["completed"] == jr["completed"] == N_REQUESTS
    assert tr["service"] == jr["service"]
    assert tr["admission"] == jr["admission"]
    assert tr["tenants"] == jr["tenants"]
    assert tr["read_plane"] == jr["read_plane"]


def test_overlay_equals_flush_then_read():
    src, dst, w = graph(seed=1)
    svcs = [TService.from_coo(src, dst, w, num_vertices=NV, block_width=8,
                              log_capacity=512, device="cpu")
            for _ in range(2)]
    rng = np.random.default_rng(2)
    i = rng.integers(0, len(src), 60)
    us = np.concatenate([src[i], rng.integers(0, NV, 60)]).astype(np.int32)
    ud = np.concatenate([dst[i], rng.integers(0, NV, 60)]).astype(np.int32)
    op = np.where(rng.random(120) < 0.4, -1, 1).astype(np.int32)
    uw = rng.random(120).astype(np.float32)
    for svc in svcs:
        svc.apply(us[:70], ud[:70], uw[:70], op[:70])
    svcs[0].begin_flush()            # a shadow flush in flight, then more
    for svc in svcs:
        svc.apply(us[70:], ud[70:], uw[70:], op[70:])
    qs = torch.as_tensor(np.concatenate([us, rng.integers(0, NV, 40)])
                         .astype(np.int32))
    qd = torch.as_tensor(np.concatenate([ud, rng.integers(0, NV, 40)])
                         .astype(np.int32))
    verts = torch.as_tensor(np.concatenate([us, [-1, NV, 0]]).astype(np.int32))
    pend = svcs[0].pending_view()
    found, wt = tov.overlay_point_reads(svcs[0].snapshot, pend, qs, qd)
    deg = tov.overlay_degrees(svcs[0].snapshot, pend, verts)
    svcs[1].flush()
    ref_found, ref_w = svcs[1].query_edges(qs, qd)
    assert torch.equal(found, ref_found) and torch.equal(wt, ref_w)
    assert torch.equal(deg, svcs[1].query_degrees(verts))
    assert bool(found.any()) and not bool(found.all())


def _signals(pkg_obs, n, qps, lanes):
    bus = pkg_obs.SignalBus(pkg_obs.Registry())
    for _ in range(n):
        bus.observe("arrival_qps", qps)
        bus.observe("read_lanes_per_s", lanes)
    return bus.view()


def test_choose_serve_plan_matches_the_reference():
    import repro.obs as jobs

    import repro_torch.obs as tobs
    probe_lanes = 2.0e6
    for qps in (1.0, 50.0, 2000.0, 1e5):
        for lanes in (1.0, 16.0):
            for cap, hw in ((64, 0.75), (4096, 0.75), (1 << 21, 0.5)):
                for budget in (None, 300.0):
                    kw = dict(mean_lanes_per_request=lanes, log_capacity=cap,
                              high_watermark=hw, n_replicas=2,
                              tenant_budget_qps=budget)
                    ref = jtuner.choose_serve_plan(qps, **kw)
                    got = ttuner.choose_serve_plan(qps, **kw)
                    assert got.__dict__ == ref.__dict__
    for n in (2, 3):
        kw = dict(max_replicas=4, log_capacity=4096)
        ref = jtuner.choose_serve_plan(
            10.0, probe=jtuner.SystemProbe(
                replica_read_lanes_per_s=probe_lanes),
            signals=_signals(jobs, n, 900.0, 3.5e6), **kw)
        got = ttuner.choose_serve_plan(
            10.0, probe=ttuner.SystemProbe(
                replica_read_lanes_per_s=probe_lanes),
            signals=_signals(tobs, n, 900.0, 3.5e6), **kw)
        assert got.__dict__ == ref.__dict__
        assert got.n_replicas == (3 if n == 3 else 1)


def test_batcher_and_admission_match_the_reference():
    rng = np.random.default_rng(4)
    windows = {"interactive": 0.002, "standard": 0.01, "batch": 0.05}
    queues = [pkg.KindQueue("point_read", (16, 32, 64), windows)
              for pkg in (jserve, tserve)]
    ctl = [pkg.AdmissionController(default_rate=400.0, default_burst=64)
           for pkg in (jserve, tserve)]
    now = 0.0
    for i in range(60):
        now += float(rng.exponential(0.001))
        n = int(rng.integers(1, 50))
        cls = ("interactive", "standard", "batch")[i % 3]
        out = []
        for pkg, q, c in zip((jserve, tserve), queues, ctl):
            req = pkg.PointRead(qsrc=np.zeros(n), qdst=np.zeros(n),
                                tenant=f"t{i % 2}", latency_class=cls)
            verdict = c.admit(req.tenant, cls, n, now)
            if verdict == "admit":
                q.put(pkg.Ticket(req, now))
            taken = []
            while q.due(now):
                mb = q.take()
                taken.append((mb.spans, mb.lanes, mb.bucket))
            out.append((verdict, taken, q.pending_lanes, q.next_deadline()))
        assert out[0] == out[1]
    assert jserve.bucket_for(33, (16, 32, 64)) == \
        tserve.bucket_for(33, (16, 32, 64)) == 64
