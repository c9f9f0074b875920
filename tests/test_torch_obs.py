"""Port parity: ``repro_torch.obs`` (metrics, trace, signals, SLOs,
locality) against ``repro.obs`` for the same call sequences, and the
service's flush counters under observability in both packages."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.obs as jobs  # noqa: E402
import repro_torch.obs as tobs  # noqa: E402
from repro.core import batch_update  # noqa: E402
import repro.core.cblist as jcb  # noqa: E402
from repro.stream import GraphService as JService  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.stream.service import GraphService as TService  # noqa: E402

from torch_parity import BW, NB, NV, graph  # noqa: E402

PKGS = (jobs, tobs)


def _drive_registry(obs_pkg):
    reg = obs_pkg.Registry()
    reg.counter("c", k="a").inc()
    reg.counter("c", k="a").inc(2.5)
    reg.counter("c", k="b").inc()
    reg.gauge("g").set(7)
    h = reg.histogram("h", obs_pkg.log_buckets(1e-3, 1.0, 4), phase="x")
    for v in (0.0005, 0.002, 0.2, 3.0):
        h.observe(v)
    s = reg.series("s", maxlen=300, tenant="t")
    for v in np.linspace(0.0, 1.0, 250):
        s.observe(float(v))
    reg.decision("plan", rule="r", n=3)
    first = reg.snapshot()
    reg.counter("c", k="a").inc(4)
    return (first, reg.snapshot(), obs_pkg.delta(reg.snapshot(), first),
            s.summary(pcts=(50, 90, 99)), list(reg.decisions),
            obs_pkg.guarded_percentiles([1.0, 2.0, 3.0], (50, 99)),
            [obs_pkg.count_bucket(n) for n in (0, 1, 7, 100, 10 ** 6)],
            obs_pkg.percentile_min_n(99))


def test_metrics_match_the_reference():
    assert _drive_registry(tobs) == _drive_registry(jobs)


def _drive_tracer(trace_mod):
    ticks = iter(np.arange(0.0, 100.0, 0.25).tolist())
    tr = trace_mod.Tracer(clock=lambda: next(ticks), capacity=5)
    with tr.span("outer", cat="flush", epoch=1) as rec:
        with tr.span("inner"):
            tr.instant("mark", cat="decision", why="x")
    tr.attribute("slice", ts=10.0, dur=0.5, cat="flush", shard=0)
    for i in range(4):                       # past capacity: dropped
        with tr.span("loop", i=i):
            pass
    chrome = tr.to_chrome()
    meta = [e for e in chrome["traceEvents"] if e["ph"] == "M"]
    for e in meta:
        e["args"].pop("name", None) if e["name"] == "process_name" else None
    return rec["dur"], tr.aggregate(), tr.dropped, chrome


def test_trace_matches_the_reference():
    import repro.obs.trace as jtrace
    import repro_torch.obs.trace as ttrace
    assert _drive_tracer(ttrace) == _drive_tracer(jtrace)


def test_trace_wait_syncs_under_a_device_span():
    tr = tobs.Tracer()
    x = (torch.ones(3), {"a": [torch.zeros(2)]})
    assert tr.wait(x, "sync", kind="k") is x
    (ev,) = tr.events
    assert ev["cat"] == "device" and ev["name"] == "sync"
    assert ev["args"] == {"kind": "k"}


def _drive_signals(obs_pkg):
    reg = obs_pkg.Registry()
    bus = obs_pkg.SignalBus(reg, clock=lambda: 0.0, window=8)
    t = 0.0
    for step in range(12):
        reg.counter("serve.submitted", tenant="a", cls="x").inc(3 + step)
        reg.counter("serve.read_lanes", kind="point_read").inc(40 * step)
        t += 0.0005 if step % 3 == 0 else 0.01
        bus.tick_dispatch(t, n_replicas=2)
        reg.counter("flush.count").inc()
        reg.gauge("locality.contiguity").set(0.5 + step / 100)
        bus.tick_flush()
    bus.observe("shard_skew", 1.25)
    return bus.report(), bus.view().get("read_pressure"), "x" in bus.view()


def test_signals_match_the_reference():
    assert _drive_signals(tobs) == _drive_signals(jobs)


def _drive_slo(obs_pkg):
    slo = obs_pkg.SloTracker(clock=lambda: 0.0, shed_burn_ratio=1.0)
    slo.set_objective("fraud", "interactive", 0.005, 0.9, window=64)
    slo.set_objective("dash", "batch", 0.5)
    events = []
    rng = np.random.default_rng(0)
    for i in range(120):
        lat = float(rng.exponential(0.004 if i < 60 else 0.02))
        events.append(slo.observe("fraud", "interactive", latency_s=lat))
        events.append(slo.observe("dash", "batch", shed=i % 7 == 0))
        events.append(slo.should_shed_batch())
    return (events, slo.summary(), slo.burn_rate("fraud", "interactive"),
            [o.__dict__ for o in slo.objectives()])


def test_slo_matches_the_reference():
    assert _drive_slo(tobs) == _drive_slo(jobs)


def test_locality_profile_matches_the_reference():
    from repro.obs.locality import sweep_profile as jprofile
    from repro_torch.obs.locality import sweep_profile as tprofile
    src, dst, w = graph()
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           num_vertices=NV, num_blocks=NB, block_width=BW)
    rng = np.random.default_rng(7)
    for _ in range(2):
        us = rng.integers(0, NV, 64).astype(np.int32)
        ud = rng.integers(0, NV, 64).astype(np.int32)
        j = batch_update(j, jnp.asarray(us), jnp.asarray(ud))
    ref, got = jprofile(j), tprofile(interop.cbl_from_arrays(j, device="cpu"))
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k] == pytest.approx(ref[k], rel=1e-6), k


def _flush_counters(obs_pkg, service_cls, **kw):
    src, dst, w = graph(seed=2)
    svc = service_cls.from_coo(src, dst, w, num_vertices=NV, block_width=8,
                               log_capacity=256, **kw)
    obs_pkg.reset()
    obs_pkg.enable()
    try:
        rng = np.random.default_rng(3)
        for r in range(3):
            n = 150
            i = rng.integers(0, len(src), n)
            us = np.where(rng.random(n) < 0.5, src[i],
                          rng.integers(0, NV, n)).astype(np.int32)
            ud = np.where(rng.random(n) < 0.5, dst[i],
                          rng.integers(0, NV, n)).astype(np.int32)
            op = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int32)
            svc.apply(us, ud, None, op)
            svc.flush()
        svc.analytics("pagerank", max_iters=3)
        rep = obs_pkg.report()
    finally:
        obs_pkg.disable()
        obs_pkg.reset()
    counters = {k: v for k, v in rep["metrics"]["counters"].items()
                if k.startswith(("flush.", "log.", "maint.", "locality."))}
    return counters, set(rep["spans"]), rep["metrics"]["gauges"]


def test_service_flush_counters_match_the_reference():
    ref_counters, ref_spans, ref_gauges = _flush_counters(jobs, JService)
    got_counters, got_spans, got_gauges = _flush_counters(tobs, TService,
                                                          device="cpu")
    assert got_counters == ref_counters
    assert got_counters["flush.count"] == 3 and \
        got_counters["locality.sweeps{task=scan_all}"] == 1
    assert {"service.flush", "flush.admission", "flush.coalesce",
            "flush.upsert", "flush.maintenance", "maint.decide",
            "service.apply"} <= got_spans
    assert got_spans - PORT_SPANS <= ref_spans
    assert got_gauges["service.epoch"] == ref_gauges["service.epoch"]
    for k in ("locality.chain_hops_mean", "locality.blocks_per_edge",
              "locality.contiguity"):
        assert got_gauges[k] == pytest.approx(ref_gauges[k], rel=1e-6)


def test_observability_is_off_by_default():
    assert not tobs.enabled()
    assert tobs.counter("x") is tobs.metrics.NULL
    assert tobs.span("x") is tobs.NULL_SPAN
    assert tobs.record_sweep(None) is None


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def test_trace_spans_enter_profiler_annotations():
    """While a profiler records, a tracer's span and an ``obs.span`` with
    obs off are both ``repro.<name>`` ranges; with no profiler an
    ``obs.span`` with obs off is the shared no-op."""
    assert not tobs.enabled()
    tr = tobs.Tracer()
    with _cpu_profile() as prof:
        with tr.span("flush.upsert", cat="flush"):
            torch.ones(4).sum()
        with tobs.span("flush.coalesce", cat="flush") as rec:
            torch.ones(4).sum()
    keys = {e.key for e in prof.key_averages()}
    assert {"repro.flush.upsert", "repro.flush.coalesce"} <= keys
    assert rec is tobs.NULL_SPAN
    assert [e["name"] for e in tr.events] == ["flush.upsert"]
    assert tobs.span("flush.coalesce") is tobs.NULL_SPAN


# the port's spans the JAX package does not have: the flush's dropped
# read and publish, the upsert's parts and the analytics path
PORT_SPANS = {"flush.dropped_read", "flush.publish", "updates.locate",
              "updates.deletes", "updates.inserts", "service.analytics",
              "program.setup", "program.iter", "program.retract",
              "engine.sweep_plan"}


def _service_round(svc):
    """One apply + flush (inserts and deletes of present edges) and one
    PageRank on ``svc``."""
    src, dst, _ = graph(seed=2)
    rng = np.random.default_rng(5)
    i = rng.integers(0, len(src), 60)
    us = np.concatenate([src[i], rng.integers(0, NV, 60)]).astype(np.int32)
    ud = np.concatenate([dst[i], rng.integers(0, NV, 60)]).astype(np.int32)
    op = np.repeat(np.array([-1, 1], np.int32), 60)
    svc.apply(us, ud, None, op)
    svc.flush()
    svc.analytics("pagerank", max_iters=4)


def _service(**kw):
    src, dst, w = graph(seed=2)
    return TService.from_coo(src, dst, w, num_vertices=NV, block_width=8,
                             log_capacity=256, device="cpu", **kw)


def _within(ranges, outer, inner):
    """Some ``inner`` range lies inside some ``outer`` range."""
    return any(o0 <= i0 and i1 <= o1
               for on, o0, o1 in ranges if on == outer
               for n, i0, i1 in ranges if n == inner)


def test_service_ranges_under_a_cpu_profiler():
    """A CPU profiler over one round of the service sees the flush's and
    the analytics' ranges, nested where the work happens."""
    from repro_torch.core.tuner import choose_engine_impl
    svc = _service()
    with _cpu_profile() as prof:
        _service_round(svc)
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events() if e.name.startswith("repro.")]
    names = [n for n, _, _ in ranges]
    assert _within(ranges, "repro.service.flush", "repro.flush.coalesce")
    assert _within(ranges, "repro.flush.coalesce", "repro.updates.locate")
    assert _within(ranges, "repro.flush.upsert", "repro.updates.inserts")
    assert _within(ranges, "repro.updates.deletes", "repro.updates.locate")
    for name in ("flush.admission", "maint.decide", "flush.dropped_read",
                 "flush.maintenance", "flush.publish"):
        assert _within(ranges, "repro.service.flush", f"repro.{name}"), name
    assert _within(ranges, "repro.service.analytics", "repro.program.iter")
    planned = choose_engine_impl(svc.snapshot.cbl) == "cuda"
    assert ("repro.engine.sweep_plan" in names) == planned
    assert names.count("repro.program.iter") == svc.last_iterations
    assert not tobs.tracer().events           # obs stayed off


def test_no_record_function_without_a_switch(monkeypatch):
    """With obs off and no profiler recording, no span enters a
    ``record_function``."""
    calls = []
    real = torch.profiler.record_function

    def counting(*a, **kw):
        calls.append(a)
        return real(*a, **kw)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    svc = _service()
    _service_round(svc)
    assert calls == []
    with _cpu_profile():
        _service_round(svc)
    assert calls                              # the same patch counts
