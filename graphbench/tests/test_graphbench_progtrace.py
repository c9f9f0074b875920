"""The program-range reader on a made-up Chrome trace: device time goes to
the ranges open at its launch (matched by correlation), inclusive and self
totals of nested ranges, idle time to the innermost range, synchronisations
counted, the feed left out, and the readers built on it; on the card
(marker ``cuda``), a traced run of a small cell reports every new metric
of its cell."""
import json
import time

import pytest
import torch

from graphbench import harness, progtrace
from graphbench.harness import reader
from graphbench.tests import tiny

NEW = ("flush_host_syncs_per_batch", "flush_device_idle_pct",
       "upsert_device_ms_per_batch", "maint_device_ms_per_batch",
       "plan_build_device_ms_per_job", "sweep_device_ms_per_iter")


def ev(cat, name, ts, dur, corr=None):
    out = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        out["args"] = {"correlation": corr}
    return out


def rng(name, ts, dur):
    return ev("user_annotation", f"repro.{name}", ts, dur)


def launch(ts, corr, name="cudaLaunchKernel"):
    return ev("cuda_runtime", name, ts, 0.5, corr)


# microseconds.  Busy: 10-30, 40-50, 75-80; idle: 0-10, 30-40, 50-75, 80-100
EVENTS = [
    ev("user_annotation", "graphbench.window", 0, 100),
    rng("service.flush", 0, 60),
    rng("flush.coalesce", 5, 15),
    rng("updates.locate", 8, 4),
    rng("flush.upsert", 25, 25),
    rng("updates.inserts", 30, 15),
    launch(9, 1), ev("kernel", "locate", 10, 20, 1),   # runs past its range
    launch(26, 2), ev("kernel", "sort", 40, 4, 2),
    launch(31, 3), ev("kernel", "scatter", 44, 6, 3),
    launch(15, 4, "cudaStreamSynchronize"),
    launch(46, 5, "cudaStreamSynchronize"),
    launch(70, 6), ev("gpu_memset", "Memset", 75, 5, 6),
    ev("cpu_op", "aten::nonzero", 14, 2),
    {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3},
]


def test_device_time_by_launch():
    """A kernel counts toward the ranges open at its launch, inclusive up
    the nesting and self in the innermost, even when it runs after they
    closed."""
    r = progtrace.summarize(EVENTS)["ranges"]
    assert r["updates.locate"]["device_self_ms"] == pytest.approx(20e-3)
    assert r["flush.coalesce"]["device_ms"] == pytest.approx(20e-3)
    assert r["flush.coalesce"]["device_self_ms"] == 0
    assert r["flush.upsert"]["device_ms"] == pytest.approx(10e-3)
    assert r["flush.upsert"]["device_self_ms"] == pytest.approx(4e-3)
    assert r["updates.inserts"]["device_ms"] == pytest.approx(6e-3)
    assert r["service.flush"]["device_ms"] == pytest.approx(30e-3)
    assert r["service.flush"]["device_self_ms"] == 0
    assert r[progtrace.NONE]["device_self_ms"] == pytest.approx(5e-3)
    assert sum(x["device_self_ms"] for x in r.values()) == pytest.approx(
        progtrace.summarize(EVENTS)["device_ms"])


def test_inclusive_and_self_totals():
    r = progtrace.summarize(EVENTS)["ranges"]
    assert r["service.flush"]["count"] == 1
    assert r["service.flush"]["host_ms"] == pytest.approx(60e-3)
    assert r["flush.upsert"]["host_ms"] == pytest.approx(25e-3)
    # a name nested in its own name counts once toward inclusive totals
    twice = progtrace.summarize(EVENTS + [rng("service.flush", 1, 2)])
    row = twice["ranges"]["service.flush"]
    assert row["count"] == 2
    assert row["host_ms"] == pytest.approx(60e-3)
    assert row["device_ms"] == pytest.approx(30e-3)


def test_idle_to_the_innermost_range():
    s = progtrace.summarize(EVENTS)
    r = s["ranges"]
    want_self = {"service.flush": 15, "flush.coalesce": 3,
                 "updates.locate": 2, "updates.inserts": 10,
                 "flush.upsert": 0, progtrace.NONE: 35}
    for name, us in want_self.items():
        assert r[name]["idle_self_ms"] == pytest.approx(us * 1e-3), name
    want = {"service.flush": 30, "flush.coalesce": 5, "updates.locate": 2,
            "flush.upsert": 10, "updates.inserts": 10}
    for name, us in want.items():
        assert r[name]["idle_ms"] == pytest.approx(us * 1e-3), name
    assert s["idle_ms"] == pytest.approx(65e-3)
    assert sum(x["idle_self_ms"] for x in r.values()) == pytest.approx(
        s["idle_ms"])
    assert s["window_ms"] == pytest.approx(0.1)


def test_syncs_counted_where_issued():
    r = progtrace.summarize(EVENTS)["ranges"]
    assert r["service.flush"]["syncs"] == 2
    assert r["service.flush"]["syncs_self"] == 0
    assert r["flush.coalesce"]["syncs_self"] == 1
    assert r["flush.upsert"]["syncs_self"] == 1
    assert r["updates.inserts"]["syncs"] == 0
    assert r["updates.locate"]["syncs"] == 0


def test_the_feed_counts_nowhere():
    """What the feed launches counts toward no range, and its time is not
    idle."""
    fed = EVENTS + [ev("user_annotation", "graphbench.feed", 85, 10),
                    launch(86, 7, "cudaMemcpyAsync"),
                    ev("gpu_memcpy", "Memcpy HtoD", 87, 6, 7),
                    launch(90, 8, "cudaDeviceSynchronize")]
    got, want = progtrace.summarize(fed), progtrace.summarize(EVENTS)
    assert got["device_ms"] == pytest.approx(want["device_ms"])
    assert got["idle_ms"] == pytest.approx(want["idle_ms"] - 10e-3)
    for name in want["ranges"]:
        if name != progtrace.NONE:
            assert got["ranges"][name] == want["ranges"][name]


def test_trace_without_a_window_or_the_card_is_refused():
    with pytest.raises(RuntimeError):
        progtrace.summarize([e for e in EVENTS
                             if e["name"] != "graphbench.window"])
    with pytest.raises(RuntimeError):
        progtrace.summarize([e for e in EVENTS
                             if e["cat"] not in ("kernel", "gpu_memset")])


ANALYTICS = [
    rng("service.analytics", 60, 40),
    rng("program.setup", 61, 8),
    rng("engine.sweep_plan", 62, 6),
    launch(63, 11), ev("kernel", "sort", 63, 3, 11),
    rng("program.iter", 71, 9),
    launch(72, 12), ev("kernel", "gather", 72, 6, 12),
    rng("program.iter", 81, 9),
    launch(82, 13), ev("kernel", "sum", 82, 2, 13),
]


def record(**kw):
    rec = dict(trace={"busy_s": 1.0, "window_s": 2.0}, rounds=2, jobs=1)
    rec.update(kw)
    return rec


@pytest.fixture
def trace_file(tmp_path, monkeypatch):
    def write(events):
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        monkeypatch.setattr(harness, "TRACE_PATH", path)
        return path
    return write


@pytest.mark.parametrize("name,want", [
    ("flush_host_syncs_per_batch", 1.0), ("flush_device_idle_pct", 50.0),
    ("upsert_device_ms_per_batch", 5e-3), ("maint_device_ms_per_batch", 0.0),
    ("plan_build_device_ms_per_job", 3e-3),
    ("sweep_device_ms_per_iter", 4e-3)])
def test_reader(trace_file, name, want):
    trace_file(EVENTS + ANALYTICS)
    assert reader(name)(record()) == pytest.approx(want, rel=1e-9)


def test_reader_reparses_a_rewritten_trace(trace_file):
    trace_file(EVENTS + ANALYTICS)
    read = reader("maint_device_ms_per_batch")
    assert read(record()) == 0.0
    trace_file(EVENTS + ANALYTICS + [rng("maint.apply", 52, 6),
                                     launch(53, 14),
                                     ev("kernel", "compact", 53, 8, 14)])
    assert read(record()) == pytest.approx(4e-3)


@pytest.mark.parametrize("name", NEW)
def test_reader_none_without_a_trace(trace_file, name):
    """None for an untraced run and for the trace of a program without
    ranges (the parent's)."""
    trace_file(EVENTS + ANALYTICS)
    assert reader(name)(record(trace=None)) is None
    trace_file([e for e in EVENTS + ANALYTICS
                if not e["name"].startswith("repro.")])
    assert reader(name)(record()) is None


def test_table_prints_every_range(trace_file, capsys):
    path = trace_file(EVENTS + ANALYTICS)
    assert progtrace.main([str(path)]) == 0
    out = capsys.readouterr().out
    for name in ("service.flush", "updates.locate", "program.iter"):
        assert name in out
    assert progtrace.main([]) == 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", tiny.TRAFFIC)
def test_new_metrics_in_a_traced_run_on_the_card(card, traffic):
    bench = harness.load_benchmark()
    cell = next(c["name"] for c in bench["workloads"]
                if c["traffic"] == traffic)
    line = harness.run_cell(tiny.config(), tiny.mix(traffic),
                            harness.metric_specs(bench, cell, True),
                            seed=tiny.SEED, seconds=30.0, trace=True,
                            device="cuda", t0=time.perf_counter(),
                            rounds=tiny.ROUNDS)
    want = {m["name"] for m in bench["per_layer"]
            if m["name"] in NEW and cell in m["workloads"]}
    assert want and want <= set(line["metrics"])
    for name in want:
        assert line["metrics"][name]["value"] >= 0
