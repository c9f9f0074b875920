"""The metric readers and the profiler reader on made-up records and
traces: ``sweep_roofline``'s bytes come from the live edge and vertex
counts alone, the trace summary's busy, idle and per-span seconds add
up, and the device reader refuses to run without a card."""
import pytest

from graphbench import devtrace, peaks
from graphbench.harness import reader

LJ = (68993773, 4847571)
G500 = (2 ** 28, 2 ** 24)


@pytest.mark.parametrize("edges,vertices", [(10, 5), LJ, G500])
def test_sweep_bytes_from_counts_only(edges, vertices):
    assert peaks.sweep_bytes(edges, vertices) == 8 * edges + 8 * vertices
    assert peaks.sweep_seconds(edges, vertices) == pytest.approx(
        (8 * edges + 8 * vertices) / 3.35e12, rel=1e-15)


def record(**kw):
    rec = dict(job_names=["pagerank", "bfs", "pagerank"],
               iterations=[20, 7, 20], live_edges=LJ[0], vertices=LJ[1],
               trace={"device_s_in": {"job.pagerank": 0.5, "job.bfs": 9.0},
                      "busy_s": 6.0, "window_s": 8.0},
               rounds=3, updates=600, window_s=2.0, jobs=3,
               update_s=[0.1, 0.2, 0.3], refresh_s=[0.2, 0.4, 0.6],
               spans={"flush": [0.01, 0.03], "job.pagerank": [0.2, 0.2],
                      "job.bfs": [0.1]},
               counters={"chain_walk_locate": 6, "plan_builds": 2},
               setup_s=12.5)
    rec.update(kw)
    return rec


def test_sweep_roofline():
    read = reader("sweep_roofline")
    want = 100 * 40 * peaks.sweep_seconds(*LJ) / 0.5
    assert read(record()) == pytest.approx(want, rel=1e-12)
    # padding, spans, other jobs' device time and other counts do not enter
    other = record(plan_padding=10 ** 9, spans={}, counters={},
                   trace={"device_s_in": {"job.pagerank": 0.5,
                                          "job.bfs": 1.0},
                          "busy_s": 1.0, "window_s": 2.0})
    assert read(other) == pytest.approx(want, rel=1e-12)
    assert read(record(live_edges=2 * LJ[0])) > read(record())
    assert read(record(job_names=["bfs"], iterations=[3])) is None
    assert read(record(trace=None)) is None


def test_min_sweep_device_ms_per_iter():
    read = reader("min_sweep_device_ms_per_iter")
    assert read(record()) == pytest.approx(1e3 * 9.0 / 7, rel=1e-12)
    assert read(record(job_names=["pagerank"], iterations=[20])) is None
    assert read(record(trace=None)) is None


@pytest.mark.parametrize("name,want", [
    ("setup_s", 12.5), ("update_rate", 300.0), ("refresh_rate", 1.5),
    ("update_p95_ms", 290.0), ("refresh_p95_ms", 580.0), ("flush_ms", 20.0),
    ("locate_launches_per_batch", 2.0), ("iters_per_job", 47 / 3),
    ("plan_builds_per_job", 2 / 3), ("job_ms_per_iter", 500 / 47),
    ("device_idle_pct.update", 25.0), ("device_idle_pct.refresh", 25.0)])
def test_reader(name, want):
    assert reader(name)(record()) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", ["update_rate", "refresh_rate",
                                  "update_p95_ms", "refresh_p95_ms",
                                  "iters_per_job", "plan_builds_per_job",
                                  "job_ms_per_iter"])
def test_reader_finds_nothing(name):
    empty = record(rounds=0, jobs=0, update_s=[], refresh_s=[],
                   iterations=[], job_names=[], spans={})
    assert reader(name)(empty) is None


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


EVENTS = [ev("user_annotation", "graphbench.window", 0, 100),
          ev("user_annotation", "graphbench.flush", 0, 40),
          ev("user_annotation", "graphbench.job.pagerank", 50, 50),
          ev("kernel", "k1", 10, 10), ev("kernel", "k1", 15, 10),
          ev("kernel", "k2", 60, 20), ev("gpu_memcpy", "Memcpy", 85, 5),
          ev("cpu_op", "aten::nonzero", 30, 15),
          {"ph": "i", "cat": "kernel", "name": "marker", "ts": 3}]


def test_trace_summary():
    s = devtrace.summarize(EVENTS)
    assert s["busy_s"] == pytest.approx(40e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["device_s_in"]["flush"] == pytest.approx(20e-6)
    assert s["device_s_in"]["job.pagerank"] == pytest.approx(25e-6)
    assert [n for n, _ in s["device_ops"]][:2] == ["k1", "k2"]
    gaps = dict(s["idle_gaps"])
    assert gaps["flush/python"] == pytest.approx(10e-6)
    assert gaps["between/aten::nonzero"] == pytest.approx(35e-6)
    assert gaps["job.pagerank/python"] == pytest.approx(15e-6)
    assert sum(gaps.values()) + s["busy_s"] == pytest.approx(s["window_s"])


def test_the_feed_counts_nowhere():
    """The feed between rounds (a ``graphbench.feed`` range) is the
    harness's: what it launches adds to no busy time, span or operation,
    and its time is taken out of the window and its idle gaps."""
    fed = EVENTS + [
        ev("user_annotation", "graphbench.feed", 42, 6),
        dict(ev("cuda_runtime", "cudaMemcpyAsync", 43, 1),
             args={"correlation": 99}),
        dict(ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 44, 3),
             args={"correlation": 99})]
    got, want = devtrace.summarize(fed), devtrace.summarize(EVENTS)
    assert got["window_s"] == pytest.approx(want["window_s"] - 6e-6)
    for key in ("busy_s", "device_s_in", "device_ops"):
        assert got[key] == want[key]
    gaps = dict(got["idle_gaps"])
    assert sum(gaps.values()) + got["busy_s"] == pytest.approx(
        got["window_s"])
    assert sum(gaps.values()) == pytest.approx(
        sum(dict(want["idle_gaps"]).values()) - 6e-6)


def test_trace_without_device_events_is_refused():
    with pytest.raises(RuntimeError):
        devtrace.summarize([e for e in EVENTS if e["cat"] != "kernel"
                            and e["cat"] != "gpu_memcpy"])


def test_device_reader_needs_a_card(monkeypatch, tmp_path):
    monkeypatch.setattr(devtrace.torch.cuda, "is_available", lambda: False)
    path = tmp_path / "t.json"
    path.write_text('{"traceEvents": []}')
    with pytest.raises(RuntimeError):
        devtrace.read(path)
    with pytest.raises(RuntimeError):
        devtrace.profile()
