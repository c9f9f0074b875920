"""The tiered configuration, ``g500-s24-tiered``: at a small size on the
CPU its cell runs ``correct`` and moves vertices between the tiers with
no repartition; its four readers on a made-up trace (and None on a
program without the tier moves' ranges, as the parent's); on the card
(marker ``cuda``), a traced run of the cell at the small size reports
every per-layer metric of the cell."""
import json
import time

import pytest
import torch

import repro_torch.obs as obs
from graphbench import harness
from graphbench.harness import reader
from graphbench.tests import tiny

CELL = "g500-s24-tiered.refresh-pagerank"
TRAFFIC = "refresh-pagerank"
READERS = ("unseal_device_ms_per_batch", "seal_device_ms_per_batch",
           "run_sweep_device_ms_per_iter", "repartitions_per_batch")


def _run(trace=False, device="cpu"):
    bench = harness.load_benchmark()
    specs = harness.metric_specs(bench, CELL, trace)
    line = harness.run_cell(tiny.config("g500-s24-tiered"), tiny.mix(TRAFFIC),
                            specs, seed=tiny.SEED, seconds=30.0, trace=trace,
                            device=device, t0=time.perf_counter(),
                            rounds=tiny.ROUNDS)
    return line, specs


def test_the_configuration_is_g500_s24_with_tiers():
    cfg, plain = (json.loads((tiny.ROOT / "graphbench" / "configs"
                              / f"{name}.json").read_text())
                  for name in ("g500-s24-tiered", "g500-s24"))
    differ = {k for k in cfg if cfg[k] != plain.get(k)}
    assert differ == {"name", "source", "service", "assumed"}
    assert cfg["service"] == dict(plain["service"], seal_after_epochs=2)
    assert cfg["assumed"][:len(plain["assumed"])] == plain["assumed"]


def test_tiered_cell_is_correct():
    line, specs = _run()
    assert line["correct"] and line["failed"] == 0, line["checks"]
    assert set(line["metrics"]) == {m["name"] for m in specs}


def test_tiered_window_seals_and_unseals_by_moves():
    """The warm-up and the window seal and unseal, and no flush rebuilds
    the store (``tier.repartitions`` stays 0)."""
    obs.reset()
    obs.enable()
    try:
        driver = harness.setup(tiny.config("g500-s24-tiered"),
                               tiny.mix(TRAFFIC), tiny.SEED, "cpu",
                               harness.Spans("cpu"))
        for _ in range(tiny.ROUNDS):
            driver.round()
        counters = obs.report()["metrics"]["counters"]
    finally:
        obs.disable()
        obs.reset()
    st = driver.svc.stats
    assert st.seals >= 1 and st.unseals >= 1 and st.dropped_retries == 0
    assert st.unseal_edges >= st.unseals and st.seal_edges > 0
    assert "tier.repartitions" not in counters
    assert 0.0 < float(driver.svc.snapshot.cbl.sealed_fraction) < 1.0


def ev(cat, name, ts, dur, corr=None):
    out = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        out["args"] = {"correlation": corr}
    return out


def rng(name, ts, dur):
    return ev("user_annotation", f"repro.{name}", ts, dur)


def kernel(ts, dur, corr):
    return [ev("cuda_runtime", "cudaLaunchKernel", ts, 0.5, corr),
            ev("kernel", f"k{corr}", ts + 1, dur, corr)]


# two rounds (microseconds): an unseal in each flush, a seal in the
# second, two iterations with a run sweep each
EVENTS = ([ev("user_annotation", "graphbench.window", 0, 200),
           rng("service.flush", 0, 40), rng("tier.unseal", 2, 10),
           rng("service.flush", 100, 60), rng("tier.unseal", 102, 10),
           rng("tier.seal", 120, 30), rng("tier.seal_merge", 130, 15),
           rng("service.analytics", 50, 40), rng("program.iter", 55, 15),
           rng("tier.run_sweep", 60, 8), rng("program.iter", 72, 15),
           rng("tier.run_sweep", 75, 8)]
          + kernel(3, 4, 1) + kernel(103, 2, 2) + kernel(121, 3, 3)
          + kernel(131, 6, 4) + kernel(61, 5, 5) + kernel(76, 1, 6)
          + kernel(56, 2, 7))


@pytest.fixture
def trace_file(tmp_path, monkeypatch):
    def write(events):
        path = tmp_path / "trace.json"
        path.write_text(json.dumps({"traceEvents": events}))
        monkeypatch.setattr(harness, "TRACE_PATH", path)
        return path
    return write


def record(**kw):
    rec = dict(trace={"busy_s": 1.0, "window_s": 2.0}, rounds=2, jobs=1)
    rec.update(kw)
    return rec


@pytest.mark.parametrize("name,want", [
    ("unseal_device_ms_per_batch", 3e-3), ("seal_device_ms_per_batch", 4.5e-3),
    ("run_sweep_device_ms_per_iter", 3e-3), ("repartitions_per_batch", 0.0)])
def test_tier_reader(trace_file, name, want):
    trace_file(EVENTS)
    assert reader(name)(record()) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_tier_reader_without_the_moves(trace_file, name):
    """None for an untraced run; on a program that repartitions (the
    parent's: a ``tier.repartition`` range, none of the moves'),
    repartitions_per_batch counts its ranges and the others read None."""
    trace_file(EVENTS)
    assert reader(name)(record(trace=None)) is None
    parent = [e for e in EVENTS if not e["name"].startswith("repro.tier.")]
    trace_file(parent + [rng("tier.repartition", 5, 20)])
    got = reader(name)(record())
    if name == "repartitions_per_batch":
        assert got == pytest.approx(0.5)
    else:
        assert got is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_tiered_cell_traced_on_the_card(card):
    line, specs = _run(trace=True, device="cuda")
    assert line["correct"], line["checks"]
    assert {m["name"] for m in specs} <= set(line["metrics"])
    assert line["metrics"]["repartitions_per_batch"]["value"] == 0
    for name in READERS[:3]:
        assert line["metrics"][name]["value"] >= 0
    for m in line["metrics"].values():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105
