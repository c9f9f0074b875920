"""The ``plan_patches_per_job`` reader on made-up traces: the count of the
program's ``repro.engine.plan_patch`` ranges over the window's jobs, none
for a program that makes no such range (one that builds every plan) or an
untraced run; on the card (marker ``cuda``), a traced run of a small
refresh cell reports it."""
import time

import pytest
import torch

from graphbench import harness
from graphbench.harness import reader
from graphbench.tests import tiny
from graphbench.tests.test_graphbench_progtrace import (  # noqa: F401
    ANALYTICS, EVENTS, ev, launch, record, rng, trace_file)

# a second job whose plan is patched: its own launch inside the patch
PATCHED = [
    rng("service.analytics", 86, 10),
    rng("engine.sweep_plan", 87, 4),
    rng("engine.plan_patch", 87.5, 3),
    launch(88, 21), ev("kernel", "merge", 88, 2, 21),
]


def test_patches_over_jobs(trace_file):
    trace_file(EVENTS + ANALYTICS + PATCHED)
    assert reader("plan_patches_per_job")(record(jobs=2)) == 0.5
    # the patch's device time is the plan's
    assert reader("plan_build_device_ms_per_job")(record(jobs=2)) == \
        pytest.approx((3e-3 + 2e-3) / 2, rel=1e-9)


def test_none_without_a_patch_range(trace_file):
    """A program that builds every plan (the parent's) and an untraced run
    give nothing."""
    trace_file(EVENTS + ANALYTICS)
    assert reader("plan_patches_per_job")(record()) is None
    trace_file(EVENTS + ANALYTICS + PATCHED)
    assert reader("plan_patches_per_job")(record(trace=None)) is None


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", ["refresh-pagerank",
                                     "refresh-graphalytics"])
def test_patches_in_a_traced_run_on_the_card(card, traffic):
    bench = harness.load_benchmark()
    cell = next(c["name"] for c in bench["workloads"]
                if c["traffic"] == traffic)
    cfg, mix = tiny.config(), tiny.mix(traffic)
    # the flushes between two PageRanks (four in the graphalytics rotation)
    # hold their records within the kept plan's share of its lanes, as the
    # full-size cells' do; the tiny mix's 6 % a round would drop the plan
    from repro_torch.stream import service
    mix["batch_updates"] = min(mix["batch_updates"], cfg["edges"] // (
        service.PLAN_LANES_PER_HELD_RECORD * (len(mix["jobs"]) + 1)))
    line = harness.run_cell(cfg, mix,
                            harness.metric_specs(bench, cell, True),
                            seed=tiny.SEED, seconds=30.0, trace=True,
                            device="cuda", t0=time.perf_counter(),
                            rounds=tiny.ROUNDS)
    assert line["correct"]
    assert line["metrics"]["plan_patches_per_job"]["value"] > 0
    assert line["metrics"]["plan_builds_per_job"]["value"] == 0
