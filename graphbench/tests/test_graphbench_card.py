"""On the card (marker ``cuda``; skips without one): a traced run of a
small cell gives a device trace with work in it and correct outputs.
Run there with ``python -m pytest graphbench -m cuda``."""
import time

import pytest
import torch

from graphbench import harness
from graphbench.tests import tiny


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("traffic", tiny.TRAFFIC)
def test_traced_run_on_the_card(card, traffic):
    bench = harness.load_benchmark()
    cell = next(c["name"] for c in bench["workloads"]
                if c["traffic"] == traffic)
    line = harness.run_cell(tiny.config(), tiny.mix(traffic),
                            harness.metric_specs(bench, cell, True),
                            seed=tiny.SEED, seconds=30.0, trace=True,
                            device="cuda", t0=time.perf_counter(),
                            rounds=tiny.ROUNDS)
    assert line["correct"], line["checks"]
    dev = line["device"]
    assert dev["platform"] == "gpu" and dev["count"] == 1
    assert 0 < dev["busy_s"] <= dev["window_s"]
    assert line["breakdown"]["device_ops"]
    for m in line["metrics"].values():
        if m["unit"] == "%":
            assert 0 <= m["value"] <= 105
