"""A cell cut to a size the CPU tests can run: the configurations' own
shapes over 256 vertices, a log of 4,096 records and a window of a few
rounds of 64 updates, run on the port's CPU path (``impl="torch"``)."""
import json
import os
import time
from pathlib import Path

import torch

from graphbench import harness

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC = ("update", "refresh-pagerank", "refresh-graphalytics")
CONFIGS = ("lj", "g500-s24")
SEED = 2 ** 31 + 11
ROUNDS = 6

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def config(name: str = "lj") -> dict:
    cfg = json.loads((ROOT / "graphbench" / "configs" / f"{name}.json")
                     .read_text())
    cfg.update(vertices=256, edges=1000)
    cfg["service"] = dict(cfg["service"], log_capacity=4096)
    return cfg


def mix(traffic: str) -> dict:
    m = json.loads((ROOT / "graphbench" / "mixes" / f"{traffic}.json")
                   .read_text())
    # at this size a round changes 6 % of the edges, so a warm PageRank
    # call (the program's 20 iterations) reaches its fixpoint only after
    # some calls from the cold start: the warm-up gives each job 16, as the
    # full-size window's hundreds of rounds do
    m.update(batch_updates=64, source_min_degree=2,
             warmup_rounds=16 * max(1, len(m.get("jobs", []))))
    return m


def specs(traffic: str):
    bench = harness.load_benchmark()
    cell = next(c["name"] for c in bench["workloads"]
                if c["traffic"] == traffic)
    return harness.metric_specs(bench, cell, False)


def run(traffic: str, name: str = "lj", seed: int = SEED, **kw) -> dict:
    # a window of ROUNDS rounds: a fixed amount of work whatever the
    # host's speed
    return harness.run_cell(config(name), mix(traffic), specs(traffic),
                            seed=seed, seconds=30.0, trace=False,
                            device="cpu", t0=time.perf_counter(),
                            rounds=ROUNDS, **kw)
