"""Each mix's loop on the port's CPU path at a small size, held to the
reference by the benchmark's own check: correct, nothing failed, every
end-to-end metric of a cell of that traffic reported."""
import pytest

from graphbench.tests import tiny

CASES = [(t, c) for t in tiny.TRAFFIC for c in tiny.CONFIGS]


@pytest.mark.parametrize("traffic,name", CASES)
def test_mix_is_correct(traffic, name):
    line = tiny.run(traffic, name)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {m["name"] for m in tiny.specs(traffic)}
    assert list(line)[-1] == "checks"
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    jobs = [j["name"] for j in tiny.mix(traffic)["jobs"]]
    want = {"edges_wrong", "live_edges_off"}
    want |= {"pagerank_l1"} if "pagerank" in jobs else set()
    want |= {"bfs_wrong"} if "bfs" in jobs else set()
    want |= {"sssp_reach_wrong", "sssp_max_rel"} if "sssp" in jobs else set()
    want |= {"wcc_wrong"} if "cc" in jobs else set()
    assert set(line["checks"]) == want
