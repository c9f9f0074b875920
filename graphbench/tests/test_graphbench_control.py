"""The check's control at a small size: the reference put in the
program's place one step down -- held in bfloat16, or one round behind the
last flush -- comes out not correct under the limits."""
import pytest

from graphbench import judge
from graphbench.tests import tiny


@pytest.mark.parametrize("traffic", tiny.TRAFFIC)
def test_control_fails(traffic):
    line = tiny.run(traffic, controls=True)
    assert line["correct"]
    for kind in ("bf16", "behind"):
        nums = line["control"][kind]
        assert not judge.passed(judge.verdict(nums)), (kind, nums)
    program = {k: c["value"] for k, c in line["checks"].items()}
    for name in ("pagerank_l1", "sssp_max_rel"):
        if name in program:
            assert program[name] < judge.LIMITS[name] \
                < line["control"]["bf16"][name]
