"""Port parity: the six vertex programs and their incremental drivers
against ``repro.graph.algorithms``.  BFS levels, CC labels, SSSP distances,
LP labels and triangle counts are bit-exact, and so are iteration counts
outside PageRank; PageRank agrees within rtol 1e-5 (summation order) and
within one iteration."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.cblist as jcb  # noqa: E402
import repro.graph.algorithms as jalg  # noqa: E402
from repro.core import batch_update  # noqa: E402
from repro.core.program import run_program as j_run  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import program as tprog  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402

from torch_parity import BW, NB, NV, assert_close, assert_exact, graph, t  # noqa: E402

IMPLS = [("torch", "xla"), ("cuda", "pallas_interpret")]


@pytest.fixture(scope="module")
def pair():
    src, dst, w = graph()
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           num_vertices=NV, num_blocks=NB, block_width=BW)
    return j, interop.cbl_from_arrays(j, device="cpu")


@pytest.fixture(scope="module")
def updated(pair):
    """Both graphs after a batch of inserts and deletes."""
    j, _ = pair
    src, dst, _ = graph()
    rng = np.random.default_rng(3)
    us = np.concatenate([src[:40], rng.integers(0, NV, 60)]).astype(np.int32)
    ud = np.concatenate([dst[:40], rng.integers(0, NV, 60)]).astype(np.int32)
    op = np.array([-1] * 40 + [1] * 60, np.int32)
    w = rng.uniform(0.1, 1.0, 100).astype(np.float32)
    j2 = batch_update(j, *map(jnp.asarray, (us, ud, w, op)))
    return j2, interop.cbl_from_arrays(j2, device="cpu")


def _both(name, j, p, impl, jimpl, **kw):
    jout, jit = j_run(j, jalg.__dict__[name], impl=jimpl, return_stats=True,
                      **kw)
    tout, tit = tprog.run_program(p, talg.__dict__[name], impl=impl,
                                  return_stats=True, **kw)
    return jout, int(jit), tout, tit


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_pagerank(pair, impl, jimpl):
    jout, jit, tout, tit = _both("PAGERANK", *pair, impl, jimpl,
                                 max_iters=60)
    assert_close(tout, jout)
    assert abs(tit - jit) <= 1
    np.testing.assert_allclose(float(tout.sum()), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name,kw", [("BFS", {"source": 0}),
                                     ("SSSP", {"source": 3}),
                                     ("CONNECTED_COMPONENTS", {})])
def test_min_programs_are_exact(pair, name, kw):
    jout, jit, tout, tit = _both(name, *pair, "cuda", "xla", **kw)
    assert_exact(tout, jout)
    assert tit == jit


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_label_propagation(pair, impl, jimpl):
    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 4, NV).astype(np.int32)
    mask = rng.random(NV) < 0.2
    j, p = pair
    ref = jalg.label_propagation(j, jnp.asarray(seeds), jnp.asarray(mask),
                                 num_classes=4, impl=jimpl)
    got = talg.label_propagation(p, t(seeds), t(mask), num_classes=4,
                                 impl=impl)
    assert_exact(got, ref)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_triangle_count(pair, impl, jimpl):
    j, p = pair
    assert int(talg.triangle_count(p, impl=impl)) == \
        int(jalg.triangle_count(j, impl=jimpl))


def test_incremental_drivers(pair, updated):
    j, p = pair
    j2, p2 = updated
    pr = jalg.pagerank(j)
    assert_close(talg.incremental_pagerank(p2, t(pr)),
                 jalg.incremental_pagerank(j2, pr))
    lv = jalg.bfs(j, jnp.int32(0))
    assert_exact(talg.incremental_bfs(p2, 0, t(lv)),
                 jalg.incremental_bfs(j2, jnp.int32(0), lv))
    dist = jalg.sssp(j, jnp.int32(0))
    assert_exact(talg.incremental_sssp(p2, 0, t(dist)),
                 jalg.incremental_sssp(j2, jnp.int32(0), dist))
    cc = jalg.connected_components(j)
    for had_deletes in (False, True):
        assert_exact(talg.incremental_cc(p2, t(cc), had_deletes),
                     jalg.incremental_cc(j2, cc, had_deletes))


def test_program_validation_and_registry():
    assert set(tprog.registered_programs()) >= {
        "pagerank", "bfs", "sssp", "cc", "label_propagation",
        "triangle_count"}
    with pytest.raises(ValueError, match="no sweeps"):
        tprog.VertexProgram(name="x", init=lambda c: None, sweeps=())
    with pytest.raises(ValueError, match="anchor"):
        tprog.VertexProgram(name="x", init=lambda c: None,
                            sweeps=(tprog.Sweep(combine="min"),),
                            retract="unsupported_min")
    with pytest.raises(ValueError, match="already registered"):
        tprog.register_program(talg.PAGERANK)
    with pytest.raises(ValueError, match="needs source"):
        tprog.run_program(None, talg.BFS, impl="torch")
