"""Port parity: the three ProcessEdge sweeps, degrees and ProcessVertex
against the JAX engine.  ``impl="torch"`` is held against ``impl="xla"``
and ``impl="cuda"`` (the kernels' plain versions on the CPU) against
``impl="pallas_interpret"``: real-valued sums within rtol 1e-5 (summation
order), min/max and integer-valued sums bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.cblist as jcb  # noqa: E402
import repro.core.engine as jeng  # noqa: E402
from repro.core import batch_update  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402

from torch_parity import (BW, NB, NV, assert_close, assert_exact, graph,  # noqa: E402
                          t)

IMPLS = [("torch", "xla"), ("cuda", "pallas_interpret")]


@pytest.fixture(scope="module", params=["built", "fragmented"])
def pair(request):
    src, dst, w = graph()
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           num_vertices=NV, num_blocks=NB, block_width=BW)
    if request.param == "fragmented":
        rng = np.random.default_rng(1)
        for _ in range(3):
            us = rng.integers(0, NV, 64).astype(np.int32)
            ud = rng.integers(0, NV, 64).astype(np.int32)
            j = batch_update(j, jnp.asarray(us), jnp.asarray(ud),
                             jnp.asarray(rng.random(64).astype(np.float32)))
    return j, interop.cbl_from_arrays(j, device="cpu")


def _x(seed, shape=(NV,)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_push_sum(pair, impl, jimpl):
    j, p = pair
    x = _x(0)
    assert_close(teng.process_edge_push(p, t(x), impl=impl),
                 jeng.process_edge_push(j, jnp.asarray(x), impl=jimpl))


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_pull_sum(pair, impl, jimpl):
    j, p = pair
    x = _x(1)
    assert_close(teng.process_edge_pull(p, t(x), impl=impl),
                 jeng.process_edge_pull(j, jnp.asarray(x), impl=jimpl))


@pytest.mark.parametrize("impl,jimpl", IMPLS)
def test_push_feat(pair, impl, jimpl):
    j, p = pair
    x = _x(2, (NV, 5))
    for weighted in (True, False):
        assert_close(
            teng.process_edge_push_feat(p, t(x), weighted=weighted, impl=impl),
            jeng.process_edge_push_feat(j, jnp.asarray(x), weighted=weighted,
                                        impl=jimpl))


def test_unit_weight_push_is_bit_exact(pair):
    j, p = pair
    x = np.ones(NV, np.float32)
    msg = lambda xs, w: xs          # noqa: E731 — integer-valued sums
    assert_exact(teng.process_edge_push(p, t(x), dense_f=msg, impl="cuda"),
                 jeng.process_edge_push(j, jnp.asarray(x), dense_f=msg,
                                        impl="xla"))


@pytest.mark.parametrize("combine", ["min", "max"])
def test_min_max_combines_are_exact(pair, combine):
    j, p = pair
    x = _x(3)
    active = np.random.default_rng(4).random(NV) < 0.5
    for impl in ("torch", "cuda"):
        assert_exact(
            teng.process_edge_push(p, t(x), t(active), combine=combine,
                                   impl=impl),
            jeng.process_edge_push(j, jnp.asarray(x), jnp.asarray(active),
                                   combine=combine, impl="xla"))
        assert_exact(
            teng.process_edge_pull(p, t(x), t(active), combine=combine,
                                   impl=impl),
            jeng.process_edge_pull(j, jnp.asarray(x), jnp.asarray(active),
                                   combine=combine, impl="xla"))


def test_active_masks_on_sum_sweeps(pair):
    j, p = pair
    x = _x(5)
    active = np.random.default_rng(6).random(NV) < 0.4
    assert_close(teng.process_edge_push(p, t(x), t(active), impl="cuda"),
                 jeng.process_edge_push(j, jnp.asarray(x), jnp.asarray(active)))
    assert_close(teng.process_edge_pull(p, t(x), t(active), impl="cuda"),
                 jeng.process_edge_pull(j, jnp.asarray(x), jnp.asarray(active)))
    xf = _x(7, (NV, 3))
    assert_close(
        teng.process_edge_push_feat(p, t(xf), t(active), impl="cuda"),
        jeng.process_edge_push_feat(j, jnp.asarray(xf), jnp.asarray(active)))


def test_degrees_and_process_vertex(pair):
    j, p = pair
    assert_exact(teng.in_degrees(p), jeng.in_degrees(j))
    assert_exact(teng.out_degrees(p), jeng.out_degrees(j))
    x = _x(8)
    active = np.arange(NV) % 2 == 0
    assert_exact(teng.process_vertex(p, lambda v: v * 2.0, t(x), t(active)),
                 jeng.process_vertex(j, lambda v: v * 2.0, jnp.asarray(x),
                                     jnp.asarray(active)))


def test_semirings_cover_the_reference():
    assert set(teng.SEMIRINGS) == set(jeng.SEMIRINGS)
    for name, sr in teng.SEMIRINGS.items():
        assert sr.fill == jeng.SEMIRINGS[name].fill
