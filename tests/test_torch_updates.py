"""Port parity: batched updates, point reads and the update log against the
JAX package (stores, UpdateStats and log arrays bit-exact)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.cblist as jcb  # noqa: E402
import repro.core.updates as jup  # noqa: E402
import repro.stream.log as jlog  # noqa: E402
from repro.data import update_stream  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import cblist as tcb  # noqa: E402
from repro_torch.core import updates as tup  # noqa: E402
from repro_torch.stream import log as tlog  # noqa: E402

from torch_parity import (BW, NB, NV, assert_cbl_equal, assert_exact,  # noqa: E402
                          graph, t)


def _build(num_blocks=NB, seed=0):
    src, dst, w = graph(seed=seed)
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           num_vertices=NV, num_blocks=num_blocks,
                           block_width=BW)
    p = tcb.build_from_coo(t(src), t(dst), t(w), num_vertices=NV,
                           num_blocks=num_blocks, block_width=BW)
    return (src, dst), j, p


def _stats(s):
    return tuple(int(x) for x in s)


def test_batch_update_stats_over_an_update_stream():
    coo, j, p = _build()
    for s, d, w, op in update_stream(NV, coo, 160, 3, seed=1):
        j, js = jup.batch_update_stats(j, *map(jnp.asarray, (s, d, w, op)))
        p, ps = tup.batch_update_stats(p, *map(t, (s, d, w, op)))
        assert _stats(ps) == _stats(js)
        assert_cbl_equal(j, p)


def test_overflow_counts_dropped_edges_identically():
    coo, _, _ = _build()
    nb = jcb.blocks_needed(coo[0], NV, BW) + 4
    _, j, p = _build(num_blocks=nb)
    rng = np.random.default_rng(11)
    us = rng.integers(0, NV, 300).astype(np.int32)
    ud = rng.integers(0, NV, 300).astype(np.int32)
    j, js = jup.batch_update_stats(j, jnp.asarray(us), jnp.asarray(ud))
    p, ps = tup.batch_update_stats(p, t(us), t(ud))
    assert _stats(ps) == _stats(js) and _stats(js)[0] > 0
    assert_cbl_equal(j, p)


def test_update_does_not_write_into_its_input():
    _, _, p = _build()
    before = interop.cbl_to_numpy(p)
    rng = np.random.default_rng(2)
    us = t(rng.integers(0, NV, 64).astype(np.int32))
    ud = t(rng.integers(0, NV, 64).astype(np.int32))
    op = t(np.where(rng.random(64) < 0.5, 1, -1).astype(np.int32))
    tup.batch_update_stats(p, us, ud, None, op)
    tup.delete_vertices(p, t(np.array([1, 2, -1], np.int32)))
    after = interop.cbl_to_numpy(p)
    for k in before["store"]:
        np.testing.assert_array_equal(after["store"][k], before["store"][k])
    for k in ("v_deg", "v_level", "v_head", "v_tail"):
        np.testing.assert_array_equal(after[k], before[k])


def test_read_edges():
    (src, dst), j, p = _build()
    rng = np.random.default_rng(3)
    qs = np.concatenate([src[:50], rng.integers(0, NV, 50)]).astype(np.int32)
    qd = np.concatenate([dst[:50], rng.integers(0, NV, 50)]).astype(np.int32)
    jf, jw = jup.read_edges(j, jnp.asarray(qs), jnp.asarray(qd))
    pf, pw = tup.read_edges(p, t(qs), t(qd))
    assert_exact(pf, jf)
    assert_exact(pw, jw)
    assert bool(pf[:50].all())


def test_upsert_delete_and_add_vertices():
    (src, dst), j, p = _build()
    rng = np.random.default_rng(4)
    us = np.concatenate([src[:20], rng.integers(0, NV, 20)]).astype(np.int32)
    ud = np.concatenate([dst[:20], rng.integers(0, NV, 20)]).astype(np.int32)
    uw = rng.random(40).astype(np.float32)
    j = jup.upsert_edges(j, jnp.asarray(us), jnp.asarray(ud), jnp.asarray(uw))
    p = tup.upsert_edges(p, t(us), t(ud), t(uw))
    assert_cbl_equal(j, p)
    vids = np.array([0, 7, -1, 42], np.int32)
    j = jup.delete_vertices(j, jnp.asarray(vids))
    p = tup.delete_vertices(p, t(vids))
    assert_cbl_equal(j, p)
    assert_cbl_equal(jup.add_vertices(j, 3), tup.add_vertices(p, 3))


def _log_equal(jl, pl):
    got = interop.log_to_numpy(pl)
    for k in jlog.UpdateLog._fields:
        np.testing.assert_array_equal(got[k], np.asarray(getattr(jl, k)),
                                      err_msg=k)


def test_update_log_append_drain_peek_merge():
    rng = np.random.default_rng(5)
    jl, pl = jlog.make_log(64), tlog.make_log(64, device="cpu")
    for n in (20, 30, 40):          # the third batch trips the watermark
        s = rng.integers(0, 6, n).astype(np.int32)
        d = rng.integers(0, 6, n).astype(np.int32)
        w = rng.random(n).astype(np.float32)
        op = np.where(rng.random(n) < 0.3, -1, 1).astype(np.int32)
        jl, jr = jlog.append(jl, *map(jnp.asarray, (s, d, w, op)),
                             high_watermark=0.75)
        pl, pr = tlog.append(pl, *map(t, (s, d, w, op)), high_watermark=0.75)
        assert _stats(pr) == _stats(jr)
        _log_equal(jl, pl)
    for ref, got in zip(jlog.peek(jl), tlog.peek(pl)):
        assert_exact(got, ref)
    jl2, jrec = jlog.drain(jl)
    pl2, prec = tlog.drain(pl)
    _log_equal(jl2, pl2)
    for ref, got in zip(jrec, prec):
        assert_exact(got, ref)
    s = rng.integers(0, 6, 10).astype(np.int32)
    jl3, _ = jlog.append(jl2, jnp.asarray(s), jnp.asarray(s[::-1].copy()))
    pl3, _ = tlog.append(pl2, t(s), t(s[::-1].copy()))
    _log_equal(jl3, pl3)
    for ref, got in zip(jlog.merge_views(*jrec, jl3),
                        tlog.merge_views(*prec, pl3)):
        assert_exact(got, ref)


def test_batch_update_empty_degrees_and_chain_bounds():
    coo, j, p = _build()
    rng = np.random.default_rng(12)
    us = rng.integers(0, NV, 80).astype(np.int32)
    ud = rng.integers(0, NV, 80).astype(np.int32)
    op = np.where(rng.random(80) < 0.3, -1, 1).astype(np.int32)
    j = jup.batch_update(j, *map(jnp.asarray, (us, ud)), None,
                         jnp.asarray(op))
    p = tup.batch_update(p, t(us), t(ud), None, t(op))
    assert_cbl_equal(j, p)
    assert_exact(tcb.degrees(p), jcb.degrees(j))
    assert int(p.num_edges) == int(j.num_edges)
    assert p.max_chain == j.max_chain == NB
    je = jcb.empty(NV, 64, block_width=BW, vertex_capacity=NV + 8)
    pe = tcb.empty(NV, 64, block_width=BW, vertex_capacity=NV + 8,
                   device="cpu")
    assert_cbl_equal(je, pe)
    assert int(pe.n_vertices) == NV and int(pe.num_edges) == 0
