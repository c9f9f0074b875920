"""Port parity: GraphService end to end against the JAX GraphService — the
same from_coo, apply/flush, query and analytics sequence on both.  Store
arrays, FlushReports and service stats are bit-exact; BFS/SSSP/CC are
exact and PageRank within rtol 1e-5 (summation order)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.stream.maintenance as jmaint  # noqa: E402
from repro.data import update_stream  # noqa: E402
from repro.stream import GraphService as JService  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.stream import maintenance as tmaint  # noqa: E402
from repro_torch.stream.service import GraphService as TService  # noqa: E402

from torch_parity import (BW, NV, assert_cbl_equal, assert_close,  # noqa: E402
                          assert_exact, graph, t)

import dataclasses  # noqa: E402


def _services(src, dst, w=None, jpolicy=None, **kw):
    jkw, tkw = dict(kw), dict(kw)
    if jpolicy is not None:
        jkw["policy"] = jmaint.MaintenancePolicy(**jpolicy)
        tkw["policy"] = tmaint.MaintenancePolicy(**jpolicy)
    j = JService.from_coo(src, dst, w, **jkw)
    p = TService.from_coo(src, dst, w, device="cpu", **tkw)
    return j, p


def _report_equal(jr, pr):
    assert pr._replace(maintenance=None) == jr._replace(maintenance=None)
    assert tuple(pr.maintenance) == tuple(jr.maintenance)


def _stats_equal(j, p):
    jstats = dataclasses.asdict(j.stats)
    for k, v in dataclasses.asdict(p.stats).items():
        assert v == jstats[k], k


def _analytics_equal(j, p):
    assert_close(p.analytics("pagerank"), j.analytics("pagerank"))
    for name in ("bfs", "sssp"):
        assert_exact(p.analytics(name, source=0), j.analytics(name, source=0))
    assert_exact(p.analytics("cc"), j.analytics("cc"))


def test_service_loop_matches_reference():
    src, dst, w = graph()
    j, p = _services(src, dst, w, num_vertices=NV, block_width=BW,
                     log_capacity=512)
    assert_cbl_equal(j.snapshot.cbl, p.snapshot.cbl)
    _analytics_equal(j, p)                                 # cold
    rng = np.random.default_rng(0)
    for s, d, uw, op in update_stream(NV, (src, dst), 120, 3, seed=1):
        jr = j.apply(*map(jnp.asarray, (s, d, uw, op)))
        pr = p.apply(*map(t, (s, d, uw, op)))
        assert tuple(int(x) for x in pr) == tuple(int(x) for x in jr)
        _report_equal(j.flush(), p.flush())
        assert_cbl_equal(j.snapshot.cbl, p.snapshot.cbl)
        qs = np.concatenate([s, rng.integers(-2, NV + 2, 30)]).astype(np.int32)
        qd = np.concatenate([d, rng.integers(0, NV, 30)]).astype(np.int32)
        for ref, got in zip(j.query_edges(qs, qd), p.query_edges(qs, qd)):
            assert_exact(got, ref)
        assert_exact(p.query_degrees(qs), j.query_degrees(qs))
        _analytics_equal(j, p)                             # warm
    _stats_equal(j, p)
    assert p.analytics("cc") is p.analytics("cc")          # same-epoch hit


def test_forced_grow_retry_matches_reference():
    nv = 64
    s = np.arange(32, dtype=np.int32) % 8
    d = np.arange(32, dtype=np.int32)
    policy = dict(headroom_floor=-1e9, vertex_headroom_floor=-1e9,
                  overlap_ceiling=2.0, contiguity_floor=-1.0)
    j, p = _services(s, d, jpolicy=policy, num_vertices=nv, num_blocks=16,
                     block_width=4, log_capacity=256)
    us = np.repeat(np.arange(16, 48, dtype=np.int32), 4)
    ud = np.tile(np.arange(4, dtype=np.int32), 32) + 50
    j.apply(us, ud)
    p.apply(us, ud)
    jr, pr = j.flush(), p.flush()
    assert pr.grow_retries > 0
    _report_equal(jr, pr)
    assert_cbl_equal(j.snapshot.cbl, p.snapshot.cbl)
    found, _ = p.query_edges(us, ud)
    assert bool(found.all())
    _stats_equal(j, p)


def test_maintenance_compact_and_rebuild_match():
    src, dst, w = graph(seed=2)
    for policy in (dict(overlap_ceiling=2.0, contiguity_floor=1.1,
                        vertex_headroom_floor=-1.0),
                   dict(overlap_ceiling=0.0, vertex_headroom_floor=-1.0)):
        j, p = _services(src, dst, w, jpolicy=policy, num_vertices=NV,
                         block_width=BW, log_capacity=512)
        rng = np.random.default_rng(4)
        us = rng.integers(0, NV, 150).astype(np.int32)
        ud = rng.integers(0, NV, 150).astype(np.int32)
        j.apply(us, ud)
        p.apply(us, ud)
        jr, pr = j.flush(), p.flush()
        assert pr.maintenance.kind in ("compact", "rebuild")
        _report_equal(jr, pr)
        assert_cbl_equal(j.snapshot.cbl, p.snapshot.cbl)
        assert float(tmaint.chain_overlap_fraction(p.snapshot.cbl)) == \
            float(jmaint.chain_overlap_fraction(j.snapshot.cbl))


def test_double_buffered_flush_and_pending_view():
    src, dst, w = graph(seed=5)
    j, p = _services(src, dst, w, num_vertices=NV, block_width=BW,
                     log_capacity=256)
    rng = np.random.default_rng(6)
    batches = [(rng.integers(0, NV, 40).astype(np.int32),
                rng.integers(0, NV, 40).astype(np.int32)) for _ in range(2)]
    j.apply(*batches[0])
    p.apply(*batches[0])
    j.begin_flush()
    p.begin_flush()
    assert p.flush_in_flight and p.epoch == j.epoch == 0
    j.apply(*batches[1])
    p.apply(*batches[1])
    for ref, got in zip(j.pending_view(), p.pending_view()):
        assert_exact(got, ref)
    _report_equal(j.finish_flush(), p.finish_flush())
    assert p.finish_flush() is None
    _report_equal(j.flush(), p.flush())
    assert_cbl_equal(j.snapshot.cbl, p.snapshot.cbl)
    assert p.pending_updates == 0


def test_backpressure_autoflush_matches():
    nv = 32
    src, dst, _ = graph(nv=nv, ne=100, seed=8)
    j, p = _services(src, dst, num_vertices=nv, num_blocks=128,
                     block_width=4, log_capacity=32, high_watermark=0.5)
    for k in range(4):
        us = np.random.default_rng(k).integers(0, nv, 10).astype(np.int32)
        ud = np.random.default_rng(100 + k).integers(0, nv, 10).astype(np.int32)
        j.apply(us, ud)
        p.apply(us, ud)
    assert p.stats.rejected_batches > 0
    _report_equal(j.flush(), p.flush())
    _stats_equal(j, p)
    assert_cbl_equal(j.snapshot.cbl, p.snapshot.cbl)
    with pytest.raises(ValueError, match="cannot fit"):
        p.apply(np.zeros(40, np.int32), np.arange(40, dtype=np.int32))


def test_entry_points_need_a_device_when_cuda_is_absent(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    src, dst, _ = graph()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TService.from_coo(src, dst, num_vertices=NV)
    from repro_torch.data import synthetic
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic.rmat_edges(100, 300)
    svc = TService.from_coo(src, dst, num_vertices=NV, device="cpu")
    assert svc.device.type == "cpu"
    assert interop.to_numpy(svc.snapshot.cbl.v_deg).sum() == len(src)
