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
                          assert_exact, assert_stats_equal, graph, t)


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
    assert_stats_equal(j.stats, p.stats)


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


# ---------------------------------------------------------------------------
# the lanes sweep plan kept across epochs (the kernel route's plain versions
# on CPU tensors)
# ---------------------------------------------------------------------------

from repro_torch import backend  # noqa: E402
from repro_torch.core.program import get_program, run_program  # noqa: E402
from repro_torch.stream import service as tservice  # noqa: E402


@pytest.fixture
def kernel_route(monkeypatch):
    """The service's analytics on the kernel route: on CPU tensors its
    kernels run their plain versions."""
    monkeypatch.setattr(tservice, "choose_engine_impl",
                        lambda cbl, prog: "cuda")
    backend.reset_launch_counts()


def _kept_service(seed=0, **policy):
    src, dst, w = graph(seed)
    policy = {"vertex_headroom_floor": -1.0, **policy}
    return TService.from_coo(src, dst, w, num_vertices=NV, block_width=BW,
                             log_capacity=512, device="cpu",
                             policy=tmaint.MaintenancePolicy(**policy)), src, dst


def _per_flush(src, flushes):
    """A batch size whose ``flushes`` flushes hold records well inside the
    kept plan's share (``PLAN_LANES_PER_HELD_RECORD``)."""
    return len(src) // (tservice.PLAN_LANES_PER_HELD_RECORD * (flushes + 1))


def _counted(fn):
    """``fn()`` and the plan builds and patches it made."""
    b0, p0 = backend.PLAN_BUILDS, backend.PLAN_PATCHES
    out = fn()
    return out, backend.PLAN_BUILDS - b0, backend.PLAN_PATCHES - p0


def test_kept_plan_pagerank_equals_a_fresh_plan(kernel_route):
    """N refreshes make 1 build and N - 1 patches, and each PageRank is bit
    for bit ``run_program``'s with a plan built for its epoch."""
    svc, src, dst = _kept_service()
    prog = get_program("pagerank")
    prev, builds, patches = None, 0, 0
    N = 4
    for s, d, uw, op in update_stream(NV, (src, dst), _per_flush(src, 1), N,
                                      seed=1):
        svc.apply(s, d, uw, op)
        svc.flush()
        got, b, p = _counted(lambda: svc.analytics("pagerank"))
        builds, patches = builds + b, patches + p
        want = run_program(svc.snapshot.cbl, prog, warm=prev, impl="cuda")
        assert torch.equal(got, want)
        prev = got
    assert (builds, patches) == (1, N - 1)


def test_graphalytics_rotation_keeps_the_plan(kernel_route):
    """BFS, SSSP and WCC between two PageRanks neither use nor drop the
    plan: the second PageRank patches it with four flushes' records."""
    svc, src, dst = _kept_service(seed=2)
    rotation = [("pagerank", {}), ("bfs", {"source": 0}),
                ("sssp", {"source": 0}), ("cc", {})]
    stream = update_stream(NV, (src, dst), _per_flush(src, 4), 8, seed=3)
    for j, (s, d, uw, op) in enumerate(stream):
        svc.apply(s, d, uw, op)
        svc.flush()
        name, kw = rotation[j % 4]
        out = svc.analytics(name, **kw)
        if name == "pagerank":
            prev = out
    assert (backend.PLAN_BUILDS, backend.PLAN_PATCHES) == (1, 1)
    # three flushes since the last PageRank's epoch: patched again
    got = svc.analytics("pagerank")
    assert (backend.PLAN_BUILDS, backend.PLAN_PATCHES) == (1, 2)
    assert torch.equal(got, run_program(svc.snapshot.cbl,
                                        get_program("pagerank"), warm=prev,
                                        impl="cuda"))


def test_vertex_capacity_change_drops_the_plan(kernel_route):
    """A flush that grows the vertex capacity drops the kept plan; the next
    PageRank builds, the one after patches."""
    src, dst, w = graph(4)
    svc = TService.from_coo(src, dst, w, num_vertices=NV, block_width=BW,
                            log_capacity=512, device="cpu")
    _, b, p = _counted(lambda: svc.analytics("pagerank"))
    assert (b, p) == (1, 0)
    batches = update_stream(NV, (src, dst), 80, 2, seed=5)
    counts = []
    for s, d, uw, op in batches:
        svc.apply(s, d, uw, op)
        svc.flush()
        _, b, p = _counted(lambda: svc.analytics("pagerank"))
        counts.append((b, p))
    assert svc.snapshot.cbl.capacity_vertices > NV
    assert counts == [(1, 0), (0, 1)]


def test_held_records_past_their_share_drop_the_plan(kernel_route):
    """Flushes whose records since the kept plan's epoch pass one for every
    ``PLAN_LANES_PER_HELD_RECORD`` of its lanes drop it: the next PageRank
    builds, and keeps the new plan."""
    svc, src, dst = _kept_service(seed=12)
    _, b, p = _counted(lambda: svc.analytics("pagerank"))
    assert (b, p) == (1, 0)
    lanes = svc._held.src.numel()
    n = _per_flush(src, 2)
    share = lanes // tservice.PLAN_LANES_PER_HELD_RECORD
    counts, held = [], []
    for s, d, uw, op in update_stream(NV, (src, dst), n, share // n + 2,
                                      seed=13):
        svc.apply(s, d, uw, op)
        svc.flush()
        held.append((svc._held is not None, svc._held_count))
    assert held[0] == (True, n)
    assert all(h == (c * n <= share) for c, (h, _) in
               enumerate(held, start=1))
    assert held[-1] == (False, 0)
    _, b, p = _counted(lambda: svc.analytics("pagerank"))
    assert (b, p) == (1, 0) and svc._held is not None


def test_a_plan_with_parallel_edges_is_not_kept(kernel_route):
    src, dst, w = graph(6)
    src, dst, w = (np.concatenate([x, x[:5]]) for x in (src, dst, w))
    svc = TService.from_coo(src, dst, w, num_vertices=NV, block_width=BW,
                            log_capacity=512, device="cpu")
    for s, d, uw, op in update_stream(NV, (src, dst), 40, 2, seed=7):
        svc.apply(s, d, uw, op)
        svc.flush()
        _, b, p = _counted(lambda: svc.analytics("pagerank"))
        assert (b, p) == (1, 0)


def test_plan_kept_only_on_the_kernel_route():
    svc, src, dst = _kept_service(seed=8)
    backend.reset_launch_counts()
    for s, d, uw, op in update_stream(NV, (src, dst), 40, 2, seed=9):
        svc.apply(s, d, uw, op)
        svc.flush()
        svc.analytics("pagerank")
    assert (backend.PLAN_BUILDS, backend.PLAN_PATCHES) == (0, 0)


def test_kept_plan_across_a_shadow_flush(kernel_route):
    """A PageRank between ``begin_flush`` and ``finish_flush`` runs on the
    published epoch: a plan kept before the flush began patches without the
    in-flight records and takes them at publish; a plan first built while
    the flush is in flight cannot, and is dropped at publish."""
    svc, src, dst = _kept_service(seed=10)
    prog = get_program("pagerank")
    batches = list(update_stream(NV, (src, dst), _per_flush(src, 2), 3,
                                 seed=11))
    svc.apply(*batches[0])
    svc.begin_flush()
    _, b, p = _counted(lambda: svc.analytics("pagerank"))    # epoch 0
    assert (b, p) == (1, 0)
    svc.finish_flush()                 # began with no plan kept: dropped
    prev, b, p = _counted(lambda: svc.analytics("pagerank"))
    assert (b, p) == (1, 0)
    svc.apply(*batches[1])
    svc.begin_flush()
    svc.apply(*batches[2])
    assert svc.analytics("pagerank") is prev                # epoch 1, cached
    svc.finish_flush()
    svc.flush()
    got, b, p = _counted(lambda: svc.analytics("pagerank"))
    assert (b, p) == (0, 1)
    assert torch.equal(got, run_program(svc.snapshot.cbl, prog, warm=prev,
                                        impl="cuda"))
