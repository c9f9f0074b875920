"""Port parity: block store, CBList layout, traversal and the device data
generators against the JAX package (bit-exact integer layouts)."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.blockstore as jbs  # noqa: E402
import repro.core.cblist as jcb  # noqa: E402
import repro.core.traversal as jtr  # noqa: E402
from repro.core import batch_update  # noqa: E402
from repro.data import rmat_edges as np_rmat  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import blockstore as tbs  # noqa: E402
from repro_torch.core import cblist as tcb  # noqa: E402
from repro_torch.core import traversal as ttr  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402

from torch_parity import (BW, NB, NV, assert_cbl_equal, assert_exact,  # noqa: E402
                          graph, t)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


@pytest.fixture(scope="module")
def pair():
    src, dst, w = graph()
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           num_vertices=NV, num_blocks=NB, block_width=BW)
    p = tcb.build_from_coo(t(src), t(dst), t(w), num_vertices=NV,
                           num_blocks=NB, block_width=BW)
    return j, p


@pytest.fixture(scope="module")
def fragmented(pair):
    """Both builds after three insert batches (chains no longer contiguous)."""
    j, _ = pair
    rng = np.random.default_rng(7)
    for _ in range(3):
        us = rng.integers(0, NV, 64).astype(np.int32)
        ud = rng.integers(0, NV, 64).astype(np.int32)
        j = batch_update(j, jnp.asarray(us), jnp.asarray(ud),
                         jnp.ones((64,), jnp.float32))
    return j, interop.cbl_from_arrays(j, device="cpu")


def test_build_from_coo_bit_exact(pair):
    assert_cbl_equal(*pair)


def test_build_with_invalid_entries_and_vertex_capacity():
    src, dst, w = graph(seed=3)
    valid = np.random.default_rng(3).random(len(src)) < 0.7
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), None,
                           num_vertices=NV, num_blocks=NB, block_width=BW,
                           vertex_capacity=256, valid=jnp.asarray(valid))
    p = tcb.build_from_coo(t(src), t(dst), None, num_vertices=NV,
                           num_blocks=NB, block_width=BW,
                           vertex_capacity=256, valid=t(valid))
    assert_cbl_equal(j, p)


def test_make_store():
    j = jbs.make_store(16, 4)
    p = tbs.make_store(16, 4, device="cpu")
    for k in jbs.BlockStore._fields:
        assert_exact(getattr(p, k), getattr(j, k))


def test_to_coo_and_rebuild(fragmented):
    j, p = fragmented
    for ref, got in zip(jcb.to_coo(j), tcb.to_coo(p)):
        assert_exact(got, ref)
    for ref, got in zip(jcb.to_coo(j, max_edges=3000),
                        tcb.to_coo(p, max_edges=3000)):
        assert_exact(got, ref)
    with pytest.raises(ValueError, match="exceed max_edges"):
        tcb.to_coo(p, max_edges=10)
    assert_cbl_equal(jcb.rebuild(j, max_edges=NB * BW),
                     tcb.rebuild(p, max_edges=NB * BW))


def test_compact_and_contiguity(fragmented):
    j, p = fragmented
    assert float(tbs.gtchain_contiguity(p.store)) == \
        float(jbs.gtchain_contiguity(j.store))
    assert_exact(tbs.gtchain_order(p.store), jbs.gtchain_order(j.store))
    assert_cbl_equal(jcb.compact_cbl(j), tcb.compact_cbl(p))
    assert float(tbs.gtchain_contiguity(tcb.compact_cbl(p).store)) == 1.0


def test_grow_blocks_and_vertices(fragmented):
    j, p = fragmented
    assert_cbl_equal(jcb.grow(j, num_blocks=NB * 2, vertex_capacity=300),
                     tcb.grow(p, num_blocks=NB * 2, vertex_capacity=300))
    with pytest.raises(ValueError):
        tbs.grow_store(p.store, NB - 1)


def test_alloc_and_free_blocks(fragmented):
    j, p = fragmented
    js, jids = jbs.alloc_blocks(j.store, 16, jnp.int32(5))
    ps, pids = tbs.alloc_blocks(p.store, 16, torch.tensor(5))
    assert_exact(pids, jids)
    assert int(ps.free_top) == int(js.free_top)
    ids = np.array([3, -1, 7, 11, -1], np.int32)
    jf = jbs.free_blocks(j.store, jnp.asarray(ids))
    pf = tbs.free_blocks(p.store, t(ids))
    for k in jbs.BlockStore._fields:
        assert_exact(getattr(pf, k), getattr(jf, k))


def test_block_fences_and_blocks_needed(fragmented):
    j, p = fragmented
    for ref, got in zip(jcb.block_fences(j.store), tcb.block_fences(p.store)):
        assert_exact(got, ref)
    src, _, _ = graph()
    assert tcb.blocks_needed(t(src), NV, BW) == jcb.blocks_needed(src, NV, BW)


def test_traversal(fragmented):
    j, p = fragmented
    assert_exact(ttr.lane_mask(p.store), jtr.lane_mask(j.store))
    assert_exact(ttr.scan_vertices(p), jtr.scan_vertices(j))
    hub = int(np.argmax(np.asarray(j.v_deg)))
    for v in (hub, 5, 199):
        for ref, got in zip(jtr.scan_edges(j, v, 64), ttr.scan_edges(p, v, 64)):
            assert_exact(got, ref)
        rv, pv = jtr.read_vertex(j, v), ttr.read_vertex(p, v)
        assert {k: int(x) for k, x in pv.items()} == \
            {k: int(x) for k, x in rv.items()}


def test_interop_round_trip(pair):
    j, p = pair
    back = interop.cbl_from_arrays(interop.cbl_to_numpy(p), device="cpu")
    assert_cbl_equal(j, back)
    import repro.stream.log as jlog
    jl, _ = jlog.append(jlog.make_log(8), jnp.arange(3, dtype=jnp.int32),
                        jnp.arange(3, dtype=jnp.int32))
    pl = interop.log_from_arrays(jl, device="cpu")
    for k, v in interop.log_to_numpy(pl).items():
        ref = np.asarray(getattr(jl, k))
        assert v.dtype == ref.dtype
        np.testing.assert_array_equal(v, ref)
    out = interop.from_numpy(np.arange(4, dtype=np.int32), device="cpu")
    assert interop.to_numpy(out).tolist() == [0, 1, 2, 3]


def test_rmat_matches_numpy_given_the_same_draws():
    nv, ne, seed = 300, 2000, 4
    rng = np.random.default_rng(seed)
    n_gen = int(ne * 1.3)
    draws = {}

    def draw(level):
        draws[level] = torch.as_tensor(rng.random(n_gen))
        return draws[level]

    src, dst = synthetic.rmat_from_uniforms(draw, nv, ne)
    ref_src, ref_dst = np_rmat(nv, ne, seed=seed)
    assert_exact(src, ref_src)
    assert_exact(dst, ref_dst)


def test_rmat_on_device_is_deduped_and_in_range():
    src, dst = synthetic.rmat_edges(1000, 5000, seed=1, device="cpu")
    assert src.dtype == torch.int32 and src.shape == (5000,)
    keys = src.long() * 1000 + dst.long()
    assert torch.unique(keys).numel() == 5000
    assert int(src.min()) >= 0 and int(dst.max()) < 1000
    assert torch.equal(keys, torch.sort(keys)[0])   # keep-smallest-keys order


def test_update_stream_semantics():
    nv = 500
    src, dst = synthetic.rmat_edges(nv, 3000, seed=2, device="cpu")
    live = set(zip(src.tolist(), dst.tolist()))
    for s, d, w, op in synthetic.update_stream(nv, (src, dst), 400, 3,
                                               seed=5, device="cpu"):
        assert s.shape == d.shape == w.shape == op.shape == (400,)
        ins = list(zip(s[op == 1].tolist(), d[op == 1].tolist()))
        dels = list(zip(s[op == -1].tolist(), d[op == -1].tolist()))
        assert len(ins) == 320 and len(dels) == 80
        assert len(set(ins)) == 320 and not set(ins) & live
        assert len(set(dels)) == 80 and set(dels) <= live
        live = (live | set(ins)) - set(dels)


def test_port_imports_neither_jax_nor_the_reference():
    bad = []
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_snapshot_versions_and_replica(fragmented):
    import repro.stream.snapshot as jsnap

    from repro_torch.stream import snapshot as tsnap
    j, p = fragmented
    js = jsnap.advance(jsnap.snapshot_of(j, epoch=3, watermark=40), j, 77)
    ps = tsnap.advance(tsnap.snapshot_of(p, epoch=3, watermark=40), p, 77)
    assert ps.version == js.version == (4, 77)
    assert ps.tier_version == js.tier_version == (0, 4, 77)
    assert int(ps.num_edges) == int(js.num_edges)
    rep = tsnap.device_replica(ps, "cpu")
    assert rep.version == ps.version and rep.run_version == 0
    assert_cbl_equal(j, rep.cbl)
    q = t(np.arange(-2, NV + 2, dtype=np.int32))
    assert torch.equal(tsnap.query_degrees(rep, q),
                       tsnap.query_degrees(ps, q))
