"""Port parity at inputs the other parity tests do not reach: an insert
whose source lies outside the vertex table, a stored negative destination
under ``in_degrees``, and BFS / SSSP from a negative source.  Each goes
through the JAX GraphService and the port's on the CPU; reports and
results compare bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core.engine import in_degrees as j_in_degrees  # noqa: E402
from repro.data import rmat_edges  # noqa: E402
from repro.stream import GraphService as JService  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core.engine import in_degrees as t_in_degrees  # noqa: E402
from repro_torch.stream.service import GraphService as TService  # noqa: E402

from torch_parity import assert_exact  # noqa: E402

I32 = np.int32


def _services(src, dst, **kw):
    return (JService.from_coo(src, dst, None, **kw),
            TService.from_coo(src, dst, None, device="cpu", **kw))


def _store_diff(jcbl, tcbl):
    """{field: indices where the two stores differ} over every array."""
    got = interop.cbl_to_numpy(tcbl)
    out = {}
    for k, v in got["store"].items():
        ref = np.asarray(getattr(jcbl.store, k))
        if not np.array_equal(ref, v):
            out[f"store.{k}"] = np.argwhere(ref != v).tolist()
    for k, v in got.items():
        if k != "store" and not np.array_equal(np.asarray(getattr(jcbl, k)),
                                               v):
            out[k] = np.argwhere(np.asarray(getattr(jcbl, k)) != v).tolist()
    return out


@pytest.mark.parametrize("sources, r1_lanes", [
    ([100, 2], 1), ([2, 100, 3], 1), ([-1, 2], 1), ([-20, 2], 1),
    ([8, 9], 0)])
def test_insert_from_a_source_outside_the_table(sources, r1_lanes):
    """The flush completes with the reference's report: JAX counts an
    insert from a source outside [0, capacity) as applied, and so does the
    port.  JAX also scatters that edge into the pool (its fault R1: the
    last block for a source at or past the capacity, a clamped row's block
    below -capacity) when its clamped row finds a home (``r1_lanes``); the
    port stores nothing for it.  Those lanes' keys and values are the only
    difference between the two stores."""
    src = np.array([0, 1, 2, 3], I32)
    dst = np.array([1, 2, 3, 4], I32)
    j, p = _services(src, dst, num_vertices=8, num_blocks=64, block_width=4)
    us = np.array(sources, I32)
    ud = np.arange(5, 5 + len(sources), dtype=I32)
    j.apply(us, ud)
    p.apply(us, ud)
    jr, pr = j.flush(), p.flush()
    assert pr[:5] == jr[:5]
    outside = (us < 0) | (us >= p.snapshot.cbl.capacity_vertices)
    diff = _store_diff(j.snapshot.cbl, p.snapshot.cbl)
    assert set(diff) == ({"store.keys", "store.vals"} if r1_lanes else set())
    assert diff.get("store.keys") == diff.get("store.vals")
    assert len(diff.get("store.keys", [])) == r1_lanes
    keys = interop.to_numpy(p.snapshot.cbl.store.keys)
    jkeys = np.asarray(j.snapshot.cbl.store.keys)
    for b, lane in diff.get("store.keys", []):
        assert keys[b, lane] == np.iinfo(I32).max          # the port: empty
        assert jkeys[b, lane] in ud[outside]               # JAX: the edge
    # reads of the in-range inserts agree
    found_j, w_j = j.query_edges(us[~outside], ud[~outside])
    found_p, w_p = p.query_edges(us[~outside], ud[~outside])
    assert_exact(found_p, found_j)
    assert_exact(w_p, w_j)
    assert bool(np.asarray(found_j).all())


def test_in_degrees_drops_a_stored_negative_destination():
    src, dst = rmat_edges(16, 60, seed=0)
    j, p = _services(src, dst, num_vertices=16, block_width=4)
    for svc in (j, p):
        svc.apply(np.array([2, 5], I32), np.array([-1, -7], I32))
    assert p.flush()[:4] == j.flush()[:4]
    assert_exact(t_in_degrees(p.snapshot.cbl),
                 j_in_degrees(j.snapshot.cbl))


@pytest.mark.parametrize("source", [-1, -5, -16, -17, 3, 16])
def test_bfs_and_sssp_from_a_negative_source(source):
    """A cold BFS / SSSP starts where a scatter at ``source`` lands: −1 is
    the last vertex of the table, an id below −capacity marks none."""
    src, dst = rmat_edges(16, 60, seed=0)
    j, p = _services(src, dst, num_vertices=16, block_width=4)
    for name in ("bfs", "sssp"):
        ref = np.asarray(j.analytics(name, source=source))
        assert_exact(p.analytics(name, source=source), ref)
    if source == -1:
        levels = interop.to_numpy(p.analytics("bfs", source=-1))
        assert levels[-1] == 0
