"""Port parity: the FindNeighbor chain walks (``kernels/chain_walk``'s plain
versions, ``read_edges`` and the sampler) against the JAX package's
``lax.while_loop`` walks, bit for bit; k-hop sample invariants."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.cblist as jcb  # noqa: E402
import repro.core.updates as jup  # noqa: E402
import repro.graph.sampler as jsm  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import updates as tup  # noqa: E402
from repro_torch.graph import sampler as tsm  # noqa: E402
from repro_torch.kernels.chain_walk import (locate, locate_ref, rank_walk,  # noqa: E402
                                            rank_walk_ref)

from torch_parity import NV, assert_exact, graph, t  # noqa: E402


def _overlapping(width: int, seed: int = 0):
    """Both packages' CBList after two update batches that insert present
    keys again (parallel edges) and new keys behind old ones: chains that
    overlap in key range, blocks off the GTChain order."""
    src, dst, w = graph(seed=seed)
    nb = jcb.blocks_needed(src, NV, width) * 2 + 64
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           num_vertices=NV, num_blocks=nb, block_width=width)
    rng = np.random.default_rng(seed + 1)
    for _ in range(2):
        i = rng.integers(0, len(src), 150)
        us = np.concatenate([src[i], rng.integers(0, NV, 150)]).astype(np.int32)
        ud = np.concatenate([dst[i], rng.integers(0, NV, 150)]).astype(np.int32)
        op = np.where(rng.random(300) < 0.25, -1, 1).astype(np.int32)
        j = jup.batch_update(j, jnp.asarray(us), jnp.asarray(ud), None,
                             jnp.asarray(op))
    return (src, dst), j, interop.cbl_from_arrays(j, device="cpu")


def _queries(src, dst, seed):
    rng = np.random.default_rng(seed)
    i = rng.integers(0, len(src), 200)
    qs = np.concatenate([src[i], rng.integers(-3, NV + 3, 200)]).astype(np.int32)
    qd = np.concatenate([dst[i], rng.integers(0, NV + 5, 200)]).astype(np.int32)
    active = rng.random(400) < 0.85
    return qs, qd, active


@pytest.mark.parametrize("width", [8, 32])
def test_locate_plain_matches_the_reference_walk(width):
    (src, dst), j, p = _overlapping(width)
    qs, qd, active = _queries(src, dst, seed=width)
    ref = jup._locate(j, jnp.asarray(qs), jnp.asarray(qd),
                      jnp.asarray(active))
    st = p.store
    got = locate_ref(st.keys, st.nxt, p.v_head, t(qs), t(qd), t(active))
    for g, r in zip(got, ref):
        assert_exact(g, r)
    found = np.asarray(ref[0]) != -1
    assert found[:200].sum() > 100 and not found[~active].any()
    # the wrapper on host tensors is the plain version
    for g, r in zip(locate(st.keys, st.nxt, p.v_head, t(qs), t(qd),
                           t(active)), got):
        assert torch.equal(g, r)


@pytest.mark.parametrize("width", [8, 32])
def test_read_edges_matches_the_reference(width):
    (src, dst), j, p = _overlapping(width, seed=2)
    qs, qd, _ = _queries(src, dst, seed=3)
    jf, jw = jup.read_edges(j, jnp.asarray(qs), jnp.asarray(qd))
    pf, pw = tup.read_edges(p, t(qs), t(qd))
    assert_exact(pf, jf)
    assert_exact(pw, jw)


def test_read_edges_active_mask_skips_lanes():
    (src, dst), _, p = _overlapping(8)
    qs, qd = t(src[:50].astype(np.int32)), t(dst[:50].astype(np.int32))
    active = torch.arange(50) % 2 == 0
    found, w = tup.read_edges(p, qs, qd, active=active)
    full, wf = tup.read_edges(p, qs, qd)
    assert torch.equal(found, full & active)
    assert torch.equal(w, torch.where(active, wf, 0.0))


def test_locate_wrapper_checks_its_inputs():
    (_, _), _, p = _overlapping(8)
    st = p.store
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        locate(st.keys, st.nxt, p.v_head, q.long(), q, q == 0)
    with pytest.raises(ValueError):
        locate(st.keys, st.nxt, p.v_head, q[::2], q[:2], q[:2] == 0)


@pytest.mark.parametrize("width", [8, 32])
def test_rank_walk_with_the_reference_draws(width):
    _, j, p = _overlapping(width, seed=4)
    rng = np.random.default_rng(5)
    verts = rng.integers(0, NV, 60).astype(np.int32)
    key, k = jax.random.PRNGKey(9), 7
    ref_nbrs, ref_ok = jsm._sample_neighbors(j, jnp.asarray(verts), key, k)
    # the ranks the reference drew inside _sample_neighbors
    deg = j.v_deg[jnp.asarray(verts)]
    ranks = jax.random.randint(key, (len(verts), k), 0,
                               jnp.maximum(deg, 1)[:, None])
    nbrs, ok = tsm.rank_neighbors(p, t(verts), t(ranks))
    assert_exact(nbrs, ref_nbrs)
    assert_exact(ok, ref_ok)
    assert bool(ok.any()) and not bool(ok.all())
    st = p.store
    heads = torch.where(p.v_deg[t(verts).long()] > 0,
                        p.v_head[t(verts).long()], -1).to(torch.int32)
    plain = rank_walk_ref(st.keys, st.count, st.nxt, heads, t(ranks))
    assert torch.equal(plain, nbrs)
    assert torch.equal(rank_walk(st.keys, st.count, st.nxt, heads, t(ranks)),
                       plain)


def test_khop_sample_invariants():
    """Every valid sampled edge is live, and validity carries across hops:
    a hop-2 lane is valid only under a valid hop-1 parent."""
    (src, dst), _, p = _overlapping(8, seed=6)
    seeds = t(np.array([0, 1, 5, 17, 150, 199, 198, 3], np.int32))
    gen = torch.Generator().manual_seed(3)
    sg = tsm.sample_subgraph(p, seeds, gen, fanout=(5, 3))
    n1 = len(seeds) * 5
    assert sg.src.shape == (n1 + n1 * 3,)
    assert torch.equal(sg.layer, torch.cat([torch.zeros(n1, dtype=torch.int32),
                                            torch.ones(n1 * 3,
                                                       dtype=torch.int32)]))
    found, _ = tup.read_edges(p, sg.src, sg.dst)
    assert bool(found[sg.valid].all()) and int(sg.valid.sum()) > n1
    parent_ok = sg.valid[:n1].repeat_interleave(3)
    assert not bool((sg.valid[n1:] & ~parent_ok).any())
    assert torch.equal(sg.src[n1:], torch.where(
        sg.valid[:n1], sg.dst[:n1], 0).repeat_interleave(3))
    # the same generator seed draws the same sample
    again = tsm.sample_subgraph(p, seeds, torch.Generator().manual_seed(3),
                                fanout=(5, 3))
    assert all(torch.equal(a, b) for a, b in zip(sg, again))
