"""The benchmark's traffic at a small size: the R-MAT copy, the sliding
window (E live edges at every epoch, inserts fresh, deletes live and
oldest first) and the read-back positions."""
import pytest
import torch

from graphbench import gen
from graphbench.tests import tiny
from repro_torch.data.synthetic import rmat_from_uniforms as program_rmat


def keyset(src, dst, nv):
    return set((src.long() * nv + dst.long()).tolist())


def test_rmat_copy_is_the_programs():
    for seed in (1, 2 ** 31 + 5):
        draws = {}

        def draw(level, n=3000):
            if level not in draws:
                g = torch.Generator().manual_seed(seed * 100 + level)
                draws[level] = torch.rand(n, generator=g)
            return draws[level]
        a = gen.rmat_from_uniforms(draw, 1000, 2000)
        b = program_rmat(draw, 1000, 2000, dedupe=False)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.parametrize("name,rounds", [(c, r) for c in tiny.CONFIGS
                                         for r in (70, 8)])
def test_sliding_window(name, rounds):
    cfg = tiny.config(name)
    st, (src, dst, w) = gen.make_stream(cfg, 40, tiny.SEED, "cpu")
    st.ensure(rounds)
    nv, E, d = st.nv, st.edges, st.d
    assert st.rounds >= rounds and src.numel() == E
    assert st.block % d == 0 and st.block <= E
    assert bool(((w >= 0.1) & (w < 1.0)).all()) and w.dtype == torch.float32
    s, t, ww = st.live(0)
    assert torch.equal(s, src) and torch.equal(t, dst) and torch.equal(ww, w)
    live = keyset(src, dst, nv)
    assert len(live) == E
    for j in range(rounds):
        src, dst, _ = st.batch(j)
        ins = keyset(src[:d], dst[:d], nv)
        dels = keyset(src[d:], dst[d:], nv)
        assert len(ins) == d and len(dels) == d
        assert not ins & live and dels <= live
        live = (live - dels) | ins
        s, t, _ = st.live(j + 1)
        assert keyset(s, t, nv) == live and s.numel() == E
    assert st.op[:d].eq(1).all() and st.op[d:].eq(-1).all()


def test_initial_graph_and_inserts_share_one_distribution():
    """The initial edges are kept in draw order, as the inserts are, not
    the smallest keys: the share of edges leaving the upper half of the
    vertex ids is the same in both."""
    # sparse enough that nearly every draw is a new key, as at full size
    cfg = dict(tiny.config(), vertices=4096)
    st, (src, _, _) = gen.make_stream(cfg, 40, tiny.SEED, "cpu")
    st.ensure(75)
    ins = st.take(st.edges, st.made)[0]
    share = [float((x >= st.nv // 2).double().mean()) for x in (src, ins)]
    assert share[0] > 0.15 and abs(share[0] - share[1]) < 0.05, share
    keys = gen.fresh_block(st.edges, torch.empty(0, dtype=torch.int64),
                           st.nv, gen.generator(tiny.SEED, "rmat", "cpu"),
                           "cpu", **st.rmat)
    assert torch.equal(src.long() * st.nv + st.live(0)[1].long(), keys)


def test_blocks_made_as_needed_are_the_same():
    eager = gen.make_stream(tiny.config(), 40, tiny.SEED, "cpu")[0]
    eager.ensure(60)
    lazy = gen.make_stream(tiny.config(), 40, tiny.SEED, "cpu")[0]
    for j in range(60):
        lazy.batch(j)
    assert lazy.made == eager.made > lazy.edges
    for a, b in zip(lazy.take(0, lazy.made), eager.take(0, eager.made)):
        assert torch.equal(a, b)


def test_labels_permuted_from_the_seed():
    _, plain = gen.make_stream(dict(tiny.config("g500-s24"),
                                    permute_labels=False), 40, 7, "cpu")
    _, perm = gen.make_stream(tiny.config("g500-s24"), 40, 7, "cpu")
    deg_a = torch.bincount(plain[0].long(), minlength=256)
    deg_b = torch.bincount(perm[0].long(), minlength=256)
    assert torch.equal(torch.sort(deg_a)[0], torch.sort(deg_b)[0])
    assert not torch.equal(deg_a, deg_b)


def test_same_seed_same_stream():
    a, b, c = (gen.make_stream(tiny.config(), 40, seed, "cpu")[0]
               for seed in (tiny.SEED, tiny.SEED, tiny.SEED + 1))
    for st in (a, b, c):
        st.ensure(6)
    assert all(torch.equal(x, y) for x, y in zip(a.batch(5), b.batch(5)))
    assert not torch.equal(a.batch(5)[0], c.batch(5)[0])


def test_gather_and_read_back_positions():
    st, _ = gen.make_stream(tiny.config(), 40, 3, "cpu")
    st.ensure(30)
    total = st.made
    pos = torch.arange(total)
    s, t, w = st.gather(pos)
    ps, pt, pw = st.take(0, total)
    assert torch.equal(s, ps) and torch.equal(t, pt) and torch.equal(w, pw)
    k = 4
    got = gen.sample_positions(st, k, 100, 3, "cpu")
    last = set(range(st.edges + (k - 1) * st.d, st.edges + k * st.d))
    assert last <= set(got.tolist())
    assert int(got.min()) >= 0 and int(got.max()) < total


def test_pick_source_has_out_edges():
    st, (src, _, _) = gen.make_stream(tiny.config(), 40, 9, "cpu")
    v = gen.pick_source(src, st.nv, 4, 9)
    assert int((src == v).sum()) >= 4
