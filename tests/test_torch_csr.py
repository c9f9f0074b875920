"""Port parity of the sealed CSR runs (``repro_torch.core.csr``) against
``repro.core.csr``: the build (capacity, padding, ``dropped``, the valid
mask), point reads, in-degrees, COO extraction and the sampler fed the
ranks ``jax.random.randint`` drew, bit for bit; the push, pull and
push_feat sweeps on both routes (``impl="torch"`` and the kernel route,
whose plain versions run on the CPU) against JAX ``impl="xla"``,
real-valued sums within rtol 1e-5 (summation order) and integer-valued
ones bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.csr as jcsr  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.core import csr as tcsr  # noqa: E402

from torch_parity import NV, assert_close, assert_exact, graph, t  # noqa: E402

LANES = ("offsets", "indices", "weights", "row")


def _edges(seed=0):
    """The parity graph with 40 of its edges repeated (parallel edges, some
    with a new weight) and 10 edges whose destination is out of range."""
    src, dst, w = graph(seed=seed)
    rng = np.random.default_rng(seed + 10)
    i = rng.integers(0, len(src), 40)
    src = np.concatenate([src, src[i], rng.integers(0, NV, 10)])
    dst = np.concatenate([dst, dst[i], rng.integers(NV, NV + 5, 10)])
    w = np.concatenate([w, rng.random(50).astype(np.float32)])
    return src.astype(np.int32), dst.astype(np.int32), w


def assert_csr_equal(jg, pg) -> None:
    assert pg.nv == jg.nv and pg.capacity == jg.capacity
    for k in LANES:
        ref = np.asarray(getattr(jg, k))
        got = interop.to_numpy(getattr(pg, k))
        assert got.dtype == ref.dtype, k
        np.testing.assert_array_equal(got, ref, err_msg=k)


def _pair(seed=0, valid_frac=1.0):
    src, dst, w = _edges(seed)
    valid = np.random.default_rng(seed).random(len(src)) < valid_frac
    j = jcsr.csr_build(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                       NV, valid=jnp.asarray(valid))
    return (src, dst, w), j, interop.csr_from_arrays(j, device="cpu")


@pytest.mark.parametrize("capacity,valid_frac", [(None, 1.0), (2048, 1.0),
                                                 (1000, 1.0), (None, 0.7),
                                                 (700, 0.7)])
def test_build_matches_the_reference(capacity, valid_frac):
    src, dst, w = _edges()
    valid = np.random.default_rng(1).random(len(src)) < valid_frac
    jg, jdrop = jcsr.csr_build_counted(
        jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w), NV,
        capacity=capacity, valid=jnp.asarray(valid))
    pg, pdrop = tcsr.csr_build_counted(t(src), t(dst), t(w), NV,
                                       capacity=capacity, valid=t(valid))
    assert_csr_equal(jg, pg)
    assert pdrop == int(jdrop) and (pdrop > 0) == (capacity in (1000, 700))
    assert pg.n_live == int(jg.num_edges)
    for got, ref in zip(tcsr.csr_to_coo(pg), jcsr.csr_to_coo(jg)):
        assert_exact(got, ref)
    if pdrop:
        with pytest.raises(ValueError, match="exceed the lane capacity"):
            tcsr.csr_build(t(src), t(dst), t(w), NV, capacity=capacity,
                           valid=t(valid))


def test_the_run_keeps_sorted_keys_and_a_destination_stream():
    _, _, p = _pair()
    key = p.key
    assert bool((key[1:] >= key[:-1]).all())
    n = p.n_live
    dst = interop.to_numpy(p.indices[:n])
    in_range = (dst >= 0) & (dst < NV)
    order = np.argsort(dst[in_range], kind="stable")
    assert_exact(p.push_src, interop.to_numpy(p.row[:n])[in_range][order])
    assert_exact(p.push_w, interop.to_numpy(p.weights[:n])[in_range][order])
    assert_exact(p.push_ptr, np.searchsorted(np.sort(dst[in_range]),
                                             np.arange(NV + 1)))


def test_point_reads_match_the_reference():
    (src, dst, _), j, p = _pair(seed=2, valid_frac=0.8)
    rng = np.random.default_rng(3)
    qs = np.concatenate([src[:300], rng.integers(-3, NV + 3, 200),
                         [NV, -1, 0]]).astype(np.int32)
    qd = np.concatenate([dst[:300], rng.integers(-2, NV + 6, 200),
                         [0, 0, -5]]).astype(np.int32)
    jf, jw = jcsr.csr_query(j, jnp.asarray(qs), jnp.asarray(qd))
    pf, pw = tcsr.csr_query(p, t(qs), t(qd))
    assert_exact(pf, jf)
    assert_exact(pw, jw)          # the first of parallel edges, bit for bit
    assert int(pf.sum()) > 200
    active = t(rng.random(len(qs)) < 0.5)
    af, aw = tcsr.csr_query(p, t(qs), t(qd), active=active)
    assert torch.equal(af, pf & active)
    assert torch.equal(aw, torch.where(active, pw, 0.0))


def test_in_degrees_and_empty_runs_match_the_reference():
    _, j, p = _pair()
    assert_exact(tcsr.csr_in_degrees(p), jcsr.csr_in_degrees(j))
    assert_exact(tcsr.csr_degrees(p), jcsr.csr_degrees(j))
    je, pe = jcsr.csr_empty(NV, 0), tcsr.csr_empty(NV, 0)
    assert_csr_equal(je, pe)
    q = np.arange(5, dtype=np.int32)
    for got, ref in zip(tcsr.csr_query(pe, t(q), t(q)),
                        jcsr.csr_query(je, jnp.asarray(q), jnp.asarray(q))):
        assert_exact(got, ref)
    assert_exact(tcsr.csr_in_degrees(pe), jcsr.csr_in_degrees(je))
    x = np.ones(NV, np.float32)
    # a run whose lanes are all padding (every edge purged, capacity kept)
    src, dst, _ = _edges()
    jz = jcsr.csr_build(jnp.asarray(src[:16]), jnp.asarray(dst[:16]), None,
                        NV, valid=jnp.zeros(16, bool))
    pz = interop.csr_from_arrays(jz, device="cpu")
    assert pz.n_live == 0 and pz.capacity == 16
    for impl in ("torch", "cuda"):
        for j, p in ((je, pe), (jz, pz)):
            assert_exact(tcsr.csr_push(p, t(x), impl=impl),
                         jcsr.csr_push(j, jnp.asarray(x)))
            assert_exact(tcsr.csr_pull(p, t(x), combine="min", impl=impl),
                         jcsr.csr_pull(j, jnp.asarray(x), combine="min"))
        assert_exact(tcsr.csr_push_feat(pz, t(x[:, None]), impl=impl),
                     jcsr.csr_push_feat(jz, jnp.asarray(x[:, None])))


def test_sampler_with_the_reference_draws():
    _, j, p = _pair(seed=4)
    rng = np.random.default_rng(5)
    verts = np.concatenate([rng.integers(0, NV, 60), [-1, NV, NV + 3]]
                           ).astype(np.int32)
    key, k = jax.random.PRNGKey(9), 6
    ref_out, ref_ok = jcsr.csr_sample_neighbors(j, jnp.asarray(verts), key, k)
    # the ranks the reference drew inside csr_sample_neighbors
    vs = np.clip(verts, 0, NV - 1)
    offs = np.asarray(j.offsets)
    deg = np.where((verts >= 0) & (verts < NV), offs[vs + 1] - offs[vs], 0)
    ranks = jax.random.randint(key, (len(verts), k), 0,
                               jnp.maximum(jnp.asarray(deg), 1)[:, None])
    out, ok = tcsr.csr_sample_neighbors(p, t(verts), ranks=t(ranks))
    assert_exact(out, ref_out)
    assert_exact(ok, ref_ok)
    assert bool(ok.any()) and not bool(ok.all())
    gen = torch.Generator().manual_seed(0)
    out, ok = tcsr.csr_sample_neighbors(p, t(verts), gen, k)
    found, _ = tcsr.csr_query(p, t(verts).repeat_interleave(k),
                              out.reshape(-1))
    assert bool(found[ok.reshape(-1)].all())


def _sweep(pkg, direction):
    return {"push": pkg.csr_push, "pull": pkg.csr_pull,
            "push_feat": pkg.csr_push_feat}[direction]


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("direction,F", [("push", 0), ("pull", 0),
                                         ("push_feat", 1), ("push_feat", 7)])
def test_sum_sweeps_match_the_reference(direction, F, impl):
    _, j, p = _pair(seed=6)
    rng = np.random.default_rng(7)
    x = rng.random((NV, F) if F else NV).astype(np.float32)
    active = rng.random(NV) < 0.6
    for act in (None, active):
        jkw = {} if act is None else {2: jnp.asarray(act)}
        ref = _sweep(jcsr, direction)(j, jnp.asarray(x), *jkw.values())
        got = _sweep(tcsr, direction)(p, t(x), None if act is None
                                      else t(act), impl=impl)
        assert_close(got, ref)
    if direction != "push_feat":        # a message other than x * w
        msg = lambda xs, w: xs + 2.0 * w                     # noqa: E731
        ref = _sweep(jcsr, direction)(j, jnp.asarray(x), dense_f=msg)
        assert_close(_sweep(tcsr, direction)(p, t(x), dense_f=msg,
                                             impl=impl), ref)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("direction", ["push", "pull", "push_feat"])
def test_integer_valued_sums_are_exact(direction, impl):
    src, dst, _ = _edges(seed=8)
    j = jcsr.csr_build(jnp.asarray(src), jnp.asarray(dst), None, NV)
    p = interop.csr_from_arrays(j, device="cpu")
    x = np.random.default_rng(9).integers(0, 50, (NV, 3) if direction ==
                                          "push_feat" else NV)
    x = x.astype(np.float32)
    assert_exact(_sweep(tcsr, direction)(p, t(x), impl=impl),
                 _sweep(jcsr, direction)(j, jnp.asarray(x)))


@pytest.mark.parametrize("combine", ["min", "max"])
@pytest.mark.parametrize("direction", ["push", "pull"])
def test_min_max_sweeps_are_exact(direction, combine):
    _, j, p = _pair(seed=10, valid_frac=0.9)
    x = np.random.default_rng(11).random(NV).astype(np.float32)
    msg = lambda xs, w: xs + w                               # noqa: E731
    ref = _sweep(jcsr, direction)(j, jnp.asarray(x), dense_f=msg,
                                  combine=combine)
    for impl in ("torch", "cuda"):
        assert_exact(_sweep(tcsr, direction)(p, t(x), dense_f=msg,
                                             combine=combine, impl=impl), ref)


def test_insert_batch_rebuilds_like_the_reference():
    _, j, p = _pair(seed=12)
    rng = np.random.default_rng(13)
    s = rng.integers(0, NV, 30).astype(np.int32)
    d = rng.integers(0, NV, 30).astype(np.int32)
    w = rng.random(30).astype(np.float32)
    assert_csr_equal(jcsr.csr_insert_batch(j, jnp.asarray(s), jnp.asarray(d),
                                           jnp.asarray(w)),
                     tcsr.csr_insert_batch(p, t(s), t(d), t(w)))
