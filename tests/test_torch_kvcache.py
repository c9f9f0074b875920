"""Paged KV cache of the port against ``repro.models.transformer.kvcache``:
``append`` (pure and in place) and ``append_many`` leave the pool, block
table, lengths, free stack and free_top bit-identical to JAX ``append`` (a
pool that runs dry and a chain longer than its table included), and
``attend`` matches JAX ``attend``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models.transformer import kvcache as JKV  # noqa: E402
from repro_torch.models.transformer import kvcache as KV  # noqa: E402

from torch_parity import t  # noqa: E402

B, KVH, D, PAGE = 3, 2, 16, 4
FIELDS = KV.PagedKVCache._fields


def _caches(num_pages, npmax):
    kw = dict(max_pages_per_seq=npmax)
    return (JKV.init_paged_cache(B, KVH, D, num_pages, PAGE,
                                 dtype=jnp.float32, **kw),
            KV.init_paged_cache(B, KVH, D, num_pages, PAGE,
                                dtype=torch.float32, device="cpu", **kw))


def assert_same_state(jax_cache, cache):
    for name in FIELDS:
        ref = np.asarray(getattr(jax_cache, name))
        got = getattr(cache, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def _tokens(seed, T):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((T, B, KVH, D)).astype(np.float32),
            rng.standard_normal((T, B, KVH, D)).astype(np.float32))


# (pool pages, table slots, tokens): roomy; dry after 8 pages; a chain that
# outgrows its 2-slot table (the last slot is overwritten, as in JAX)
CASES = [(32, 8, 11), (8, 4, 14), (32, 2, 13)]


@pytest.mark.parametrize("num_pages,npmax,T", CASES)
def test_append_is_bit_identical_to_jax(num_pages, npmax, T):
    jc, c = _caches(num_pages, npmax)
    ks, vs = _tokens(T, T)
    for step in range(T):
        before = c
        jc = JKV.append(jc, jnp.asarray(ks[step]), jnp.asarray(vs[step]))
        c = KV.append(c, t(ks[step]), t(vs[step]))
        assert_same_state(jc, c)
        assert before.k_pages is not c.k_pages            # pure: a new pool
    if num_pages == 8:
        assert int(c.free_top) < 0                         # ran dry


@pytest.mark.parametrize("num_pages,npmax,T", CASES)
def test_append_in_place_is_bit_identical_to_jax(num_pages, npmax, T):
    """``inplace=True`` leaves JAX ``append``'s state in the given cache's
    own tensors (block table, lengths and free_top too), so their addresses
    stay fixed, as a captured CUDA graph needs."""
    jc, c = _caches(num_pages, npmax)
    own = tuple(c)
    ks, vs = _tokens(T + 3, T)
    for step in range(T):
        jc = JKV.append(jc, jnp.asarray(ks[step]), jnp.asarray(vs[step]))
        got = KV.append(c, t(ks[step]), t(vs[step]), inplace=True)
        assert all(a is b for a, b in zip(got, own))
        assert_same_state(jc, got)
    if num_pages == 8:
        assert int(c.free_top) < 0                         # ran dry


@pytest.mark.parametrize("num_pages,npmax,T", CASES)
def test_append_many_is_bit_identical_to_t_jax_appends(num_pages, npmax, T):
    jc, c = _caches(num_pages, npmax)
    ks, vs = _tokens(T + 1, T)
    c = KV.append(c, t(ks[0]), t(vs[0]))      # start mid-page
    jc = JKV.append(jc, jnp.asarray(ks[0]), jnp.asarray(vs[0]))
    for step in range(1, T):
        jc = JKV.append(jc, jnp.asarray(ks[step]), jnp.asarray(vs[step]))
    seq = lambda a: t(a[1:].transpose(1, 2, 0, 3))       # [B, KVH, T-1, D]
    pure = KV.append_many(c, seq(ks), seq(vs))
    assert_same_state(jc, pure)
    assert not torch.equal(pure.k_pages, c.k_pages)      # input untouched
    inplace = KV.append_many(c, seq(ks), seq(vs), inplace=True)
    assert inplace.k_pages is c.k_pages
    assert_same_state(jc, inplace)


def _masked_appends(num_pages, npmax, ks, vs, counts):
    """Oracle of ``append_many`` with per-sequence counts: step-by-step
    appends (JAX ``append``'s rules, in numpy) in which, at step t, only the
    sequences with t < counts[b] append."""
    kp = np.zeros((KVH, num_pages, PAGE, D), np.float32)
    vp = kp.copy()
    bt = np.full((B, npmax), -1, np.int32)
    lens = np.zeros(B, np.int32)
    stack = np.arange(num_pages - 1, -1, -1, dtype=np.int32)
    top = num_pages
    for step in range(ks.shape[0]):
        for b in range(B):
            if step >= counts[b]:
                continue
            slot = min(lens[b] // PAGE, npmax - 1)
            if lens[b] % PAGE == 0:
                bt[b, slot] = stack[top - 1] if top >= 1 else num_pages
                top -= 1
            pid = bt[b, slot]
            if 0 <= pid < num_pages:
                kp[:, pid, lens[b] % PAGE] = ks[step, b]
                vp[:, pid, lens[b] % PAGE] = vs[step, b]
            lens[b] += 1
    return dict(k_pages=kp, v_pages=vp, block_table=bt, lengths=lens,
                free_stack=stack, free_top=np.int32(top))


@pytest.mark.parametrize("num_pages,npmax,T", CASES)
def test_append_many_with_per_sequence_counts(num_pages, npmax, T):
    _, c = _caches(num_pages, npmax)
    ks, vs = _tokens(2 * T, T)
    counts = np.array([T, 1, T - 5])
    got = KV.append_many(c, t(ks.transpose(1, 2, 0, 3)),
                         t(vs.transpose(1, 2, 0, 3)), t(counts))
    ref = _masked_appends(num_pages, npmax, ks, vs, counts)
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), ref[name],
                                      err_msg=name)


def test_oracle_agrees_with_jax_when_every_sequence_appends():
    ks, vs = _tokens(3, 14)
    jc, _ = _caches(8, 4)
    for step in range(14):
        jc = JKV.append(jc, jnp.asarray(ks[step]), jnp.asarray(vs[step]))
    ref = _masked_appends(8, 4, ks, vs, [14] * B)
    for name in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(jc, name)),
                                      ref[name], err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (6, 50.0)])
def test_attend_matches_jax(impl, window, cap):
    jc, c = _caches(32, 8)
    ks, vs = _tokens(7, 11)
    jc = JKV.append(jc, jnp.asarray(ks[0]), jnp.asarray(vs[0]))
    c = KV.append(c, t(ks[0]), t(vs[0]))
    for step in range(1, 11):
        jc = JKV.append(jc, jnp.asarray(ks[step]), jnp.asarray(vs[step]))
    c = KV.append_many(c, t(ks[1:].transpose(1, 2, 0, 3)),
                       t(vs[1:].transpose(1, 2, 0, 3)))
    q = np.random.default_rng(8).standard_normal((B, 4, D)).astype(np.float32)
    kw = dict(scale=D ** -0.5, window=window, softcap=cap)
    ref = JKV.attend(jc, jnp.asarray(q), impl=impl, **kw)
    for port_impl in ("torch", "cuda"):
        got = KV.attend(c, t(q), impl=port_impl, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-6)


def test_attend_on_a_dry_pool_matches_jax():
    """Sequences whose last pages could not be allocated: both read what
    the clamped page ids name (JAX's gather clamps id P to P - 1)."""
    jc, c = _caches(8, 4)
    ks, vs = _tokens(9, 14)
    for step in range(14):
        jc = JKV.append(jc, jnp.asarray(ks[step]), jnp.asarray(vs[step]))
        c = KV.append(c, t(ks[step]), t(vs[step]))
    assert int((c.block_table == 8).sum()) > 0
    q = np.random.default_rng(2).standard_normal((B, 4, D)).astype(np.float32)
    ref = JKV.attend(jc, jnp.asarray(q), scale=0.25, impl="xla")
    got = KV.attend(c, t(q), scale=0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
