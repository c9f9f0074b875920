"""Attention kernels of the port: the plain versions of flash (prefill) and
paged (decode) attention against the JAX package's oracles and its Pallas
kernels in interpret mode, on the same numpy inputs, and the wrappers' input
checks.  The CUDA kernels are held against these plain versions in
``test_torch_cuda.py``."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import attention as j_attention  # noqa: E402
from repro.kernels import attention_ref as j_attention_ref  # noqa: E402
from repro.kernels import decode_attention as j_decode  # noqa: E402
from repro.kernels import paged_attention_ref as j_paged_ref  # noqa: E402
from repro_torch import backend  # noqa: E402
from repro_torch.kernels import (attention, decode_attention,  # noqa: E402
                                 flash_attention, paged_attention,
                                 paged_attention_split, split_pages)
from repro_torch.kernels.flash_attention import \
    attention_ref_bf16_p  # noqa: E402

from torch_parity import t  # noqa: E402

# float32 softmax attention: the sums run in another order than XLA's, so
# compare relative to the value with a small absolute floor for outputs near 0
RTOL, ATOL = 1e-5, 1e-6


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("B,H,KVH,S,D,causal,window,cap", [
    (1, 2, 2, 64, 16, True, 0, 0.0),
    (2, 4, 2, 128, 32, True, 0, 50.0),
    (1, 2, 1, 64, 16, True, 32, 0.0),
    (1, 2, 2, 64, 16, False, 0, 0.0),
    (2, 4, 2, 50, 16, True, 16, 30.0),      # S not a multiple of the tile
])
def test_flash_plain_matches_jax(B, H, KVH, S, D, causal, window, cap):
    rng = np.random.default_rng(S + H)
    q, k, v = (rng.standard_normal((B, n, S, D)).astype(np.float32)
               for n in (H, KVH, KVH))
    kw = dict(scale=1 / np.sqrt(D), causal=causal, window=window,
              softcap=cap)
    refs = [j_attention_ref(*map(jnp.asarray, (q, k, v)), **kw)]
    if S % 32 == 0:                          # the Pallas kernel's contract
        refs.append(j_attention(*map(jnp.asarray, (q, k, v)), tq=32, tk=32,
                                impl="pallas_interpret", **kw))
    before = backend.LAUNCHES["flash_attention"]
    for impl in ("torch", "cuda"):
        got = attention(t(q), t(k), t(v), impl=impl, **kw)
        assert got.shape == (B, H, S, D) and got.dtype == torch.float32
        for ref in refs:
            _close(got, ref)
    assert backend.LAUNCHES["flash_attention"] == before   # CPU: no launch


def test_flash_plain_bf16_matches_jax():
    rng = np.random.default_rng(1)
    B, H, S, D = 1, 2, 64, 16
    q, k, v = (jnp.asarray(rng.standard_normal((B, H, S, D)), jnp.bfloat16)
               for _ in range(3))
    ref = j_attention(q, k, v, scale=D ** -0.5, tq=32, tk=32,
                      impl="pallas_interpret")
    tq, tk, tv = (t(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (q, k, v))
    got = flash_attention(tq, tk, tv, scale=D ** -0.5)
    assert got.dtype == torch.bfloat16
    # both round a float32 result to bf16 once: one bf16 ulp (2^-7) apart
    _close(got, np.asarray(ref, np.float32), rtol=2 ** -7, atol=1e-5)


def bf16_kernel_bound(ref, v, group):
    """The bf16 tensor-core kernel's tolerance, per (b, head, d): P rounded
    to bf16 before P·V moves each p by at most 2^-8 · p, so the output by at
    most 2^-8 · max_k |v[k, d]|; the output's own bf16 rounding and the
    float32 sums' order stay under 2^-7 · |ref|."""
    vmax = np.repeat(np.abs(v).max(axis=2, keepdims=True), group, axis=1)
    return 2 ** -7 * np.abs(ref) + 2 ** -8 * vmax + 1e-5


@pytest.mark.parametrize("B,H,KVH,S,D,window,cap", [
    (2, 4, 2, 64, 16, 8, 50.0),        # the Gemma-2 smoke config, local
    (2, 4, 2, 64, 16, 0, 50.0),        # and global layer
    (1, 4, 2, 512, 128, 0, 50.0),      # the 27B head, four kv tiles
    (1, 4, 2, 512, 128, 96, 50.0),     # a window inside a kv tile
    (1, 2, 1, 300, 64, 0, 0.0),        # ragged S, no softcap
])
def test_flash_bf16_p_rounding_bound_is_the_arithmetics(B, H, KVH, S, D,
                                                        window, cap):
    """The plain version with the kernel's bf16 rounding of P against the
    JAX oracle in float32: inside the bf16 kernel's bound everywhere, and the
    bound no looser than the arithmetic needs (the old one-ulp bound fails,
    and the error reaches a tenth of the new one)."""
    rng = np.random.default_rng(S + D)
    q, k, v = (t(2 * rng.standard_normal((B, n, S, D)).astype(np.float32))
               .to(torch.bfloat16).float().numpy() for n in (H, KVH, KVH))
    kw = dict(scale=D ** -0.5, causal=True, window=window, softcap=cap)
    ref = np.asarray(j_attention_ref(*map(jnp.asarray, (q, k, v)), **kw))
    got = attention_ref_bf16_p(*(t(x).to(torch.bfloat16) for x in (q, k, v)),
                               **kw)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - ref)
    bound = bf16_kernel_bound(ref, v, H // KVH)
    assert (err <= bound).all()
    assert (err > 2 ** -7 * np.abs(ref) + 1e-5).any()
    assert (err / bound).max() >= 0.1


def _tf32(x):
    """x rounded to TF32 (10 fraction bits), to nearest with ties away from
    zero, as cvt.rna.tf32.f32 rounds: by masking the float32 bits."""
    bits = np.asarray(x, np.float32).view(np.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(np.float32)


def _split_products(a, b, passes):
    """a @ b with float32 operands taken as TF32 parts: hi.hi alone (one
    pass) or hi.hi + hi.lo + lo.hi (split TF32, three passes)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = np.matmul(a_hi, b_hi)
    if passes == 3:
        out = out + np.matmul(a_hi, _tf32(b - b_hi)) \
            + np.matmul(_tf32(a - a_hi), b_hi)
    return out


def attention_split_tf32(q, k, v, *, scale, causal, window, softcap,
                         passes):
    """The float32 kernel's arithmetic in numpy: Q K^T and P V as TF32
    products (``passes`` 1 or 3), scale, softcap, masks and softmax in
    float32, P split as the kernel splits it in registers.  Not the
    kernel's bits (its running max rescales p tile by tile, its products
    sum in the tensor cores' order), but its roundings."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    kk, vv = np.repeat(k, G, axis=1), np.repeat(v, G, axis=1)
    s = _split_products(q, kk.transpose(0, 1, 3, 2), passes) * \
        np.float32(scale)
    if softcap > 0:
        s = np.float32(softcap) * np.tanh(s / np.float32(softcap))
    qi, ki = np.arange(S)[:, None], np.arange(S)[None, :]
    live = np.ones((S, S), bool)
    if causal:
        live &= qi >= ki
    if window > 0:
        live &= (qi - ki) < window
    s = np.where(live, s, np.float32(-1e30)).astype(np.float32)
    p = np.exp(s - s.max(axis=-1, keepdims=True)).astype(np.float32)
    o = _split_products(p, vv, passes) / p.sum(axis=-1, keepdims=True)
    return o.astype(np.float32)


@pytest.mark.parametrize("B,H,KVH,S,D,window,cap", [
    (2, 4, 2, 64, 16, 8, 50.0),        # the Gemma-2 smoke config, local
    (2, 4, 2, 64, 16, 0, 50.0),        # and global layer
    (1, 4, 2, 512, 128, 0, 50.0),      # the 27B head, S = 512
    (1, 2, 1, 300, 64, 96, 0.0),       # ragged S, a window, no softcap
])
def test_flash_f32_split_tf32_meets_the_float32_bound(B, H, KVH, S, D,
                                                      window, cap):
    """The float32 kernel's tolerance (1e-4 |ref| + 1e-5, as chip_smoke.py
    and the card tests hold it) is met by split TF32 -- three TF32 products
    for each float32 one -- against the JAX oracle in float32, and missed
    by one TF32 pass: the split is what the bound needs.  Standard normal
    inputs, as the card tests give the kernel: the split keeps 22 of
    float32's 24 bits, so the margin shrinks with the logits' size (at
    twice these inputs the worst element sits at the bound against the
    float32 oracle; ``test_flash_attention_f32_twice_the_input_scale`` in
    ``test_torch_cuda.py`` holds the kernel to the float64 answer there)."""
    rng = np.random.default_rng(S + D + window)
    q, k, v = (rng.standard_normal((B, n, S, D)).astype(np.float32)
               for n in (H, KVH, KVH))
    kw = dict(scale=D ** -0.5, causal=True, window=window, softcap=cap)
    ref = np.asarray(j_attention_ref(*map(jnp.asarray, (q, k, v)), **kw))
    bound = 1e-4 * np.abs(ref) + 1e-5
    split = attention_split_tf32(q, k, v, passes=3, **kw)
    one = attention_split_tf32(q, k, v, passes=1, **kw)
    assert (np.abs(split - ref) <= bound).all()
    assert (np.abs(one - ref) > bound).any()


def _paged(rng, B, KVH, G, D, page, NP, P=32):
    q = rng.standard_normal((B, KVH, G, D)).astype(np.float32)
    kp = rng.standard_normal((KVH, P, page, D)).astype(np.float32)
    vp = rng.standard_normal((KVH, P, page, D)).astype(np.float32)
    bt = rng.permutation(P)[:B * NP].reshape(B, NP).astype(np.int32)
    lens = rng.integers(1, NP * page, B).astype(np.int32)
    return q, kp, vp, bt, lens


@pytest.mark.parametrize("B,KVH,G,D,page,NP,window,cap", [
    (2, 2, 4, 16, 8, 6, 0, 0.0),
    (3, 1, 8, 32, 16, 4, 0, 50.0),
    (2, 2, 2, 16, 8, 6, 24, 0.0),
])
def test_paged_plain_matches_jax(B, KVH, G, D, page, NP, window, cap):
    rng = np.random.default_rng(B * 10 + G)
    arrays = _paged(rng, B, KVH, G, D, page, NP)
    kw = dict(scale=1 / np.sqrt(D), window=window, softcap=cap)
    jargs = [jnp.asarray(a) for a in arrays]
    refs = [j_paged_ref(*jargs, **kw),
            j_decode(*jargs, impl="pallas_interpret", **kw)]
    before = backend.LAUNCHES["paged_attention"]
    for impl in ("torch", "cuda"):
        got = decode_attention(*map(t, arrays), impl=impl, **kw)
        assert got.shape == (B, KVH, G, D)
        for ref in refs:
            _close(got, ref)
    assert backend.LAUNCHES["paged_attention"] == before


def test_paged_plain_empty_sequence_is_the_uniform_average():
    """lengths == 0 masks every key with -1e30, so the reference averages V
    over every slot of the table; the port keeps that value."""
    rng = np.random.default_rng(5)
    q, kp, vp, bt, lens = _paged(rng, 2, 2, 2, 16, 8, 3)
    lens[0] = 0
    kw = dict(scale=0.25, window=4, softcap=50.0)
    ref = j_paged_ref(*map(jnp.asarray, (q, kp, vp, bt, lens)), **kw)
    got = paged_attention(*map(t, (q, kp, vp, bt, lens)), **kw)
    _close(got, ref)
    mean_v = vp[:, bt[0]].reshape(2, -1, 16).mean(axis=1)      # [KVH, D]
    _close(got[0], np.broadcast_to(mean_v[:, None, :], (2, 2, 16)),
           rtol=1e-5, atol=1e-6)


# the split kernel's plain arithmetic: B = 4 sequences of lengths 0 (no
# live key: the uniform average over every slot), 1, full (48) and 29, over
# 6 slots of 8-key pages; row 2 names page P + 3 in a live slot (read as
# page P - 1) and row 3 has -1 in a slot past its length
SPLIT_LENS = np.array([0, 1, 48, 29], np.int32)


def _split_inputs():
    rng = np.random.default_rng(17)
    q, kp, vp, bt, _ = _paged(rng, 4, 2, 2, 16, 8, 6)
    P = kp.shape[1]
    bt[2, 2], bt[3, 5] = P + 3, -1
    return q, kp, vp, bt, SPLIT_LENS.copy()


# rtol = atol = 1e-5 in float32: the merge of the partials rescales and
# sums in another order than one softmax over all keys
@pytest.mark.parametrize("pps", [1, 2, 6])
@pytest.mark.parametrize("window,cap", [(0, 0.0), (0, 50.0), (13, 0.0),
                                        (21, 50.0)])
def test_paged_split_plain_matches_jax(pps, window, cap):
    """Windows of 13 and 21 keys start inside a split of 8 or 16 keys for
    lengths 29 and 48; pps = 6 is one split over the whole table."""
    arrays = _split_inputs()
    kw = dict(scale=0.25, window=window, softcap=cap)
    jargs = [jnp.asarray(a) for a in arrays]
    refs = [j_paged_ref(*jargs, **kw),
            j_decode(*jargs, impl="pallas_interpret", **kw)]
    before = backend.LAUNCHES["paged_attention"]
    got = paged_attention_split(*map(t, arrays), pages_per_split=pps, **kw)
    assert backend.LAUNCHES["paged_attention"] == before
    for ref in refs:
        _close(got, ref, rtol=1e-5, atol=1e-5)


def test_split_pages_fills_the_card_from_the_shapes():
    """The serve shape (50 slots, 8 sequences x 16 KV heads, 132 SMs)
    splits into enough CTAs to fill the card's waves; a batch that fills
    the card alone is not split; a split never covers more than the
    table."""
    from repro_torch.kernels.paged_attention.ops import CTAS_PER_SM, WAVES
    pps = split_pages(50, 8, 16, 132)
    assert 1 <= pps < 50
    assert -(-50 // pps) * 8 * 16 >= WAVES * CTAS_PER_SM * 132
    assert split_pages(50, 64, 64, 132) == 50
    assert split_pages(3, 1, 1, 132) == 1


@pytest.mark.parametrize("pps", [0, 7])
def test_paged_split_rejects_a_split_outside_the_table(pps):
    q, kp, vp, bt, lens = map(t, _split_inputs())
    with pytest.raises(ValueError):
        paged_attention_split(q, kp, vp, bt, lens, scale=0.25,
                              pages_per_split=pps)


@pytest.mark.parametrize("bad", ["rank", "dtype", "mixed", "head_dim",
                                 "kv_shape"])
def test_flash_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 2, 8, 16)
    k = v = torch.zeros(1, 1, 8, 16)
    if bad == "rank":
        q = q[0]
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "mixed":
        q = q.to(torch.bfloat16)
    elif bad == "head_dim":
        q, k, v = (torch.zeros(x.shape[:3] + (272,)) for x in (q, k, v))
    elif bad == "kv_shape":
        k = v = torch.zeros(1, 1, 9, 16)
    with pytest.raises((ValueError, TypeError)):
        flash_attention(q, k, v, scale=0.25)


@pytest.mark.parametrize("bad", ["table_dtype", "group", "lengths"])
def test_paged_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 1, 2, 16)
    kp = vp = torch.zeros(1, 4, 8, 16)
    bt = torch.zeros(2, 2, dtype=torch.int32)
    lens = torch.ones(2, dtype=torch.int32)
    if bad == "table_dtype":
        bt = bt.long()
    elif bad == "group":
        q = torch.zeros(2, 1, 33, 16)
    elif bad == "lengths":
        lens = torch.ones(3, dtype=torch.int32)
    with pytest.raises((ValueError, TypeError)):
        paged_attention(q, kp, vp, bt, lens, scale=0.25)
