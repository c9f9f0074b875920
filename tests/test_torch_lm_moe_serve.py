"""MoE decoding on the port's paged path against the JAX package, float32,
with the JAX weights carried over by ``interop.lm_params_from_jax``: four
teacher-forced ``serve_step_paged`` steps (both routes; the kernel route
takes its plain versions on the host) against JAX's dense ``serve_step`` at
the qwen3-moe smoke config (dropless), the same config at capacity factor
1.25 (decode drops lanes) and the kimi-k2 smoke config (a shared expert);
``serve`` against a JAX prefill + greedy ``serve_step`` loop, token for
token; and the token plan that builds with no read of the device, bit for
bit the ``bincount`` formula it replaced."""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import kimi_k2_1t_a32b as j_kimi  # noqa: E402
from repro.configs import qwen3_moe_30b_a3b as j_qwen  # noqa: E402
from repro.models.transformer import model as JM  # noqa: E402
from repro_torch import interop  # noqa: E402
from repro_torch.kernels.segment_matmul.ops import (  # noqa: E402
    csr_items_per_cta, merge_path_partition)
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.transformer import kvcache as KV  # noqa: E402
from repro_torch.models.transformer import layers as L  # noqa: E402
from repro_torch.models.transformer import model as M  # noqa: E402

from torch_parity import lm_config, t  # noqa: E402

# float32 logits through several layers of matmuls whose sums run in another
# order than XLA's (tests/test_torch_lm.py's): relative, with a floor for
# logits near 0
RTOL, ATOL = 1e-4, 1e-5
B, S, PAGE, STEPS = 4, 12, 4, 4

CONFIGS = {
    "qwen3-dropless": lambda: j_qwen.smoke_config(),
    # 8 lanes a step for 8 experts of capacity(B = 4) = 2 slots: drops
    "qwen3-drops": lambda: dataclasses.replace(j_qwen.smoke_config(),
                                               capacity_factor=1.25),
    "kimi-shared": lambda: j_kimi.smoke_config(),
}


@functools.lru_cache(maxsize=None)
def _jax_step(jcfg):
    return jax.jit(functools.partial(JM.serve_step, cfg=jcfg))


@functools.lru_cache(maxsize=None)
def _jax_prefill(jcfg):
    return jax.jit(functools.partial(JM.prefill, cfg=jcfg))


def _dense_start(jcfg, jparams, toks, prompt_lens, extra):
    """JAX prefill of padded prompts, copied into a dense cache of room
    S + extra, zeroed past each prompt (as ``repro.launch.serve`` does)."""
    S_ = toks.shape[1]
    logits, cache = _jax_prefill(jcfg)(jparams, tokens=jnp.asarray(toks))
    dense = JM.init_cache(jcfg, toks.shape[0], S_ + extra, dtype=jnp.float32)
    live = (np.arange(S_ + extra)[None, :] < prompt_lens[:, None])
    live = jnp.asarray(live)[None, :, None, :, None]
    for name in ("k", "v"):
        dense[name] = dense[name].at[:, :, :, :S_].set(cache[name]) * live
    dense["lengths"] = jnp.asarray(prompt_lens, jnp.int32)
    return logits, dense


@pytest.fixture(scope="module", params=list(CONFIGS))
def model(request):
    jcfg = CONFIGS[request.param]()
    jparams = JM.init_params(jax.random.PRNGKey(3), jcfg)
    params = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    rng = np.random.default_rng(8)
    toks = rng.integers(0, jcfg.vocab, (B, S)).astype(np.int32)
    return request.param, jcfg, lm_config(jcfg), jparams, params, toks


def test_paged_moe_decode_matches_jax_dense_decode(model):
    """Four teacher-forced steps through ``serve_step_paged`` (chains filled
    to each prompt's own length, page 4) on both routes against JAX
    ``serve_step`` on the dense cache; at capacity factor 1.25 layer 0
    drops lanes."""
    name, jcfg, cfg, jparams, params, toks = model
    lens = np.array([12, 5, 9, 1], np.int32)
    _, jdense = _dense_start(jcfg, jparams, toks, lens, STEPS)
    _, dense = M.prefill(params, cfg, t(toks))
    npmax = -(-(S + STEPS) // PAGE) + 1
    caches = [KV.append_many(
        KV.init_paged_cache(B, cfg.n_kv_heads, cfg.head_dim, B * npmax,
                            PAGE, npmax, dtype=torch.float32, device="cpu"),
        dense["k"][li], dense["v"][li], t(lens))
        for li in range(cfg.n_layers)]
    feed = np.random.default_rng(4).integers(0, jcfg.vocab, (STEPS, B, 1))
    dropped = []
    for step in range(STEPS):
        tok = feed[step].astype(np.int32)
        ref, jdense = _jax_step(jcfg)(jparams, cache=jdense,
                                      tokens=jnp.asarray(tok))
        for impl in ("torch", "cuda"):
            got, new = M.serve_step_paged(params, cfg, caches, t(tok),
                                          impl=impl)
            np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {step} {impl}")
        # the lanes layer 0's MoE drops at this step (its input rebuilt)
        lp = params["layers"][0]
        x = M.embed(params, cfg, t(tok))
        q, k, v = M._decode_qkv(lp, cfg, x, caches[0].lengths)
        o = KV.attend(KV.append(caches[0], k, v), q,
                      scale=cfg.head_dim ** -0.5, impl="torch")
        x = x + o.reshape(B, 1, -1) @ lp["attn"]["wo"]
        z = L.rmsnorm(lp["ln2"], x, cfg.norm_eps).reshape(B, -1)
        _, eidx, _ = L.route(lp["moe"], cfg, z.float())
        plan = L.token_plan(eidx, L.capacity(cfg, B), cfg.n_experts)
        dropped.append(int((~plan.keep).sum()))
        caches = new
        np.testing.assert_array_equal(caches[0].lengths.numpy(),
                                      lens + step + 1)
    if name == "qwen3-drops":
        assert L.capacity(cfg, B) == 2 and sum(dropped) > 0, dropped
    else:
        assert L.capacity(cfg, B) == B and max(dropped) == 0, dropped


def test_moe_serve_matches_jax_prefill_and_decode_loop():
    """``serve`` at the qwen3-moe smoke config against the JAX prefill +
    greedy serve_step loop over a dense cache, token for token."""
    jcfg = j_qwen.smoke_config()
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    params = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    rng = np.random.default_rng(6)
    lens = rng.integers(4, S + 1, B).astype(np.int32)
    prompts = rng.integers(0, jcfg.vocab, (B, int(lens.max())))
    toks = np.where(np.arange(prompts.shape[1])[None, :] < lens[:, None],
                    prompts, 0).astype(np.int32)
    steps = 8
    logits, dense = _dense_start(jcfg, jparams, toks, lens, steps)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    ref = [tok]
    for _ in range(steps):
        logits, dense = _jax_step(jcfg)(jparams, cache=dense, tokens=tok)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        ref.append(tok)
    ref = np.concatenate([np.asarray(x) for x in ref], 1)
    res = serve(lm_config(jcfg), params, t(prompts), t(lens), steps,
                page=PAGE, device="cpu")
    assert not res.graph
    np.testing.assert_array_equal(res.tokens.numpy(), ref)


def _bincount_plan(eidx, C, E):
    """The token plan as it was built with ``bincount`` (a read of the
    device on the card): the reference for the plan built without one."""
    T_, K = eidx.shape
    se, order = torch.sort(eidx.reshape(-1), stable=True)
    counts = torch.bincount(se, minlength=E)
    estart = torch.cumsum(counts, 0) - counts
    rank = torch.arange(T_ * K) - estart[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)
    slot_of_lane = torch.empty_like(slot)
    slot_of_lane[order] = slot
    tok_of_slot = torch.full((E * C + 1,), T_, dtype=torch.int64)
    tok_of_slot[slot] = order // K
    return dict(order=order, keep=keep, slot=slot.to(torch.int32),
                slot_of_lane=slot_of_lane.to(torch.int32),
                tok_of_slot=tok_of_slot[:E * C].to(torch.int32),
                row_ptr=torch.arange(T_ + 1, dtype=torch.int32) * K)


@pytest.mark.parametrize("T_,K,E,C,skew", [
    (64, 8, 128, 1, False),       # qwen3-moe's decode: 64 lanes, 1 slot
    (300, 2, 8, 94, False),
    (300, 2, 8, 20, True),        # one expert takes most lanes: overflow
    (1, 8, 16, 1, False),
    (50, 3, 7, 50, True),         # dropless
])
def test_token_plan_without_bincount_is_the_bincount_plan(T_, K, E, C, skew):
    gen = torch.Generator().manual_seed(T_ * K + C)
    scores = torch.rand((T_, E), generator=gen)
    if skew:
        scores[:, 3] += 0.8
    eidx = torch.topk(scores, K, dim=-1).indices
    plan = L.token_plan(eidx, C, E)
    for key, ref in _bincount_plan(eidx, C, E).items():
        got = getattr(plan, key)
        assert got.dtype == ref.dtype and torch.equal(got, ref), key
    if skew and C < T_:
        assert not bool(plan.keep.all())
    # the aux loss's counts: index_add of ones in float32, bincount's bits
    xf = torch.randn((T_, 16), generator=gen)
    p = {"router": torch.randn((16, E), generator=gen)}
    cfg = dataclasses.replace(lm_config(j_qwen.smoke_config()), n_experts=E,
                              top_k=K)
    _, ei, aux = L.route(p, cfg, xf)
    probs = torch.softmax(xf @ p["router"], dim=-1)
    ce = torch.bincount(ei.reshape(-1), minlength=E).float() / (T_ * K)
    assert torch.equal(aux, E * torch.sum(probs.mean(dim=0) * ce))


@pytest.mark.parametrize("T_,K", [(0, 8), (1, 1), (8, 8), (24_576, 8),
                                  (300, 2), (37, 3)])
def test_token_plan_partition_is_the_merge_path_partition(T_, K):
    """The partition made from the host ints (T, K) equals
    ``merge_path_partition`` over the plan's ``row_ptr`` at every width
    template of the kernel."""
    plan = L.token_plan(torch.zeros((T_, K), dtype=torch.int64), T_, 4)
    for F in (1, 2, 16, 32, 50, 2048):
        ref = merge_path_partition(plan.row_ptr, csr_items_per_cta(F))
        got = plan.partition(F)
        assert got.dtype == ref.dtype and torch.equal(got, ref), F
