"""The port's LM serving path against ``repro.models.transformer.model`` at
the Gemma-2 smoke config and the ``tiny`` config of test_models_lm.py (5
layers: a tail after the periods), float32, with the JAX weights carried
over by ``interop.lm_params_from_jax``: forward, prefill, the dense
serve_step, the paged serve_step against JAX's dense one, and ``serve``
against a JAX prefill + serve_step loop, token for token."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import gemma2_27b as j_gemma  # noqa: E402
from repro.models.transformer import model as JM  # noqa: E402
from repro.models.transformer.layers import LMConfig as JLMConfig  # noqa
from repro_torch import interop  # noqa: E402
from repro_torch.configs import gemma2_27b  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models.transformer import kvcache as KV  # noqa: E402
from repro_torch.models.transformer import model as M  # noqa: E402
from repro_torch.models.transformer.layers import (DecoderLayer,  # noqa
                                                   apply_layer)

from torch_parity import lm_config, t  # noqa: E402

# float32 logits through several layers of matmuls whose sums run in another
# order than XLA's: relative, with a floor for logits near 0
RTOL, ATOL = 1e-4, 1e-5


def _close(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _tiny():
    return JLMConfig(name="tiny", n_layers=5, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=97, window_pattern=(8, 0),
                     attn_softcap=50.0, final_softcap=30.0, qkv_bias=True,
                     dtype=jnp.float32)


@pytest.fixture(scope="module", params=["smoke", "tiny"])
def model(request):
    jcfg = j_gemma.smoke_config() if request.param == "smoke" else _tiny()
    jparams = JM.init_params(jax.random.PRNGKey(0), jcfg)
    params = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    if request.param == "tiny":      # random biases, so they are carried too
        rng = np.random.default_rng(3)
        for lp in params["layers"]:
            for name in ("bq", "bk", "bv"):
                lp["attn"][name] = t(rng.standard_normal(
                    lp["attn"][name].shape).astype(np.float32) * 0.1)
        jparams = _with_biases(jparams, params, jcfg)
    toks = np.random.default_rng(1).integers(0, jcfg.vocab, (2, 16))
    return jcfg, lm_config(jcfg), jparams, params, toks.astype(np.int32)


def _with_biases(jparams, params, jcfg):
    """The JAX tree with the port's biases put back in place."""
    P = jcfg.period
    n_full = jcfg.n_layers // P
    periods = {}
    for i in range(P):
        sub = jax.tree.map(lambda x: x, jparams["periods"][f"l{i}"])
        for name in ("bq", "bk", "bv"):
            sub["attn"][name] = jnp.stack(
                [jnp.asarray(params["layers"][p * P + i]["attn"][name]
                             .numpy()) for p in range(n_full)])
        periods[f"l{i}"] = sub
    tail = []
    for i, lp in enumerate(jparams.get("tail", [])):
        lp = jax.tree.map(lambda x: x, lp)
        for name in ("bq", "bk", "bv"):
            lp["attn"][name] = jnp.asarray(
                params["layers"][n_full * P + i]["attn"][name].numpy())
        tail.append(lp)
    return dict(jparams, periods=periods, tail=tail)


def test_config_copy_matches_the_reference():
    for ours, ref in ((gemma2_27b.full_config(), j_gemma.full_config()),
                      (gemma2_27b.smoke_config(), j_gemma.smoke_config())):
        assert ours == lm_config(ref)


def test_forward_matches_jax(model):
    jcfg, cfg, jparams, params, toks = model
    ref, _ = JM.forward(jparams, jcfg, jnp.asarray(toks))
    for impl in ("torch", "cuda"):
        got, aux = M.forward(params, cfg, t(toks), impl=impl)
        assert got.shape == (2, 16, cfg.vocab) and float(aux) == 0.0
        _close(got, ref)


def test_prefill_matches_jax(model):
    jcfg, cfg, jparams, params, toks = model
    ref_logits, ref_cache = JM.prefill(jparams, jcfg, jnp.asarray(toks))
    logits, cache = M.prefill(params, cfg, t(toks))
    _close(logits, ref_logits)
    for name in ("k", "v"):
        _close(cache[name], ref_cache[name])
    np.testing.assert_array_equal(cache["lengths"].numpy(),
                                  np.asarray(ref_cache["lengths"]))


def test_decoder_layer_module_matches_the_function(model):
    _, cfg, _, params, toks = model
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(0))
    pos = torch.arange(16)[None].expand(2, 16)
    layer = DecoderLayer(cfg, params["layers"][1], cfg.layer_windows[1])
    assert sum(p.numel() for p in layer.parameters()) > 0
    torch.testing.assert_close(layer(x, pos), apply_layer(
        params["layers"][1], cfg, x, pos, cfg.layer_windows[1])[0])


def _dense_start(jcfg, jparams, toks, prompt_lens, extra):
    """JAX prefill of padded prompts, copied into a dense cache of room
    S + extra, zeroed past each prompt (as ``repro.launch.serve`` does)."""
    S = toks.shape[1]
    logits, cache = JM.prefill(jparams, jcfg, jnp.asarray(toks))
    dense = JM.init_cache(jcfg, toks.shape[0], S + extra, dtype=jnp.float32)
    live = (np.arange(S + extra)[None, :] < prompt_lens[:, None])
    live = jnp.asarray(live)[None, :, None, :, None]
    for name in ("k", "v"):
        dense[name] = dense[name].at[:, :, :, :S].set(cache[name]) * live
    dense["lengths"] = jnp.asarray(prompt_lens, jnp.int32)
    return logits, dense


def test_serve_step_matches_jax(model):
    jcfg, cfg, jparams, params, toks = model
    lens = np.array([16, 9], np.int32)
    _, jdense = _dense_start(jcfg, jparams, toks, lens, 4)
    dense = {k: t(v) for k, v in jdense.items()}
    nxt = np.array([[5], [7]], np.int32)
    ref, ref_cache = JM.serve_step(jparams, jcfg, jdense, jnp.asarray(nxt))
    got, cache = M.serve_step(params, cfg, dense, t(nxt))
    _close(got, ref)
    _close(cache["k"], ref_cache["k"])
    assert torch.equal(dense["k"], t(jdense["k"]))        # input untouched
    np.testing.assert_array_equal(cache["lengths"].numpy(), lens + 1)


def test_paged_decode_matches_jax_dense_decode(model):
    """Four teacher-forced steps through ``serve_step_paged`` (chains filled
    to each prompt's own length) against JAX ``serve_step`` on the dense
    cache; mixed prompt lengths, page 4."""
    jcfg, cfg, jparams, params, toks = model
    lens = np.array([16, 7], np.int32)
    _, jdense = _dense_start(jcfg, jparams, toks, lens, 8)
    _, dense = M.prefill(params, cfg, t(toks))
    caches = []
    for li in range(cfg.n_layers):
        c = KV.init_paged_cache(2, cfg.n_kv_heads, cfg.head_dim, 12, 4, 6,
                                dtype=torch.float32, device="cpu")
        caches.append(KV.append_many(c, dense["k"][li], dense["v"][li],
                                     t(lens)))
    feed = np.random.default_rng(4).integers(0, jcfg.vocab, (4, 2, 1))
    for step in range(4):
        tok = feed[step].astype(np.int32)
        ref, jdense = JM.serve_step(jparams, jcfg, jdense, jnp.asarray(tok))
        for impl in ("torch", "cuda"):
            got, new = M.serve_step_paged(params, cfg, caches, t(tok),
                                          impl=impl)
            _close(got, ref)
        caches = new
        np.testing.assert_array_equal(caches[0].lengths.numpy(),
                                      lens + step + 1)


def test_serve_matches_jax_prefill_and_decode_loop():
    """``serve`` at the smoke config against the JAX prefill + greedy
    serve_step loop over a dense cache, token for token."""
    jcfg = j_gemma.smoke_config()
    cfg = gemma2_27b.smoke_config()
    jparams = JM.init_params(jax.random.PRNGKey(2), jcfg)
    params = interop.lm_params_from_jax(jax.tree.map(np.asarray, jparams),
                                        device="cpu")
    rng = np.random.default_rng(6)
    lens = rng.integers(4, 12, 5).astype(np.int32)
    prompts = rng.integers(0, jcfg.vocab, (5, int(lens.max())))
    toks = np.where(np.arange(prompts.shape[1])[None, :] < lens[:, None],
                    prompts, 0).astype(np.int32)
    steps = 8
    logits, dense = _dense_start(jcfg, jparams, toks, lens, steps)
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    ref = [tok]
    for _ in range(steps):
        logits, dense = JM.serve_step(jparams, jcfg, dense, tok)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        ref.append(tok)
    ref = np.concatenate([np.asarray(x) for x in ref], 1)
    res = serve(cfg, params, t(prompts), t(lens), steps, page=4,
                device="cpu")
    np.testing.assert_array_equal(res.tokens.numpy(), ref)
    assert res.pages_used == int(np.ceil((lens + steps) / 4).sum())
    assert len(res.decode_s) == steps


def test_serve_cli_runs_on_the_host(capsys):
    from repro_torch.launch.serve import main
    res = main(["--device", "cpu", "--requests", "3", "--decode", "2"])
    assert res.tokens.shape == (3, 3)
    assert "served 3 seqs x 2 tokens on cpu" in capsys.readouterr().out


def test_serve_graph_needs_a_cuda_device():
    """A CUDA graph is asked for on the host: ``serve`` raises; left to
    itself it decodes eagerly there."""
    cfg = gemma2_27b.smoke_config()
    params = M.init_params(cfg, seed=0, device="cpu")
    prompts = torch.zeros((2, 4), dtype=torch.int32)
    lens = torch.full((2,), 4)
    with pytest.raises(ValueError):
        serve(cfg, params, prompts, lens, 2, page=4, device="cpu",
              graph=True)
    res = serve(cfg, params, prompts, lens, 2, page=4, device="cpu")
    assert not res.graph and res.capture_s == 0.0


def test_token_stream_matches_the_reference():
    """The port's Zipf(1.3) token batches against
    ``repro.data.token_stream``'s: the same shapes, dtype and label shift,
    and the same token frequencies within 0.02 (each share's sampling
    error over 2 x 8,256 draws is below 0.005)."""
    from repro.data.synthetic import token_stream as j_stream
    from repro_torch.data.synthetic import token_stream
    vocab, batch, seq = 500, 64, 128
    port, ref = token_stream(vocab, batch, seq, seed=3, device="cpu"), \
        j_stream(vocab, batch, seq, seed=3)
    got = [next(port) for _ in range(2)]
    want = [next(ref) for _ in range(2)]
    for (toks, labels), (rt, rl) in zip(got, want):
        assert toks.dtype == labels.dtype == torch.int32
        assert toks.shape == labels.shape == rt.shape == rl.shape
        assert torch.equal(labels[:, :-1], toks[:, 1:])
        assert int(toks.min()) >= 0 and int(toks.max()) <= vocab - 1
    g = torch.cat([x for pair in got for x in pair]).numpy()
    r = np.concatenate([x for pair in want for x in pair])
    for tok in (0, 1, 2, 3, 10, vocab - 1):
        assert abs((g == tok).mean() - (r == tok).mean()) < 0.02, tok
