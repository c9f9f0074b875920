"""LM training in the port against the JAX package, float32 smoke configs:
``loss_fn`` and every gradient leaf for the five LM archs on both MoE
routes (JAX's gradients carried over by ``interop.lm_params_from_jax``),
masked labels, three ``launch/train.py`` steps against the JAX driver's
step on its own smoke problem, ``main`` for every LM arch with a failure
recovered, and ``flash_attention`` refusing to run under autograd."""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.models.transformer import model as JM
from repro.optim import (AdamWConfig as JAdamWConfig, adamw_update as jadamw,
                         clip_by_global_norm as jclip,
                         init_opt_state as jinit, warmup_cosine as jwarmup)
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train
from repro_torch.models.transformer import model as M
from repro_torch.optim import AdamWConfig, init_opt_state

from torch_parity import lm_config, t

LM_ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "gemma2-27b",
            "qwen1.5-4b", "gemma3-27b"]
JAX_CONFIGS = {
    "qwen3-moe-30b-a3b": "repro.configs.qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "repro.configs.kimi_k2_1t_a32b",
    "gemma2-27b": "repro.configs.gemma2_27b",
    "qwen1.5-4b": "repro.configs.qwen1_5_4b",
    "gemma3-27b": "repro.configs.gemma3_27b",
}
# float32 through 2-7 layers, sums in another order than XLA's: the loss
# relative; gradients relative with a floor set from each leaf's largest
# value (elements near 0)
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-5, 1e-4, 1e-5
BATCH, SEQ = 2, 16
STEPS = 3


def close(got, ref, rtol, atol_of_max, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(interop.to_numpy(got), ref, rtol=rtol,
                               atol=atol_of_max * float(np.abs(ref).max()),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch):
    """The JAX smoke config's params, a batch with a masked label, and JAX's
    loss and gradients on it, as numpy."""
    jcfg = importlib.import_module(JAX_CONFIGS[arch]).smoke_config()
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, jcfg.vocab, (BATCH, SEQ)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JM.loss_fn(p, jcfg, jnp.asarray(toks),
                             jnp.asarray(labels))))(params)
    return (jcfg, jax.tree.map(np.asarray, params), toks, labels,
            float(loss), jax.tree.map(np.asarray, grads))


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("arch", LM_ARCHS)
def test_loss_and_grads_match_jax(arch, impl):
    jcfg, jparams, toks, labels, ref_loss, jgrads = jax_loss_and_grads(arch)
    cfg = lm_config(jcfg)
    assert cfg == importlib.import_module(
        train.ARCH_MODULES[arch]).smoke_config()
    params = interop.lm_params_from_jax(jparams, device="cpu")
    ref = interop.lm_params_from_jax(jgrads, device="cpu")
    loss, grads = train.value_and_grad(
        lambda p, b: M.loss_fn(p, cfg, b[0], b[1], impl))(
            params, (t(toks), t(labels)))
    assert abs(float(loss) - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    paths, ref_leaves = T.flatten_with_paths(ref)
    got = T.leaves(grads)
    assert len(got) == len(ref_leaves)
    for path, g, r in zip(paths, got, ref_leaves):
        close(g, r, GRAD_RTOL, GRAD_ATOL_OF_MAX, path)


def test_masked_labels():
    """Labels < 0 add nothing: the loss over a batch with masked positions
    is JAX's and equals the loss over the kept positions alone."""
    jcfg, jparams, toks, labels, ref_loss, _ = jax_loss_and_grads(
        "qwen3-moe-30b-a3b")
    cfg = lm_config(jcfg)
    params = interop.lm_params_from_jax(jparams, device="cpu")
    labels = labels.copy()
    labels[0, :5] = -1
    got = M.loss_fn(params, cfg, t(toks), t(labels), "torch")
    ref = jax.jit(lambda p: JM.loss_fn(p, jcfg, jnp.asarray(toks),
                                       jnp.asarray(labels)))(jparams)
    assert abs(float(got) - float(ref)) <= LOSS_RTOL * abs(float(ref))
    logits, aux = M.forward(params, cfg, t(toks), "torch")
    keep = torch.tensor(labels >= 0)
    nll = torch.nn.functional.cross_entropy(
        logits[keep], t(labels)[keep].long())
    torch.testing.assert_close(got, nll + 0.01 * aux)
    all_masked = M.loss_fn(params, cfg, t(toks),
                           torch.full_like(t(labels), -1), "torch")
    torch.testing.assert_close(all_masked, 0.01 * aux)


@functools.lru_cache(maxsize=None)
def jax_steps():
    """Three steps of the JAX driver's step on its qwen3-moe smoke problem:
    losses, the final params, the params and batches at the start."""
    _, params, loss_fn, batches = jtrain.build_smoke_problem(
        "qwen3-moe-30b-a3b", BATCH)
    opt_cfg = JAdamWConfig(lr=1e-3)

    @jax.jit
    def step_fn(state, batch):
        p, opt_state = state
        lval, grads = jax.value_and_grad(loss_fn)(p, batch)
        grads, _ = jclip(grads, 1.0)
        lr_scale = jwarmup(opt_state["step"], warmup_steps=10,
                           total_steps=STEPS)
        p, opt_state = jadamw(p, grads, opt_state, opt_cfg, lr_scale)
        return (p, opt_state), lval

    state, losses = (params, jinit(params, opt_cfg)), []
    for s in range(STEPS):
        state, lval = step_fn(state, batches(s))
        losses.append(float(lval))
    return (jax.tree.map(np.asarray, params), losses,
            jax.tree.map(np.asarray, state[0]),
            [jax.tree.map(np.asarray, batches(s)) for s in range(STEPS)])


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_make_step_matches_jax_step(impl):
    """launch/train.py's step (clip, warmup-cosine, AdamW) from JAX's
    params on JAX's batches: three losses and the final params."""
    jparams, ref_losses, ref_params, batches = jax_steps()
    cfg = importlib.import_module(
        train.ARCH_MODULES["qwen3-moe-30b-a3b"]).smoke_config()
    params = interop.lm_params_from_jax(jparams, device="cpu")
    opt_cfg = AdamWConfig(lr=1e-3)
    step_fn = train.make_step(
        lambda p, b: M.loss_fn(p, cfg, b[0], b[1], impl), opt_cfg, STEPS)
    state, losses = (params, init_opt_state(params, opt_cfg)), []
    for toks, labels in batches:
        state, metrics = step_fn(state, (t(toks), t(labels)))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref_losses, rtol=LOSS_RTOL)
    ref = interop.lm_params_from_jax(ref_params, device="cpu")
    for path, r, g in zip(*T.flatten_with_paths(ref), T.leaves(state[0])):
        close(g, r, GRAD_RTOL, GRAD_ATOL_OF_MAX, path)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_main_trains_every_lm_arch(tmp_path, capsys, arch):
    """``main`` at the smoke config on the host, one failure recovered from
    the step-5 checkpoint; it raises unless the loss falls."""
    train.main(["--arch", arch, "--device", "cpu", "--steps", "12",
                "--fail-at", "7", "--ckpt-every", "5", "--ckpt-dir",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out and "recovered=1 ckpts=2" in out


def test_flash_attention_refuses_autograd():
    """The flash kernels have no backward: a call with a q, k or v that asks
    for a gradient raises (whatever the device), and the LM forward with
    impl="cuda" under autograd with it; under no_grad it runs."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 2, 8, 16, generator=g) for _ in range(3))
    for needs in (q, k, v):
        needs.requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            flash_ops.flash_attention(q, k, v, scale=0.25)
        with torch.no_grad():
            flash_ops.flash_attention(q, k, v, scale=0.25)
        needs.requires_grad_(False)
    cfg = importlib.import_module(
        train.ARCH_MODULES["gemma2-27b"]).smoke_config()
    params = M.init_params(cfg, 0, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.int32)
    params["embed"].requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        M.forward(params, cfg, toks, impl="cuda")
    assert M.loss_fn(params, cfg, toks, toks, "cuda").requires_grad
