"""The port's optimizer (``repro_torch.optim``) against ``repro.optim`` on
the same parameter trees and gradients: AdamW with float32 and with 8-bit
moments (the int8 codes bit for bit), the global-norm clip and the
warmup-cosine schedule."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import clip_by_global_norm as jclip
from repro.optim import warmup_cosine as jwarmup
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.optim import (AdamWConfig, QTensor, adamw_update,
                               clip_by_global_norm, global_norm,
                               init_opt_state, warmup_cosine)

RTOL = 1e-6


def trees(seed=0):
    """A GNN-shaped parameter tree (dicts, lists, a 0-d leaf) and three
    gradient trees of its shape, as numpy."""
    rng = np.random.default_rng(seed)

    def f32(*shape, scale=1.0):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    params = {"layers": [{"mlp": [{"w": f32(8, 16), "b": f32(16)},
                                  {"w": f32(16, 16), "b": f32(16)}],
                          "eps": f32()}],
              "head": [{"w": f32(16, 3), "b": f32(3)}]}
    grads = [jax.tree.map(lambda p, s=s: f32(*p.shape, scale=s), params)
             for s in (0.1, 2.0, 1e-3)]
    return params, grads


def to_torch(tree):
    return interop.gnn_params_from_jax(tree, device="cpu")


def assert_tree_close(got, ref, rtol=RTOL, atol=0.0):
    got_leaves, ref_leaves = T.leaves(got), jax.tree.leaves(ref)
    assert len(got_leaves) == len(ref_leaves)
    for g, r in zip(got_leaves, ref_leaves):
        r = np.asarray(r)
        assert g.shape == r.shape and interop.to_numpy(g).dtype == r.dtype
        if r.dtype.kind in "iu":
            np.testing.assert_array_equal(interop.to_numpy(g), r)
        else:
            np.testing.assert_allclose(interop.to_numpy(g), r, rtol=rtol,
                                       atol=atol)


@pytest.mark.parametrize("quantized", [False, True])
def test_adamw_three_updates_match_jax(quantized):
    """Params, moments and step after 3 updates (a schedule scale on the
    last); the 8-bit state's codes and scales bit for bit."""
    params, grads = trees()
    jcfg = jadamw.AdamWConfig(lr=1e-2, quantized_state=quantized)
    cfg = AdamWConfig(lr=1e-2, quantized_state=quantized)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jadamw.init_opt_state(jp, jcfg)
    tp = to_torch(params)
    state = init_opt_state(tp, cfg)
    assert_tree_close(state, jstate)
    for i, gr in enumerate(grads):
        scale = 0.5 if i == 2 else 1.0
        jp, jstate = jadamw.adamw_update(jp, jax.tree.map(jnp.asarray, gr),
                                         jstate, jcfg, scale)
        tp, state = adamw_update(tp, to_torch(gr), state, cfg,
                                 torch.tensor(scale))
    assert_tree_close(tp, jp)
    assert int(state["step"]) == int(jstate["step"]) == 3
    if quantized:
        for got, ref in zip(T.leaves(state["m"]) + T.leaves(state["v"]),
                            jax.tree.leaves(jstate["m"])
                            + jax.tree.leaves(jstate["v"])):
            np.testing.assert_array_equal(interop.to_numpy(got),
                                          np.asarray(ref))
        m0 = state["m"]["head"][0]["w"]
        assert isinstance(m0, QTensor) and m0.qcodes.dtype == torch.int8
        assert m0.qcodes.shape == (512, 256)      # padded to QBLOCK * 512
    else:
        assert_tree_close(state["m"], jstate["m"])
        assert_tree_close(state["v"], jstate["v"])


def test_quantize_rounds_half_to_even():
    """Codes of exact halves round to even, as jnp.round does."""
    x = np.zeros(256 * 512, np.float32)
    x[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]     # scale 1: codes = x
    ref_codes, ref_scale = jadamw._quantize(jnp.asarray(x))
    from repro_torch.optim.adamw import _quantize
    codes, scale = _quantize(torch.as_tensor(x))
    np.testing.assert_array_equal(codes.numpy(), np.asarray(ref_codes))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(ref_scale))
    assert codes[0, :6].tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_by_global_norm_matches_jax(max_norm):
    _, grads = trees(1)
    ref, ref_n = jclip(jax.tree.map(jnp.asarray, grads[1]), max_norm)
    got, n = clip_by_global_norm(to_torch(grads[1]), max_norm)
    np.testing.assert_allclose(float(n), float(ref_n), rtol=RTOL)
    np.testing.assert_allclose(float(global_norm(to_torch(grads[1]))),
                               float(ref_n), rtol=RTOL)
    assert_tree_close(got, ref)


def test_warmup_cosine_matches_jax():
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        ref = jwarmup(step, warmup_steps=10, total_steps=100)
        got = warmup_cosine(torch.tensor(step, dtype=torch.int32),
                            warmup_steps=10, total_steps=100)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(ref), rtol=RTOL)
    # warmup longer than the run (the 5-step training in chip_smoke.py)
    for step in range(5):
        np.testing.assert_allclose(
            float(warmup_cosine(step, warmup_steps=10, total_steps=5)),
            float(jwarmup(step, warmup_steps=10, total_steps=5)), rtol=RTOL)
