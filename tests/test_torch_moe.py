"""The port's MoE layer (``apply_moe``, both routes) against the JAX
package's ``apply_moe`` on the same numpy inputs, float32: output, aux loss
and the gradient of every parameter leaf and of the input; the keep mask and
the slots bit for bit JAX's stable sort's, on a router that overflows one
expert; the kernel route's plan against the plain layout."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import layers as JL
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.models.transformer import layers as L

from torch_parity import lm_config

# float32 sums of a few products in another order: relative, with a floor
# for elements near 0 set from the leaf's largest value
RTOL, ATOL_OF_MAX = 1e-5, 1e-6
B, S, D, E, K, F = 2, 16, 32, 8, 2, 16

CASES = {
    # T K / E x 1.25 + 1 = 11 slots an expert for 8 lanes on average
    "drops": dict(capacity_factor=1.25),
    "dropless": dict(capacity_factor=8.0),
    "shared": dict(capacity_factor=1.25, n_shared_experts=1),
    # expert 3's logit raised by 6 for every token: it overflows its 11
    # slots
    "overflow": dict(capacity_factor=1.25),
}


def jax_cfg(case):
    return JL.LMConfig(name=f"moe-{case}", n_layers=1, d_model=D, n_heads=4,
                       n_kv_heads=2, d_ff=F, vocab=64, moe=True, n_experts=E,
                       top_k=K, dtype=jnp.float32, **CASES[case])


@functools.lru_cache(maxsize=None)
def problem(case):
    """(JAX cfg, params and input as numpy, the output's weights)."""
    jcfg = jax_cfg(case)
    params = jax.tree.map(np.asarray,
                          JL.init_moe(jax.random.PRNGKey(7), jcfg))
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    if case == "overflow":
        x[..., 0] = 2.0
        params["router"] = params["router"].copy()
        params["router"][0, 3] = 3.0
    w = rng.standard_normal((B, S, D)).astype(np.float32)
    return jcfg, params, x, w


@functools.lru_cache(maxsize=None)
def jax_reference(case):
    """JAX's (y, aux) and the gradients of sum(y * w) + 3 aux by (params,
    x), as numpy."""
    jcfg, params, x, w = problem(case)

    def objective(p, xx):
        y, aux = JL.apply_moe(p, jcfg, xx)
        return jnp.sum(y * w) + 3.0 * aux, (y, aux)

    (_, (y, aux)), grads = jax.jit(jax.value_and_grad(
        objective, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return (np.asarray(y), float(aux),
            jax.tree.map(np.asarray, grads[0]), np.asarray(grads[1]))


def jax_layout(case):
    """JAX's keep mask and slots in expert order (``layers.py``'s sorted
    dispatch, on JAX's own routing)."""
    jcfg, params, x, _ = problem(case)
    T = B * S
    C = min(T, int(T * K / E * jcfg.capacity_factor) + 1)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(T, D) @ params["router"],
                           axis=-1)
    _, eidx = jax.lax.top_k(probs, K)
    flat_e = eidx.reshape(-1)
    se = flat_e[jnp.argsort(flat_e)]
    estart = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(jnp.bincount(se, length=E))[:-1]
                              .astype(jnp.int32)])
    rank = jnp.arange(T * K, dtype=jnp.int32) - estart[se]
    keep = rank < C
    return np.asarray(keep), np.asarray(jnp.where(keep, se * C + rank,
                                                   E * C))


def port_run(case, impl):
    """The port's (y, aux, params' gradients, x's gradient)."""
    jcfg, params, x, w = problem(case)
    cfg = lm_config(jcfg)
    p = interop.sasrec_params_from_jax(params, device="cpu")
    leaves = [t.requires_grad_() for t in T.leaves(p)]
    xt = torch.tensor(x, requires_grad=True)
    y, aux = L.apply_moe(T.unflatten(p, leaves), cfg, xt, impl)
    (y * torch.tensor(w)).sum().add(3.0 * aux).backward()
    return y.detach(), aux.detach(), T.unflatten(
        p, [t.grad for t in leaves]), xt.grad


def close(got, ref, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(interop.to_numpy(got), ref, rtol=RTOL,
                               atol=ATOL_OF_MAX * float(np.abs(ref).max()),
                               err_msg=what)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_apply_moe_matches_jax(case, impl):
    y_ref, aux_ref, g_ref, gx_ref = jax_reference(case)
    y, aux, grads, gx = port_run(case, impl)
    close(y, y_ref, "y")
    assert abs(float(aux) - aux_ref) <= RTOL * abs(aux_ref)
    paths, ref_leaves = T.flatten_with_paths(g_ref)
    got_leaves = T.leaves(grads)
    assert len(got_leaves) == len(ref_leaves) == (
        7 if CASES[case].get("n_shared_experts") else 4)
    for path, g, r in zip(paths, got_leaves, ref_leaves):
        close(g, r, f"grad {path}")
    close(gx, gx_ref, "grad x")


@pytest.mark.parametrize("case", list(CASES))
def test_keep_and_slots_match_jax_stable_sort(case):
    """The plan's keep mask and slots (expert order) bit for bit JAX's; the
    overflowing router drops lanes, so an unstable sort would show."""
    jcfg, params, x, _ = problem(case)
    cfg = lm_config(jcfg)
    T_ = B * S
    gate, eidx, _ = L.route({"router": torch.tensor(params["router"])}, cfg,
                            torch.tensor(x).reshape(T_, D))
    plan = L.token_plan(eidx, L.capacity(cfg, T_), E)
    keep, slot = jax_layout(case)
    np.testing.assert_array_equal(plan.keep.numpy(), keep)
    np.testing.assert_array_equal(plan.slot.numpy(), slot.astype(np.int32))
    if case == "overflow":
        assert int((eidx == 3).sum()) > plan.C and not plan.keep.all()
    # the kernels' maps: every kept lane's slot holds its token, every
    # other slot the zero row, every dropped lane reads the zero row
    lanes = torch.arange(T_ * K)
    kept = plan.slot_of_lane < E * plan.C
    assert int(kept.sum()) == int(plan.keep.sum())
    np.testing.assert_array_equal(
        plan.tok_of_slot[plan.slot_of_lane[kept].long()].numpy(),
        (lanes[kept] // K).numpy())
    assert int((plan.tok_of_slot == T_).sum()) == E * plan.C - int(kept.sum())
    np.testing.assert_array_equal(plan.row_ptr.numpy(),
                                  np.arange(T_ + 1) * K)


def test_moe_module_and_layer_views():
    """``MoE`` returns the function's (y, aux); a ``DecoderLayer`` over a MoE
    layer's dict takes it in place of the MLP."""
    from repro_torch.models.transformer import model as M
    jcfg, params, x, _ = problem("shared")
    cfg = lm_config(jcfg)
    p = interop.sasrec_params_from_jax(params, device="cpu")
    xt = torch.tensor(x)
    y, aux = L.MoE(cfg, p)(xt, "torch")
    y_ref, aux_ref = L.apply_moe(p, cfg, xt, "torch")
    torch.testing.assert_close(y, y_ref)
    assert float(aux) == float(aux_ref)
    lcfg = lm_config(JL.LMConfig(**{**jcfg.__dict__, "n_layers": 2}))
    lp = M.init_params(lcfg, 0, device="cpu")["layers"][0]
    layer = L.DecoderLayer(lcfg, lp, 0)
    assert hasattr(layer, "moe") and not hasattr(layer, "mlp")
    pos = torch.arange(S)[None].expand(B, S)
    torch.testing.assert_close(layer(xt, pos, "torch"), L.apply_layer(
        lp, lcfg, xt, pos, 0, "torch")[0])
