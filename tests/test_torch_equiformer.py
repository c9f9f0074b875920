"""The port's Equiformer-v2 (``repro_torch.models.gnn.equiformer_v2``)
against ``repro.models.gnn.equiformer_v2`` on the same numpy graph, with
the JAX parameters carried over by ``interop.gnn_params_from_jax``: the
output, the loss and every gradient leaf, node-level and graph-level,
with ``truncate_rotation`` off and on, through the plain route and the
kernel route (the kernels' plain versions on the CPU), both packages in
float32; ``edge_bf16`` at a bf16 tolerance; the port's rotation
invariance; and the configs' copies."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equiformer_v2 as j_configs
from repro.models.gnn import common as jcommon
from repro.models.gnn import equiformer_v2 as J
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.configs import equiformer_v2 as configs
from repro_torch.models.gnn import equiformer_v2 as M
from repro_torch.models.gnn.common import GraphBatch

# the loss within rtol 1e-5; the output within rtol 1e-5 / atol 1e-6 and
# each gradient leaf's largest difference within 1e-4 of the leaf's
# largest |value|, both over a floor of 1e-6: the last bias of each
# layer's attention MLP and ``out_proj`` have a gradient of exactly 0 in
# exact arithmetic (a softmax ignores a shift of all its logits; the
# projection is never applied), which both packages give as float32
# rounding noise (<= 1e-8 here)
LOSS_RTOL, OUT_RTOL, GRAD_RTOL, ATOL = 1e-5, 1e-5, 1e-4, 1e-6
# edge_bf16 rounds the per-edge rotate / conv pipeline to bf16 (8 bits of
# mantissa) in both packages, at places that differ in the backward: the
# loss within one bf16 rounding (2^-8) and each gradient leaf within 2^-5
# of its largest |value| (measured here: 2.3e-7 and 1.1e-2; JAX's own bf16
# run lies 8.4e-4 and 7.5e-3 from its float32 one)
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 2 ** -8, 2 ** -5
N_NODES, N_EDGES, N_GRAPHS = 40, 160, 4


def arrays(cfg, seed=0):
    """A batch of 4 graphs of 10 nodes (the last 3 nodes and the last 10
    edges invalid), positions N(0, 1.5^2)."""
    rng = np.random.default_rng(seed)
    n, e = N_NODES, N_EDGES
    return dict(
        x=rng.standard_normal((n, cfg.d_in)).astype(np.float32),
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_valid=np.arange(e) < e - 10, node_valid=np.arange(n) < n - 3,
        graph_id=(np.arange(n) // (n // N_GRAPHS)).astype(np.int32),
        pos=(1.5 * rng.standard_normal((n, 3))).astype(np.float32),
        labels=(rng.standard_normal(N_GRAPHS).astype(np.float32)
                if cfg.graph_level else
                rng.integers(0, cfg.n_classes, n).astype(np.int32)))


def jax_config(graph_level, truncate, bf16=False):
    return dataclasses.replace(
        j_configs.smoke_config(), graph_level=graph_level,
        n_classes=1 if graph_level else 3, truncate_rotation=truncate,
        edge_bf16=bf16)


def port_config(jcfg):
    return M.EquiformerV2Config(**{f.name: getattr(jcfg, f.name)
                                   for f in dataclasses.fields(jcfg)})


@functools.lru_cache(maxsize=None)
def jax_reference(graph_level, truncate, bf16=False):
    """(output, loss, grad leaves) of the JAX model, its params as numpy
    and the batch's arrays."""
    jcfg = jax_config(graph_level, truncate, bf16)
    a = arrays(jcfg)
    jp = J.init_params(jax.random.PRNGKey(0), jcfg)
    jg = jcommon.GraphBatch(**{k: jnp.asarray(v) for k, v in a.items()})
    vg = jax.jit(jax.value_and_grad(
        lambda p, g: (J.loss_fn(p, jcfg, g), J.forward(p, jcfg, g)),
        has_aux=True))
    (loss, out), grads = vg(jp, jg)
    return ((np.asarray(out), float(loss),
             [np.asarray(x) for x in jax.tree.leaves(grads)]),
            jax.tree.map(np.asarray, jp), a)


def port_run(jcfg, jparams, a, impl):
    cfg = port_config(jcfg)
    params = interop.gnn_params_from_jax(jparams, device="cpu")
    g = GraphBatch(**{k: torch.as_tensor(v) for k, v in a.items()}) \
        .with_plan()
    live = [p.detach().requires_grad_() for p in T.leaves(params)]
    loss = M.loss_fn(T.unflatten(params, live), cfg, g, impl)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(p) if gr is None else gr
             for p, gr in zip(live, grads)]
    out = M.forward(params, cfg, g, impl).detach()
    return out, float(loss.detach()), grads, T.flatten_with_paths(params)[0]


def assert_leaves(paths, grads, ref_grads, rtol):
    assert len(grads) == len(ref_grads)
    for path, gr, rg in zip(paths, grads, ref_grads):
        diff = float(np.abs(gr.float().numpy() - rg).max())
        assert diff <= rtol * float(np.abs(rg).max()) + ATOL, (path, diff)


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("truncate", [False, True])
@pytest.mark.parametrize("graph_level", [True, False])
def test_equiformer_matches_jax(graph_level, truncate, impl):
    (ref, ref_loss, ref_grads), jparams, a = jax_reference(graph_level,
                                                           truncate)
    out, loss, grads, paths = port_run(jax_config(graph_level, truncate),
                                       jparams, a, impl)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, rtol=OUT_RTOL, atol=ATOL)
    np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL)
    assert_leaves(paths, grads, ref_grads, GRAD_RTOL)
    # out_proj is never applied: its gradient is 0 in both packages
    for path, gr in zip(paths, grads):
        if "/out_proj/" in path:
            assert not bool(gr.any()), path


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_equiformer_edge_bf16_matches_jax(impl):
    """The registry's ``opt`` variant (truncated rotation, bf16 edge
    pipeline) against JAX's in bf16."""
    (ref, ref_loss, ref_grads), jparams, a = jax_reference(True, True, True)
    out, loss, grads, paths = port_run(jax_config(True, True, True),
                                       jparams, a, impl)
    np.testing.assert_allclose(loss, ref_loss, rtol=BF16_LOSS_RTOL)
    assert_leaves(paths, grads, ref_grads, BF16_GRAD_RTOL)


def test_equiformer_rotation_invariance():
    """The port's node-level logits under a rotation of the positions
    (tests/test_models_gnn.py's config and rotation), on both routes.  The
    graph has no self-loop: a zero edge vector has no frame to rotate."""
    from test_torch_so3 import rotmat
    cfg = M.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=3, m_max=2,
                               n_heads=4, d_in=8, n_classes=4,
                               graph_level=False, n_rbf=8)
    a = arrays(cfg, seed=1)
    loop = a["edge_src"] == a["edge_dst"]
    a["edge_dst"] = np.where(loop, (a["edge_dst"] + 1) % N_NODES,
                             a["edge_dst"]).astype(np.int32)
    gen = torch.Generator().manual_seed(1)
    params = M.init_params(cfg, gen, device="cpu")
    g = GraphBatch(**{k: torch.as_tensor(v) for k, v in a.items()})
    R = torch.as_tensor(rotmat(0.7, 1.2, -0.4).astype(np.float32))
    for impl in ("torch", "cuda"):
        out1 = M.forward(params, cfg, g.with_plan(), impl)
        out2 = M.forward(params, cfg, g._replace(pos=g.pos @ R.T)
                         .with_plan(), impl)
        torch.testing.assert_close(out1, out2, rtol=0, atol=1e-4)


def test_equiformer_config_copies_and_tree():
    """The port's configs equal the JAX package's; ``init_params`` makes the
    JAX tree (leaf paths and shapes)."""
    for name in ("full_config", "smoke_config"):
        assert dataclasses.asdict(getattr(configs, name)()) == \
            dataclasses.asdict(getattr(j_configs, name)())
    assert dataclasses.asdict(configs.full_config(64, 1, True)) == \
        dataclasses.asdict(j_configs.full_config(64, 1, True))
    assert (configs.FAMILY, configs.MODULE, configs.NEEDS_POS) == \
        (j_configs.FAMILY, j_configs.MODULE, j_configs.NEEDS_POS)
    jcfg = j_configs.smoke_config()
    jtree = J.init_params(jax.random.PRNGKey(0), jcfg)
    tree = M.init_params(port_config(jcfg), torch.Generator(), device="cpu")
    jpaths = ["/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                       for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    paths, leaves = T.flatten_with_paths(tree)
    assert paths == jpaths
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(x.shape) for x in jax.tree.leaves(jtree)]
