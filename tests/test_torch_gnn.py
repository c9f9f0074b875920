"""The port's GNN layer (``repro_torch.models.gnn``) against the JAX
package's on the same inputs: the scatter primitives, the edge plan's
gather and aggregation, and GIN, PNA and EGNN (forward and every gradient
leaf) at their smoke configs and at the sizes of tests/test_models_gnn.py,
through the plain route and the kernel route (the kernels' plain versions
on the CPU), with the JAX parameters carried over by
``interop.gnn_params_from_jax``."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import rmat_edges
from repro.models.gnn import common as jcommon
from repro.models.gnn import egnn as jegnn
from repro.models.gnn import gin as jgin
from repro.models.gnn import pna as jpna
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.models.gnn import common, egnn, gin, pna
from repro_torch.models.gnn.common import GraphBatch

# atol in units of the compared tensor's largest |value| (at least 1):
# both packages' float32 results lie up to ~1e-4 (relative, elementwise)
# from the float64 result where a logit or gradient cancels, so an
# absolute floor of 1e-6 is only meaningful for outputs of order 1
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
IMPLS = ("torch", "cuda")


def arrays(n, e, f, seed, n_classes=4, invalid=10, rmat=False):
    """numpy inputs of one batch: random endpoints (repeats and empty rows
    included) or an RMAT graph, the last ``invalid`` lanes invalid."""
    rng = np.random.default_rng(seed)
    if rmat:
        src, dst = rmat_edges(n, e, seed=seed)
        e = len(src)
    else:
        src = rng.integers(0, n, e).astype(np.int32)
        dst = rng.integers(0, n, e).astype(np.int32)
    valid = np.ones(e, bool)
    if invalid:
        valid[-invalid:] = False
    return dict(x=rng.standard_normal((n, f)).astype(np.float32),
                edge_src=np.asarray(src, np.int32),
                edge_dst=np.asarray(dst, np.int32), edge_valid=valid,
                node_valid=np.ones(n, bool),
                graph_id=np.zeros(n, np.int32),
                pos=rng.standard_normal((n, 3)).astype(np.float32),
                labels=rng.integers(0, n_classes, n).astype(np.int32))


def jax_batch(a):
    return jcommon.GraphBatch(**{k: jnp.asarray(v) for k, v in a.items()})


def torch_batch(a):
    return GraphBatch(**{k: torch.as_tensor(v) for k, v in a.items()}) \
        .with_plan()


def close(got, ref, rtol, atol, what=""):
    ref = np.asarray(ref)
    scale = max(1.0, float(np.abs(ref).max())) if ref.size else 1.0
    np.testing.assert_allclose(interop.to_numpy(got) / scale, ref / scale,
                               rtol=rtol, atol=atol, err_msg=what)


def grads_of(fn, *tensors):
    live = [t.detach().clone().requires_grad_() for t in tensors]
    out = fn(*live)
    return out, torch.autograd.grad(out, live, allow_unused=True)


# ---------------------------------------------------------------------------
# scatter primitives and the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("op", ["sum", "mean", "max", "min"])
def test_scatter_matches_jax(op, impl):
    """Invalid lanes, empty rows and repeated (tied) messages; the value
    and the gradient of a weighted sum of it."""
    n, e, f = 30, 200, 5
    a = arrays(n, e, f, seed=1, invalid=20)
    rng = np.random.default_rng(2)
    msg = rng.standard_normal((e, f)).astype(np.float32)
    # a tied maximum and a tied minimum of one row: the gradient is shared
    msg[50] = msg[51] = 9.0
    msg[60] = msg[61] = -9.0
    a["edge_dst"][[51, 60, 61]] = a["edge_dst"][50]
    w = rng.standard_normal((n, f)).astype(np.float32)
    dst, valid = a["edge_dst"], a["edge_valid"]
    jfn = {"sum": lambda m: jcommon.scatter_sum(m, dst, valid, n),
           "mean": lambda m: jcommon.scatter_mean(m, dst, valid, n),
           "max": lambda m: jcommon.scatter_max(m, dst, valid, n),
           "min": lambda m: jcommon.scatter_min(m, dst, valid, n)}[op]
    ref = jfn(jnp.asarray(msg))
    ref_g = jax.grad(lambda m: jnp.sum(jfn(m) * w))(jnp.asarray(msg))
    tdst, tvalid = torch.as_tensor(dst), torch.as_tensor(valid)
    tfn = {"sum": lambda m: common.scatter_sum(m, tdst, tvalid, n, impl),
           "mean": lambda m: common.scatter_mean(m, tdst, tvalid, n, impl),
           "max": lambda m: common.scatter_max(m, tdst, tvalid, n),
           "min": lambda m: common.scatter_min(m, tdst, tvalid, n)}[op]
    got, (got_g,) = grads_of(lambda m: (tfn(m) * torch.as_tensor(w)).sum(),
                             torch.as_tensor(msg))
    close(tfn(torch.as_tensor(msg)), ref, FWD_RTOL, FWD_ATOL)
    close(got_g, ref_g, GRAD_RTOL, GRAD_ATOL)
    assert np.asarray(ref_g)[~valid].max() == 0
    if op in ("max", "min"):                   # half to each of the tie
        lanes = [50, 51] if op == "max" else [60, 61]
        np.testing.assert_allclose(interop.to_numpy(got_g)[lanes],
                                   0.5 * w[[a["edge_dst"][50]] * 2])


@pytest.mark.parametrize("impl", IMPLS)
def test_aggregate_and_gathers_match_jax(impl):
    """scatter_sum(h[src], dst) as one function, and h[src] / h[dst] in
    edge order, each with its gradient, against JAX on the same lanes."""
    n, e, f = 40, 300, 6
    a = arrays(n, e, f, seed=3, invalid=25)
    w_n = np.random.default_rng(4).standard_normal((n, f)).astype(np.float32)
    w_e = np.random.default_rng(5).standard_normal((e, f)).astype(np.float32)
    src, dst, valid = a["edge_src"], a["edge_dst"], a["edge_valid"]
    h = jnp.asarray(a["x"])
    g = torch_batch(a)
    ref = jcommon.scatter_sum(h[src], dst, valid, n)
    ref_g = jax.grad(lambda x: jnp.sum(
        jcommon.scatter_sum(x[src], dst, valid, n) * w_n))(h)
    got, (got_g,) = grads_of(lambda x: (common.aggregate(x, g, impl)
                                        * torch.as_tensor(w_n)).sum(), g.x)
    close(common.aggregate(g.x, g, impl), ref, FWD_RTOL, FWD_ATOL)
    close(got_g, ref_g, GRAD_RTOL, GRAD_ATOL)
    # edge-order gathers: a valid lane's gradient reaches its node (every
    # model masks the invalid lanes before any sum)
    for side, ids in (("src", src), ("dst", dst)):
        close(common.gather(g.x, g, side, impl), np.asarray(h)[ids], 0, 0)
        ref_g = jax.grad(lambda x: jnp.sum(
            jnp.where(valid[:, None], x[ids], 0.0) * w_e))(h)
        _, (got_g,) = grads_of(lambda x: (common.gather(x, g, side, impl)
                                          * torch.as_tensor(w_e)
                                          * g.edge_valid[:, None]).sum(),
                               g.x)
        close(got_g, ref_g, GRAD_RTOL, GRAD_ATOL, side)


def test_edge_plan_layout_and_degrees():
    """The plan's orders are stable sorts of the valid lanes; in-degrees
    equal JAX's ``in_degree``; a plan refuses another batch's edges and a
    valid lane with a source outside the nodes."""
    a = arrays(50, 400, 3, seed=6, invalid=40)
    g = torch_batch(a)
    p = g.plan
    lanes = np.flatnonzero(a["edge_valid"])
    np.testing.assert_array_equal(
        p.dst_order.numpy(), lanes[np.argsort(a["edge_dst"][lanes],
                                              kind="stable")])
    np.testing.assert_array_equal(
        p.src_order.numpy(), lanes[np.argsort(a["edge_src"][lanes],
                                              kind="stable")])
    np.testing.assert_array_equal(p.src_by_dst.numpy(),
                                  a["edge_src"][p.dst_order.numpy()])
    np.testing.assert_array_equal(p.dst_by_src.numpy(),
                                  a["edge_dst"][p.src_order.numpy()])
    ref = jcommon.in_degree(jax_batch(a))
    for impl in IMPLS:
        close(common.in_degree(g, impl), ref, 0, 0)
    other = g._replace(edge_dst=g.edge_dst.clone())
    with pytest.raises(ValueError, match="another batch"):
        common.aggregate(other.x, other, "cuda", g.plan)
    bad = g._replace(edge_src=torch.where(g.edge_valid, 99, g.edge_src)
                     .to(torch.int32), plan=None)
    with pytest.raises(ValueError, match="outside"):
        bad.with_plan()


def test_segment_softmax_matches_jax():
    n, e = 20, 120
    a = arrays(n, e, 1, seed=7, invalid=15)
    s = np.random.default_rng(8).standard_normal(e).astype(np.float32)
    ref = jcommon.segment_softmax(jnp.asarray(s), a["edge_dst"],
                                  a["edge_valid"], n)
    got = common.segment_softmax(torch.as_tensor(s),
                                 torch.as_tensor(a["edge_dst"]),
                                 torch.as_tensor(a["edge_valid"]), n)
    close(got, ref, FWD_RTOL, FWD_ATOL)


def test_segment_softmax_heads_match_jax_vmap():
    """[E, H] scores, one softmax a head, against JAX's ``vmap`` over heads
    (as Equiformer-v2 calls it), with the gradient of a weighted sum."""
    n, e, H = 20, 120, 4
    a = arrays(n, e, 1, seed=9, invalid=15)
    rng = np.random.default_rng(10)
    s = rng.standard_normal((e, H)).astype(np.float32)
    w = rng.standard_normal((e, H)).astype(np.float32)
    dst, valid = a["edge_dst"], a["edge_valid"]

    def jfn(x):
        return jax.vmap(lambda c: jcommon.segment_softmax(c, dst, valid, n),
                        in_axes=1, out_axes=1)(x)

    ref = jfn(jnp.asarray(s))
    ref_g = jax.grad(lambda x: jnp.sum(jfn(x) * w))(jnp.asarray(s))
    tdst, tvalid = torch.as_tensor(dst), torch.as_tensor(valid)
    got, (got_g,) = grads_of(lambda x: (common.segment_softmax(
        x, tdst, tvalid, n) * torch.as_tensor(w)).sum(), torch.as_tensor(s))
    close(common.segment_softmax(torch.as_tensor(s), tdst, tvalid, n), ref,
          FWD_RTOL, FWD_ATOL)
    close(got_g, ref_g, GRAD_RTOL, GRAD_ATOL)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

MODELS = {"gin": (jgin, gin), "pna": (jpna, pna), "egnn": (jegnn, egnn)}
# tests/test_models_gnn.py: N, E, F = 40, 120, 16, the last 10 lanes
# invalid, its configs; the smoke configs on the train driver's RMAT graph
SIZES = {
    "test_models_gnn": dict(n=40, e=120, f=16, invalid=10, rmat=False,
                            cfg={"gin": dict(d_in=16, d_hidden=32,
                                             n_classes=4),
                                 "pna": dict(d_in=16, d_hidden=24,
                                             n_classes=4),
                                 "egnn": dict(d_in=16, d_hidden=32,
                                              n_classes=4)}),
    "smoke": dict(n=256, e=1024, f=8, invalid=0, rmat=True, cfg=None),
}
# Where the float32 kernel route is held element by element.  PNA's std
# (the sqrt of a cancelling variance, with a kink at 0) and, at the
# test_models_gnn size, EGNN's position updates leave both packages'
# float32 logits and gradients up to 1e-4 (logits) and 20x the gradient
# tolerance (gradients) from the float64 result, element by element, and
# the kernel route sums in another order than JAX.  There the plain route
# is held element by element in float64 and the kernel route tensor by
# tensor in norm (relative to the reference's norm), and element by
# element against the port's own float32 plain route.
F32_ELEMENTWISE = {("gin", "test_models_gnn"), ("gin", "smoke"),
                   ("egnn", "smoke")}


def close_norm(got, ref, rtol, atol, what=""):
    ref = np.asarray(ref)
    err = np.linalg.norm(interop.to_numpy(got) - ref)
    assert err <= rtol * np.linalg.norm(ref) + atol * np.sqrt(ref.size), \
        (what, err, np.linalg.norm(ref))


def model_case(name, size):
    jmod, tmod = MODELS[name]
    s = SIZES[size]
    if s["cfg"] is None:
        from repro.configs import egnn as c_e, gin_tu as c_g, pna as c_p
        jcfg = {"gin": c_g, "pna": c_p, "egnn": c_e}[name].smoke_config()
    else:
        jcfg = {"gin": jgin.GINConfig, "pna": jpna.PNAConfig,
                "egnn": jegnn.EGNNConfig}[name](**s["cfg"][name])
    tcfg = {"gin": gin.GINConfig, "pna": pna.PNAConfig,
            "egnn": egnn.EGNNConfig}[name](**{
                k: getattr(jcfg, k) for k in jcfg.__dataclass_fields__})
    a = arrays(s["n"], s["e"], jcfg.d_in, seed=11, n_classes=jcfg.n_classes,
               invalid=s["invalid"], rmat=s["rmat"])
    jparams = jmod.init_params(jax.random.PRNGKey(0), jcfg)
    return jmod, tmod, jcfg, tcfg, a, jparams


def _as(tree, dtype):
    return jax.tree.map(
        lambda v: np.asarray(v, dtype) if np.asarray(v).dtype.kind == "f"
        else np.asarray(v), tree)


@functools.lru_cache(maxsize=None)
def jax_reference(name, size, dtype):
    """(logits, loss, grad leaves) of the JAX model (``impl="xla"``) in
    ``dtype``, and the case's inputs in it."""
    jmod, tmod, jcfg, tcfg, a, jparams = model_case(name, size)
    a, jparams = _as(a, dtype), _as(jparams, dtype)
    with jax.enable_x64(dtype == "float64"):
        jg = jax_batch(a)
        jp = jax.tree.map(jnp.asarray, jparams)
        vg = jax.jit(jax.value_and_grad(
            lambda p, g: (jmod.loss_fn(p, jcfg, g), jmod.forward(p, jcfg, g)),
            has_aux=True))                     # one compile for both
        (loss, logits), grads = vg(jp, jg)
        out = (np.asarray(logits), np.asarray(loss),
               [np.asarray(x) for x in jax.tree.leaves(grads)])
    return out, tcfg, a, jparams


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("name", list(MODELS))
def test_model_matches_jax(name, size, impl):
    """Forward within rtol 1e-5 / atol 1e-6 and every gradient leaf within
    rtol 1e-4 / atol 1e-6 of the JAX model's, both packages in float32;
    where float32 is ill-conditioned (not in ``F32_ELEMENTWISE``) the plain
    route in float64 and the kernel route (float32 only) in norm."""
    well = (name, size) in F32_ELEMENTWISE
    dtype = "float64" if impl == "torch" and not well else "float32"
    (ref, ref_loss, ref_grads), tcfg, a, jparams = jax_reference(
        name, size, dtype)
    cmp = close if well or dtype == "float64" else close_norm
    tmod = MODELS[name][1]
    params = interop.gnn_params_from_jax(jparams, device="cpu")
    g = torch_batch(a)
    cmp(tmod.forward(params, tcfg, g, impl), ref, FWD_RTOL, FWD_ATOL)
    loss, grads = grads_of(
        lambda *ps: tmod.loss_fn(T.unflatten(params, ps), tcfg, g, impl),
        *T.leaves(params))
    close(loss.detach(), ref_loss, FWD_RTOL, FWD_ATOL)
    paths, _ = T.flatten_with_paths(params)
    assert len(ref_grads) == len(grads)
    for path, gr, rg in zip(paths, grads, ref_grads):
        gr = torch.zeros(rg.shape) if gr is None else gr   # unreached leaf
        cmp(gr, rg, GRAD_RTOL, GRAD_ATOL, path)


@pytest.mark.parametrize("name,size", sorted(
    {(n, s) for n in MODELS for s in SIZES} - F32_ELEMENTWISE))
def test_kernel_route_matches_plain_route_elementwise(name, size):
    """Where the float32 kernel route is held against JAX only in norm, it
    is held element by element against the port's own float32 plain route
    on the same inputs: the forward within rtol 1e-5 / atol 1e-6 and every
    gradient leaf within rtol 1e-4 / atol 1e-6."""
    _, tmod, _, tcfg, a, jparams = model_case(name, size)
    params = interop.gnn_params_from_jax(jparams, device="cpu")
    g = torch_batch(a)
    out = {}
    for impl in IMPLS:
        logits = tmod.forward(params, tcfg, g, impl)
        loss, grads = grads_of(
            lambda *ps: tmod.loss_fn(T.unflatten(params, ps), tcfg, g, impl),
            *T.leaves(params))
        out[impl] = (logits, loss.detach(), grads)
    (ref, ref_loss, ref_grads), (got, loss, grads) = out["torch"], out["cuda"]
    close(got, ref, FWD_RTOL, FWD_ATOL)
    close(loss, ref_loss, FWD_RTOL, FWD_ATOL)
    paths, _ = T.flatten_with_paths(params)
    for path, gr, rg in zip(paths, grads, ref_grads):
        assert (gr is None) == (rg is None), path          # unreached leaf
        if rg is not None:
            close(gr, rg, GRAD_RTOL, GRAD_ATOL, path)


def test_gin_module_is_the_functional_forward():
    _, tcfg, a, jparams = jax_reference("gin", "smoke", "float32")
    params = interop.gnn_params_from_jax(jparams, device="cpu")
    g = torch_batch(a)
    module = gin.GIN(tcfg, params)
    n_params = sum(p.numel() for p in module.parameters())
    assert n_params == sum(x.size for x in jax.tree.leaves(jparams))
    assert all(p.requires_grad for p in module.parameters())
    torch.testing.assert_close(module(g), gin.forward(params, tcfg, g),
                               rtol=0, atol=0)
    module(g).sum().backward()
    assert module.params.tree()["layers"][0]["eps"].grad is not None
