"""The expert-parallel MoE (``layers.apply_moe_ep``) and the LM's steps on
a mesh, against the JAX package under a JAX mesh of the same shape.

Two meshes of 4 ranks: ``("data", "model")`` at (2, 2) and ``("pod",
"data", "model")`` at (2, 1, 2), the configs' SPMD fields set as the
registry's ``opt`` cells set them (``tests/torch_moe_ep_cases.py``).  The
port runs on 4 gloo ranks on the CPU, forked once for the module in a
subprocess (the group's timeout 60 s, the subprocess's 240 s, so a hang
fails the tests), with its parameters, optimizer-free, placed by
``distributed/sharding.py``'s rules; the JAX package runs in another
subprocess with 4 forced host devices (as tests/test_sharding_dryrun.py's
EP test does), both at once.  The weights are JAX ``init_params`` trees
made in this process, read by the ranks through
``interop.lm_params_from_jax``.

Held: ``apply_moe_ep`` at capacity factor 1.25 (lanes dropped per shard)
and 16 (dropless) on both impls, its routes (each data shard's expert ids
and kept lanes) bit for bit JAX's, its output within ATOL of JAX's and of
the port's one-card ``apply_moe`` on each data shard's tokens (the oracle
at any capacity factor: per-shard dispatch at ``C_loc`` is ``apply_moe``
on ``T_loc`` tokens); ``loss_fn`` and every gradient leaf for qwen3-moe,
kimi-k2 (its shared expert) and a dense config whose 3 heads do not split
over the model axis (context-parallel attention); ``prefill``'s logits and
cache and one dense-cache ``serve_step``; every rank's ``full_tensor()``
equal; kimi-k2's AdamW with 8-bit moments on DTensors bit for bit the
plain update; and ValueError with no mesh, a mesh of the wrong size, and
one decode token over 2 data shards (long_500k's decode)."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import dataclasses
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_moe_ep_cases as C
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.models.transformer import layers as L
from repro_torch.models.transformer import model as M

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
# float32 values within 1e-5 of the reference's largest magnitude (of
# values of order one, atol 1e-5; JAX's own EP test holds 1e-4): XLA sums
# the experts' products in another order, and the MoE's gated lanes of
# size ~20 cancel to outputs far smaller, whose error is the lanes'
ATOL = 1e-5
# gradients relative to each leaf, with a floor at 1e-5 of its largest
# value for the elements near 0 (tests/test_torch_lm_train.py's rule)
GRAD_RTOL, GRAD_ATOL_OF_MAX = 1e-4, 1e-5

RANKS = r'''
import datetime
import pickle
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_moe_ep_cases as C

WORLD = 4


def run(rank, port, params, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    res = C.run(params)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    with open(sys.argv[2], "rb") as f:
        params = pickle.load(f)
    # forked: the ranks start with everything above imported
    mp.start_processes(run, args=(int(sys.argv[1]), params, sys.argv[3]),
                       nprocs=WORLD, start_method="fork")
    print("RANKS_OK")
'''

JAX_REF = r'''
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import torch_moe_ep_cases as C
from repro.compat import set_mesh
from repro.models.transformer import layers as L
from repro.models.transformer import model as M


def routes(p, cfg, x, D):
    """Each data shard's expert ids and kept lanes (token-major), by the
    ops of apply_moe_ep's dispatch."""
    E, K = cfg.n_experts, cfg.top_k
    xt = x.reshape(-1, x.shape[-1])
    T_loc = xt.shape[0] // D
    C_loc = min(T_loc, int(T_loc * K / E * cfg.capacity_factor) + 1)
    out = []
    for dd in range(D):
        xs = jnp.asarray(xt[dd * T_loc:(dd + 1) * T_loc])
        probs = jax.nn.softmax(xs.astype(jnp.float32) @ p["router"], -1)
        _, eidx = jax.lax.top_k(probs, K)
        flat = np.asarray(eidx).reshape(-1)
        order = np.argsort(flat, kind="stable")
        se = flat[order]
        rank = np.arange(flat.size) - np.searchsorted(se, np.arange(E))[se]
        keep = np.empty(flat.size, bool)
        keep[order] = rank < C_loc
        out.append((np.asarray(eidx), keep))
    return out


with open(sys.argv[1], "rb") as f:
    jparams = pickle.load(f)
out = {}
for mname, (shape, axes) in C.MESHES.items():
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(shape), axes)
    ba = axes[:-1]
    rep = NamedSharding(mesh, P())
    rows = NamedSharding(mesh, P(ba, None))
    base = C.config("repro", C.SERVE_CONFIG)
    moe_p = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         jparams[C.SERVE_CONFIG]["periods"]["l0"]["moe"])
    x = C.moe_input(base)
    with set_mesh(mesh):
        for cf in C.CAPACITY_FACTORS:
            cfg = C.spmd(dataclasses.replace(base, capacity_factor=cf), mname)
            y, aux = jax.jit(lambda p, x, cfg=cfg: L.apply_moe(p, cfg, x),
                             in_shardings=(rep, NamedSharding(
                                 mesh, P(ba, None, None))))(moe_p, x)
            out[(mname, "moe", cf)] = dict(
                y=np.asarray(y), aux=float(aux),
                routes=routes(moe_p, cfg, x, cfg.data_axis_size))
            gcfg = dataclasses.replace(cfg, ep_shard_map=False)
            w = C.moe_weights(base)

            def moe_loss(p, x, cfg=gcfg):
                y, aux = L.apply_moe(p, cfg, x)
                return jnp.sum(y.astype(jnp.float32) * w) + aux, (y, aux)
            (loss, (y, aux)), (gp, gx) = jax.jit(
                jax.value_and_grad(moe_loss, argnums=(0, 1), has_aux=True),
                in_shardings=(rep, NamedSharding(mesh, P(ba, None, None))))(
                moe_p, x)
            out[(mname, "moe_gather", cf)] = dict(
                loss=float(loss), y=np.asarray(y), aux=float(aux),
                grads=dict(moe=jax.tree.map(np.asarray, gp),
                           x=np.asarray(gx)),
                routes=routes(moe_p, gcfg, x, 1))
        for name in C.LOSS_CONFIGS:
            cfg = C.spmd(C.config("repro", name), mname)
            t, lab = C.tokens(cfg)
            loss, grads = jax.jit(
                jax.value_and_grad(
                    lambda p, t, l, cfg=cfg: M.loss_fn(p, cfg, t, l)),
                in_shardings=(rep, rows, rows))(jparams[name], t, lab)
            out[(mname, "loss", name)] = dict(
                loss=float(loss), grads=jax.tree.map(np.asarray, grads))
        cfg = C.spmd(base, mname)
        params = jparams[C.SERVE_CONFIG]
        t, _ = C.tokens(cfg)
        logits, cache = jax.jit(lambda p, t: M.prefill(p, cfg, t),
                                in_shardings=(rep, rows))(params, t)
        pre = dict(logits=np.asarray(logits),
                   **{k: np.asarray(v) for k, v in cache.items()})
        room = M.init_cache(cfg, C.BATCH, C.SEQ + C.ROOM)
        room = {k: np.asarray(v) for k, v in dict(
            k=room["k"].at[:, :, :, :C.SEQ].set(cache["k"]),
            v=room["v"].at[:, :, :, :C.SEQ].set(cache["v"]),
            lengths=cache["lengths"]).items()}
        logits, cache = jax.jit(lambda p, c, t: M.serve_step(p, cfg, c, t),
                                in_shardings=(rep, rep, rows))(
            params, room, C.decode_tokens(cfg))
        out[(mname, "serve")] = dict(
            prefill=pre, logits=np.asarray(logits),
            **{k: np.asarray(v) for k, v in cache.items()})
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
print("JAX_OK")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's results, JAX's results, the JAX weights): the ranks
    and the JAX script run at once, each in a subprocess of its own."""
    d = tmp_path_factory.mktemp("moe_ep")
    jparams = {}
    for i, name in enumerate(C.LOSS_CONFIGS):
        from repro.models.transformer import model as JM
        tree = JM.init_params(jax.random.PRNGKey(i),
                              C.config("repro", name))
        jparams[name] = jax.tree.map(np.asarray, tree)
    with open(d / "params.pkl", "wb") as f:
        pickle.dump(jparams, f)
    (d / "ranks.py").write_text(RANKS)
    (d / "jax_ref.py").write_text(JAX_REF)
    tests = str(REPO / "tests")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                                       tests]))
    env.pop("XLA_FLAGS", None)
    ranks = subprocess.Popen(
        [sys.executable, str(d / "ranks.py"), str(_free_port()),
         str(d / "params.pkl"), str(d)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ref = subprocess.Popen(
        [sys.executable, str(d / "jax_ref.py"), str(d / "params.pkl"),
         str(d / "jax.pkl")], env=dict(env, JAX_PLATFORMS="cpu"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        r_out, r_err = ranks.communicate(timeout=240)
        j_out, j_err = ref.communicate(timeout=240)
    finally:
        for p in (ranks, ref):
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert ranks.returncode == 0 and "RANKS_OK" in r_out, r_err[-4000:]
    assert ref.returncode == 0 and "JAX_OK" in j_out, j_err[-4000:]
    res = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            res.append(pickle.load(f))
    with open(d / "jax.pkl", "rb") as f:
        jres = pickle.load(f)
    return res, jres, jparams


def _close(got, ref, what=""):
    np.testing.assert_allclose(
        got, ref, rtol=0, atol=ATOL * max(1.0, float(np.abs(ref).max())),
        err_msg=what)


def _same_on_every_rank(res, key):
    def eq(a, b):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                eq(a[k], b[k])
        elif isinstance(a, list):
            for x, y in zip(a, b):
                eq(x, y)
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
    for r in range(1, WORLD):
        eq({k: v for k, v in res[0][key].items() if k not in
            ("shard", "eidx", "keep")},
           {k: v for k, v in res[r][key].items() if k not in
            ("shard", "eidx", "keep")})


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("cf", C.CAPACITY_FACTORS)
@pytest.mark.parametrize("mesh", list(C.MESHES))
def test_apply_moe_ep_matches_jax_and_per_shard_apply_moe(runs, mesh, cf,
                                                         impl):
    res, jres, jparams = runs
    key = (mesh, "moe", cf, impl)
    _same_on_every_rank(res, key)
    ref = jres[(mesh, "moe", cf)]
    got = res[0][key]
    assert got["aux"] == 0.0 and ref["aux"] == 0.0
    _close(got["y"], ref["y"], "against JAX")
    # routes: every rank holds its data shard's, bit for bit JAX's
    for r in range(WORLD):
        eidx, keep = ref["routes"][res[r][key]["shard"]]
        np.testing.assert_array_equal(res[r][key]["eidx"], eidx)
        np.testing.assert_array_equal(res[r][key]["keep"],
                                      keep.reshape(res[r][key]["keep"].shape))
    if cf < 16:
        assert not all(k.all() for _, k in ref["routes"])   # lanes dropped
    # the oracle: apply_moe on each data shard's tokens, on one card
    cfg = C.config("repro_torch", C.SERVE_CONFIG, cf)
    p = interop.lm_params_from_jax(jparams[C.SERVE_CONFIG], "cpu")["layers"][0][
        "moe"]
    x = torch.from_numpy(C.moe_input(cfg))
    d = cfg.d_model
    D = len(ref["routes"])
    shards = x.reshape(D, -1, d)
    want = torch.cat([L.apply_moe(p, cfg, s[None], impl)[0][0]
                      for s in shards]).reshape(x.shape)
    _close(got["y"], want.numpy(), "against apply_moe on each data shard")


@pytest.mark.parametrize("impl", ["torch", "cuda"])
@pytest.mark.parametrize("cf", C.CAPACITY_FACTORS)
@pytest.mark.parametrize("mesh", list(C.MESHES))
def test_gather_dispatch_matches_jax_and_apply_moe(runs, mesh, cf, impl):
    """The MoE under ``act_shard_axes`` with ``ep_shard_map`` off (the JAX
    package's gather-based dispatch): every rank routes all T tokens at
    ``capacity(cfg, T)`` and keeps the aux loss.  The loss sum(y * w) +
    aux, y, aux and the gradients in every expert leaf and the input
    against JAX's ``apply_moe`` under its mesh; the routes bit for bit;
    y and aux against the port's one-card ``apply_moe`` on all tokens."""
    res, jres, jparams = runs
    key = (mesh, "moe_gather", cf, impl)
    _same_on_every_rank(res, key)
    ref = jres[(mesh, "moe_gather", cf)]
    got = res[0][key]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["aux"], ref["aux"], rtol=1e-5)
    assert got["aux"] > 0.0
    _close(got["y"], ref["y"], "against JAX")
    (eidx, keep), = ref["routes"]
    for r in range(WORLD):
        np.testing.assert_array_equal(res[r][key]["eidx"], eidx)
        np.testing.assert_array_equal(res[r][key]["keep"],
                                      keep.reshape(res[r][key]["keep"].shape))
    if cf < 16:
        assert not keep.all()                               # lanes dropped
    want = dict(ref["grads"]["moe"], x=ref["grads"]["x"])
    have = dict(got["grads"]["moe"], x=got["grads"]["x"])
    assert have.keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(
            have[k], w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * float(np.abs(w).max()), err_msg=k)
    cfg = C.config("repro_torch", C.SERVE_CONFIG, cf)
    p = interop.lm_params_from_jax(jparams[C.SERVE_CONFIG], "cpu")["layers"][0][
        "moe"]
    y, aux = L.apply_moe(p, cfg, torch.from_numpy(C.moe_input(cfg)), impl)
    _close(got["y"], y.numpy(), "against the one-card apply_moe")
    np.testing.assert_allclose(got["aux"], float(aux), rtol=1e-6)


@pytest.mark.parametrize("name", C.LOSS_CONFIGS)
@pytest.mark.parametrize("mesh", list(C.MESHES))
def test_loss_and_grads_match_jax(runs, mesh, name):
    res, jres, _ = runs
    key = (mesh, "loss", name)
    _same_on_every_rank(res, key)
    got, ref = res[0][key], jres[key]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    want = interop.lm_params_from_jax(ref["grads"], "cpu")
    paths, leaves = T.flatten_with_paths(got["grads"])
    for path, g, w in zip(paths, leaves, T.leaves(want)):
        w = w.numpy()
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_OF_MAX * float(np.abs(w).max()), err_msg=path)


@pytest.mark.parametrize("mesh", list(C.MESHES))
def test_prefill_and_serve_step_match_jax(runs, mesh):
    res, jres, _ = runs
    key = (mesh, "serve")
    _same_on_every_rank(res, key)
    got, ref = res[0][key], jres[key]
    for k in ("logits", "k", "v"):
        _close(got["prefill"][k], ref["prefill"][k], f"prefill {k}")
        _close(got[k], ref[k], f"serve_step {k}")
    np.testing.assert_array_equal(got["prefill"]["lengths"],
                                  ref["prefill"]["lengths"])
    np.testing.assert_array_equal(got["lengths"], ref["lengths"])


def test_quantized_adamw_on_dtensors(runs):
    """kimi-k2's AdamW with 8-bit moments on DTensors, on both meshes (the
    codes' flat blocks over ("data", "model"), replicated over "pod"; the
    parameters by the LM rules; each rank updates its own blocks, the
    parameters' elements exchanged all-to-all): new parameters, codes,
    scales and step bit for bit the same update on plain tensors."""
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
    res, _, jparams = runs
    params = interop.lm_params_from_jax(jparams["kimi-k2"], "cpu")
    gen = torch.Generator().manual_seed(C.SEED)
    grads = T.tree_map(lambda x: torch.randn(x.shape, generator=gen), params)
    cfg = AdamWConfig(quantized_state=True)
    _, state = adamw_update(params, grads, init_opt_state(params, cfg), cfg)
    want = adamw_update(params, grads, state, cfg)
    for mesh in C.MESHES:
        for r in range(WORLD):
            got = res[r][(mesh, "adamw8")]
            for a, b in zip(T.leaves((got["params"], got["state"])),
                            T.leaves(want)):
                np.testing.assert_array_equal(a, b.numpy(), err_msg=mesh)


def test_mesh_errors(runs):
    """A mesh of the wrong size, and one decode token over 2 data shards
    (the expert-parallel dispatch routes each shard's own tokens; JAX's
    shard_map refuses the same), raise ValueError naming the cause."""
    res, _, _ = runs
    for r in range(WORLD):
        assert "data_axis_size=4" in res[r]["wrong_mesh"]
        assert "do not split over the 2 data shards" in res[r]["one_token"]


def test_no_mesh_raises():
    """A config with SPMD fields and no ambient mesh: ValueError from every
    entry point, before any layer runs."""
    cfg = C.spmd(C.config("repro_torch", C.SERVE_CONFIG), "dm")
    params = M.init_params(cfg, device="meta")
    tokens = torch.zeros((2, 4), dtype=torch.int32, device="meta")
    cache = M.init_cache(cfg, 2, 8, device="meta")
    for call in (lambda: M.loss_fn(params, cfg, tokens, tokens),
                 lambda: M.prefill(params, cfg, tokens),
                 lambda: M.serve_step(params, cfg, cache, tokens[:, :1]),
                 lambda: L.apply_moe_ep(params["layers"][0]["moe"], cfg,
                                        torch.zeros((2, 4, cfg.d_model),
                                                    device="meta"))):
        with pytest.raises(ValueError, match="none is ambient"):
            call()
    with pytest.raises(ValueError, match="act_shard_axes names none"):
        M.loss_fn(params, dataclasses.replace(cfg, act_shard_axes=None),
                  tokens, tokens)
