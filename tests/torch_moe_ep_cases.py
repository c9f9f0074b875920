"""The cases of tests/test_torch_moe_ep.py: the expert-parallel MoE
(``apply_moe_ep``) and the LM's steps (``loss_fn`` with its gradients,
``prefill``, ``serve_step``) on a mesh of 4 ranks, for the port's gloo
ranks (:func:`run`) and for the JAX package's script under its own mesh.

Configs are the smoke configs of each side's ``configs`` package with the
SPMD fields of a mesh (:func:`spmd`); inputs are numpy from a seed; the
weights are JAX ``init_params`` trees that the test process writes, which
the ranks read with ``interop.lm_params_from_jax``.  torch and the port
are imported inside the functions that use them, so the JAX script can
import this module too."""
import dataclasses
import importlib
import math

import numpy as np

MESHES = {"dm": ((2, 2), ("data", "model")),
          "pdm": ((2, 1, 2), ("pod", "data", "model"))}
# lanes dropped per shard at 1.25 (C_loc = 5 of 16 tokens' 32 lanes over 8
# experts); dropless at 16 (C_loc = T_loc)
CAPACITY_FACTORS = (1.25, 16.0)
MOE_SHAPE = (4, 8)                 # B, S of the MoE's input
LOSS_CONFIGS = ("qwen3-moe", "kimi-k2", "dense-cp")
SMOKE = {"qwen3-moe": "qwen3_moe_30b_a3b", "kimi-k2": "kimi_k2_1t_a32b",
         "dense-cp": "qwen1_5_4b"}
SERVE_CONFIG = "qwen3-moe"
BATCH, SEQ, ROOM = 4, 16, 4        # tokens [B, S]; decode cache S + ROOM
SEED = 11


def config(pkg: str, name: str, capacity_factor=None):
    """The smoke config ``name`` of ``pkg`` ("repro" or "repro_torch").
    "dense-cp" is qwen1.5's with 3 heads, which do not split over a model
    axis of 2: its attention takes the context-parallel branch."""
    cfg = importlib.import_module(
        f"{pkg}.configs.{SMOKE[name]}").smoke_config()
    if name == "dense-cp":
        cfg = dataclasses.replace(cfg, n_heads=3, n_kv_heads=3)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, capacity_factor=capacity_factor)
    return cfg


def spmd(cfg, mesh_name: str, **over):
    """``cfg`` with the SPMD fields of mesh ``mesh_name``, as the registry
    sets them for an ``opt`` cell."""
    shape, axes = MESHES[mesh_name]
    kw = dict(act_shard_axes=axes[:-1], data_axis_size=math.prod(shape[:-1]),
              model_axis_size=shape[-1], ep_shard_map=cfg.moe)
    kw.update(over)
    return dataclasses.replace(cfg, **kw)


def tokens(cfg, batch=BATCH, seq=SEQ):
    """(tokens, labels) int32 [batch, seq], one label masked."""
    rng = np.random.default_rng(SEED)
    t = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    lab = rng.integers(0, cfg.vocab, (batch, seq), dtype=np.int32)
    lab[0, 3] = -1
    return t, lab


def moe_input(cfg) -> np.ndarray:
    return np.random.default_rng(SEED + 1).standard_normal(
        MOE_SHAPE + (cfg.d_model,)).astype(np.float32)


def moe_weights(cfg) -> np.ndarray:
    """The weights of the MoE's loss sum(y * w) + aux, whose gradients the
    gather-based dispatch's case holds."""
    return np.random.default_rng(SEED + 3).standard_normal(
        MOE_SHAPE + (cfg.d_model,)).astype(np.float32)


def decode_tokens(cfg, batch=BATCH) -> np.ndarray:
    return np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab, (batch, 1), dtype=np.int32)


def data_shard(mesh) -> int:
    """This rank's data shard: its coordinates over the batch axes, the
    outermost first."""
    from repro_torch.launch.mesh import batch_axes, mesh_axis_sizes
    sizes, i = mesh_axis_sizes(mesh), 0
    for a in batch_axes(mesh):
        i = i * sizes[a] + mesh.get_local_rank(a)
    return i


def _place_params(params, mesh, fsdp):
    from repro_torch import tree as T
    from repro_torch.distributed.sharding import NamedSharding, lm_param_spec
    from repro_torch.runtime import reshard_state
    paths, leaves = T.flatten_with_paths(params)
    return reshard_state(params, T.unflatten(params, [
        NamedSharding(mesh, lm_param_spec(p, x.dim(), fsdp))
        for p, x in zip(paths, leaves)]))


def _place(x, mesh, spec):
    from repro_torch.distributed.sharding import NamedSharding
    from repro_torch.runtime import reshard_state
    return reshard_state(x, NamedSharding(mesh, spec))


def _whole(tree):
    from repro_torch import tree as T
    return T.tree_map(lambda x: x.full_tensor().numpy(), tree)


def _raised(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _quantized_step(jparams, mesh) -> dict:
    """One AdamW step with 8-bit moments (kimi-k2's optimizer) on kimi's
    smoke parameters placed by the ``opt`` rules (codes' flat blocks over
    ("data", "model"), replicated over "pod"; the parameters' FSDP dim
    over the batch axes), from a state after one plain step; whole
    results."""
    import torch

    from repro_torch import interop
    from repro_torch import tree as T
    from repro_torch.distributed.sharding import (NamedSharding,
                                                  _opt_wrap, lm_param_spec)
    from repro_torch.optim import AdamWConfig, adamw_update, init_opt_state
    from repro_torch.runtime import reshard_state
    params = interop.lm_params_from_jax(jparams["kimi-k2"], "cpu")
    gen = torch.Generator().manual_seed(SEED)
    grads = T.tree_map(lambda x: torch.randn(x.shape, generator=gen), params)
    cfg = AdamWConfig(quantized_state=True)
    _, state = adamw_update(params, grads, init_opt_state(params, cfg), cfg)
    from repro_torch.launch.mesh import batch_axes
    ba = batch_axes(mesh)
    paths, leaves = T.flatten_with_paths(state)
    rule = _opt_wrap(lambda p, nd: lm_param_spec(p, nd, ba))
    dstate = reshard_state(state, T.unflatten(state, [
        NamedSharding(mesh, rule(p, x)) for p, x in zip(paths, leaves)]))
    dparams, dgrads = (_place_params(t, mesh, ba) for t in (params, grads))
    new_p, new_s = adamw_update(dparams, dgrads, dstate, cfg)
    return dict(params=_whole(new_p), state=_whole(new_s))


def run(jparams: dict) -> dict:
    """Every case on every mesh, on this rank of a 4-rank group: whole
    (``full_tensor()``) outputs as numpy, this rank's routes, and the
    messages of the calls that must raise."""
    import torch

    from repro_torch import interop
    from repro_torch.distributed.sharding import P
    from repro_torch.launch.mesh import (batch_axes, make_debug_mesh,
                                         use_mesh)
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.transformer import layers as L
    from repro_torch.models.transformer import model as M

    out = {}
    for mname, (shape, axes) in MESHES.items():
        mesh = make_debug_mesh(shape, axes, device_type="cpu")
        ba = batch_axes(mesh)
        base = config("repro_torch", SERVE_CONFIG)
        moe_p = _place_params({"layers": [{"moe": interop.lm_params_from_jax(
            jparams[SERVE_CONFIG], "cpu")["layers"][0]["moe"]}]}, mesh,
            ba)["layers"][0]["moe"]
        x = _place(torch.from_numpy(moe_input(base)), mesh, P(ba, None, None))
        for cf in CAPACITY_FACTORS:
            cfg = spmd(dataclasses.replace(base, capacity_factor=cf), mname)
            for impl in ("torch", "cuda"):
                probe = {}
                with use_mesh(mesh):
                    y, aux = L.apply_moe_ep(moe_p, cfg, x, impl, probe)
                eidx, plan = probe["eidx"], probe["plan"]
                out[(mname, "moe", cf, impl)] = dict(
                    y=y.full_tensor().numpy(), aux=float(aux),
                    shard=data_shard(mesh), eidx=eidx.numpy(),
                    keep=(plan.slot_of_lane < plan.E * plan.C).numpy())

        # the gather-based dispatch (ep_shard_map off): every rank routes
        # all T tokens, the aux loss kept; the loss sum(y * w) + aux and
        # its gradients in the parameters and the input
        w = _place(torch.from_numpy(moe_weights(base)), mesh,
                   P(ba, None, None))
        for cf in CAPACITY_FACTORS:
            cfg = spmd(dataclasses.replace(base, capacity_factor=cf), mname,
                       ep_shard_map=False)
            for impl in ("torch", "cuda"):
                probe, kept = {}, {}

                def moe_loss(t, cfg=cfg, impl=impl, probe=probe, kept=kept):
                    y, aux = L.apply_moe(t["moe"], cfg, t["x"], impl, probe)
                    kept.update(y=y.detach(), aux=aux.detach())
                    return (y.float() * w).sum() + aux
                with use_mesh(mesh):
                    loss, grads = value_and_grad(moe_loss)(
                        {"moe": moe_p, "x": x})
                plan = probe["plan"]
                out[(mname, "moe_gather", cf, impl)] = dict(
                    loss=float(loss.full_tensor()),
                    y=kept["y"].full_tensor().numpy(),
                    aux=float(kept["aux"].full_tensor()),
                    grads=_whole(grads), eidx=probe["eidx"].numpy(),
                    keep=(plan.slot_of_lane < plan.E * plan.C).numpy())

        for name in LOSS_CONFIGS:
            cfg = spmd(config("repro_torch", name), mname)
            params = _place_params(
                interop.lm_params_from_jax(jparams[name], "cpu"), mesh, ba)
            t, lab = (_place(torch.from_numpy(a), mesh, P(ba, None))
                      for a in tokens(cfg))
            vg = value_and_grad(
                lambda p, b, cfg=cfg: M.loss_fn(p, cfg, b[0], b[1], "torch"))
            with use_mesh(mesh):
                loss, grads = vg(params, (t, lab))
            out[(mname, "loss", name)] = dict(
                loss=float(loss.full_tensor()), grads=_whole(grads))

        cfg = spmd(base, mname)
        params = _place_params(
            interop.lm_params_from_jax(jparams[SERVE_CONFIG], "cpu"), mesh, ba)
        t, _ = tokens(cfg)
        with use_mesh(mesh):
            logits, cache = M.prefill(params, cfg, _place(
                torch.from_numpy(t), mesh, P(ba, None)))
        pre = dict(logits=logits.full_tensor().numpy(),
                   **{k: v.full_tensor().numpy() for k, v in cache.items()})
        kv = P(None, ba, None, "model", None)
        room = {}
        for k in ("k", "v"):
            full = np.zeros(pre[k].shape[:3] + (SEQ + ROOM,)
                            + pre[k].shape[4:], np.float32)
            full[:, :, :, :SEQ] = pre[k]
            room[k] = _place(torch.from_numpy(full), mesh, kv)
        room["lengths"] = _place(torch.from_numpy(pre["lengths"]), mesh,
                                 P(ba))
        dt = _place(torch.from_numpy(decode_tokens(cfg)), mesh, P(ba, None))
        with use_mesh(mesh):
            logits, cache = M.serve_step(params, cfg, room, dt)
        out[(mname, "serve")] = dict(
            prefill=pre, logits=logits.full_tensor().numpy(),
            **{k: v.full_tensor().numpy() for k, v in cache.items()})

        out[(mname, "adamw8")] = _quantized_step(jparams, mesh)
        if mname == "dm":
            wrong = spmd(base, mname, data_axis_size=4)
            with use_mesh(mesh):
                out["wrong_mesh"] = _raised(
                    lambda: L.apply_moe_ep(moe_p, wrong, x))
            one = {k: _place(torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads,
                                          SEQ, cfg.head_dim)), mesh,
                             P(None, None, None, ("data", "model"), None))
                   for k in ("k", "v")}
            one["lengths"] = _place(torch.zeros(1, dtype=torch.int32), mesh,
                                    P(None))
            one_tok = _place(torch.zeros((1, 1), dtype=torch.int32), mesh,
                             P(None, None))
            with use_mesh(mesh):
                out["one_token"] = _raised(
                    lambda: M.serve_step(params, cfg, one, one_tok))
    return out
