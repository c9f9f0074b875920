"""Arch x shape cell registry: the 40-cell matrix of the JAX package's
``repro.configs.registry``, over the port's own configs and models.

``build_cell(arch, shape)`` returns the port's step function and its
arguments as ``device="meta"`` tensors (parameters, optimizer state, the
batch): shapes and dtypes with no bytes behind them, made by the real
initializers, where the JAX package takes ``jax.eval_shape``.  Nothing is
allocated, so a 1 T-parameter cell builds on the host.

``opt="pod"`` / ``"multipod"`` builds the JAX registry's beyond-paper
variant for that mesh.  An LM's config gains the SPMD fields JAX sets
(``act_shard_axes``, ``data_axis_size``, ``ep_shard_map``); its step runs
on DTensors under ``launch.mesh.use_mesh`` of the production mesh those
fields name (its arguments placed by the cell's shardings, as
``launch/step_cost.py`` does on the fake group): the activation
constraints and the expert-parallel MoE of ``models/transformer/
layers.py``.  Without that mesh the step raises ValueError, never running
the one-card path in its place.  Equiformer-v2's config gains
``truncate_rotation`` and ``edge_bf16``, which the port runs.  The cells'
shardings are :mod:`repro_torch.distributed.sharding`'s.
"""
from __future__ import annotations

import dataclasses
import functools
import importlib
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs import gnn_common, lm_common
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                               init_opt_state)

ARCH_MODULES = {
    "qwen3-moe-30b-a3b": "repro_torch.configs.qwen3_moe_30b_a3b",
    "kimi-k2-1t-a32b": "repro_torch.configs.kimi_k2_1t_a32b",
    "gemma2-27b": "repro_torch.configs.gemma2_27b",
    "qwen1.5-4b": "repro_torch.configs.qwen1_5_4b",
    "gemma3-27b": "repro_torch.configs.gemma3_27b",
    "gin-tu": "repro_torch.configs.gin_tu",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "egnn": "repro_torch.configs.egnn",
    "pna": "repro_torch.configs.pna",
    "sasrec": "repro_torch.configs.sasrec",
}

GNN_MODEL_MODULES = {
    "gin": "repro_torch.models.gnn.gin",
    "pna": "repro_torch.models.gnn.pna",
    "egnn": "repro_torch.models.gnn.egnn",
    "equiformer_v2": "repro_torch.models.gnn.equiformer_v2",
}

META = torch.device("meta")


class Cell(NamedTuple):
    arch: str
    shape: str
    kind: str                    # train | prefill | decode | serve | retrieval
    skip_reason: Optional[str]


class CellBuild(NamedTuple):
    arch: str
    shape: str
    kind: str
    family: str
    cfg: Any
    step_fn: Callable            # positional args matching arg_specs
    arg_specs: Tuple             # trees of meta tensors
    quantized_opt: bool
    opt: str = ""                # "" baseline | "pod" | "multipod" (SPMD opt)


def _mod(arch: str):
    return importlib.import_module(ARCH_MODULES[arch])


def arch_ids() -> List[str]:
    return list(ARCH_MODULES)


def shapes_for(arch: str) -> List[str]:
    fam = _mod(arch).FAMILY
    if fam == "lm":
        return list(lm_common.LM_SHAPES)
    if fam == "gnn":
        return list(gnn_common.GNN_SHAPES)
    return list(_mod(arch).RECSYS_SHAPES)


def list_cells() -> List[Cell]:
    cells = []
    for arch in arch_ids():
        m = _mod(arch)
        for shape in shapes_for(arch):
            if m.FAMILY == "lm":
                kind = lm_common.LM_SHAPES[shape][2]
            elif m.FAMILY == "gnn":
                kind = "train"
            else:
                kind = m.RECSYS_SHAPES[shape]["kind"]
            cells.append(Cell(arch, shape, kind, m.SKIP_SHAPES.get(shape)))
    return cells


# ---------------------------------------------------------------------------
# step builders: launch/train.py's value-and-grad, clip to 1, AdamW
# ---------------------------------------------------------------------------

def _train_step(loss_fn, opt_cfg: AdamWConfig):
    """step(params, opt_state, batch) -> (loss, gnorm, params, opt_state)."""
    from repro_torch.launch.train import MAX_GRAD_NORM, value_and_grad
    grad_fn = value_and_grad(loss_fn)

    def step(params, opt_state, batch):
        loss, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, MAX_GRAD_NORM)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg)
        return loss, gnorm, params, opt_state

    return step


def _ids(*shape) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.int32, device=META)


def _lm_cell(m, shape: str, opt_cfg: AdamWConfig, opt: str):
    from repro_torch.models.transformer import model as M
    cfg = m.full_config()
    if opt:
        cfg = dataclasses.replace(
            cfg,
            act_shard_axes=(("pod", "data") if opt == "multipod"
                            else ("data",)),
            data_axis_size=(32 if opt == "multipod" else 16),
            ep_shard_map=cfg.moe)
    seq, batch, kind = lm_common.LM_SHAPES[shape]
    params = M.init_params(cfg, device=META)
    if kind == "train":
        step = _train_step(
            lambda p, b: M.loss_fn(p, cfg, b["tokens"], b["labels"]),
            opt_cfg)
        specs = (params, init_opt_state(params, opt_cfg),
                 {"tokens": _ids(batch, seq), "labels": _ids(batch, seq)})
    elif kind == "prefill":
        def step(params, batch):
            return M.prefill(params, cfg, batch["tokens"])
        specs = (params, {"tokens": _ids(batch, seq)})
    else:
        def step(params, batch):
            return M.serve_step(params, cfg, batch["cache"], batch["tokens"])
        kv = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.head_dim)
        cache = {"k": torch.empty(kv, dtype=cfg.dtype, device=META),
                 "v": torch.empty(kv, dtype=cfg.dtype, device=META),
                 "lengths": _ids(batch)}
        specs = (params, {"cache": cache, "tokens": _ids(batch, 1)})
    return cfg, kind, step, specs


def _gnn_cell(m, shape: str, opt_cfg: AdamWConfig, opt: str):
    mod = importlib.import_module(GNN_MODEL_MODULES[m.MODULE])
    batch, (d_feat, n_cls, glvl) = gnn_common.graph_specs(
        shape, with_pos=m.NEEDS_POS)
    cfg = m.full_config(d_in=d_feat, n_classes=(1 if glvl else n_cls),
                        graph_level=glvl)
    if opt and hasattr(cfg, "truncate_rotation"):
        cfg = dataclasses.replace(cfg, truncate_rotation=True, edge_bf16=True)
    params = mod.init_params(cfg, torch.Generator(), device=META)
    step = _train_step(lambda p, b: mod.loss_fn(p, cfg, GraphBatch(**b)),
                       opt_cfg)
    return cfg, "train", step, (params, init_opt_state(params, opt_cfg),
                                batch)


def _recsys_cell(m, shape: str, opt_cfg: AdamWConfig):
    from repro_torch.models.recsys import sasrec as S
    cfg = m.full_config()
    kind = m.RECSYS_SHAPES[shape]["kind"]
    params = S.init_params(cfg, torch.Generator(), device=META)
    batch = m.input_specs(shape, cfg)
    if kind == "train":
        step = _train_step(lambda p, b: S.loss_fn(p, cfg, b["seq"], b["pos"],
                                                  b["neg"]), opt_cfg)
        return cfg, kind, step, (params, init_opt_state(params, opt_cfg),
                                 batch)
    if kind == "retrieval":
        def step(params, batch):
            return S.score_candidates(params, cfg, batch["seq"],
                                      batch["candidates"])
    else:
        def step(params, batch):
            return S.serve_step(params, cfg, batch["seq"])
    return cfg, kind, step, (params, batch)


@functools.lru_cache(maxsize=None)
def build_cell(arch: str, shape: str, opt: str = "") -> CellBuild:
    """The cell's step function and its arguments as meta tensors; ``opt``
    "" is the paper-faithful baseline, "pod" / "multipod" the SPMD-optimized
    variant for that mesh."""
    if opt not in ("", "pod", "multipod"):
        raise ValueError(f"opt must be '', 'pod' or 'multipod', got {opt!r}")
    m = _mod(arch)
    if shape in m.SKIP_SHAPES:
        raise ValueError(f"{arch} x {shape} skipped: {m.SKIP_SHAPES[shape]}")
    qopt = getattr(m, "QUANTIZED_OPT", False)
    opt_cfg = AdamWConfig(quantized_state=qopt)
    if m.FAMILY == "lm":
        cfg, kind, step, specs = _lm_cell(m, shape, opt_cfg, opt)
    elif m.FAMILY == "gnn":
        cfg, kind, step, specs = _gnn_cell(m, shape, opt_cfg, opt)
    else:
        cfg, kind, step, specs = _recsys_cell(m, shape, opt_cfg)
    return CellBuild(arch, shape, kind, m.FAMILY, cfg, step, specs, qopt,
                     opt)
