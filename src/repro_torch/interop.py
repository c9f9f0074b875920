"""Carry state between the JAX package and the port as numpy arrays.

The JAX package's ``CBList``, ``BlockStore``, ``UpdateLog``, ``CSRGraph``,
``ShardedCBList``, ``TieredGraph`` and program outputs are NamedTuples or
dataclasses of arrays; anything with the same field names whose leaves ``np.asarray``
accepts converts here (nothing of the JAX package is imported).  Values are copied unchanged — int32 stays int32 — so a layout
moved across and back compares bit for bit.  ``lm_params_from_jax`` turns
the JAX LM's period-stacked parameter tree into the port's layer list, and
``lm_checkpoint_layout`` writes an LM train state's checkpoint in that
period-stacked tree;
``sasrec_params_from_jax`` and ``gnn_params_from_jax`` carry a SASRec or
GNN tree over as it is.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch import tree as T
from repro_torch.backend import resolve_device
from repro_torch.checkpoint import Stacked
from repro_torch.core.blockstore import BlockStore
from repro_torch.core.cblist import CBList
from repro_torch.core.csr import CSRGraph, csr_merge
from repro_torch.core.tiered import TieredGraph
from repro_torch.distributed.graph import ShardedCBList
from repro_torch.stream.log import UpdateLog


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def from_numpy(x, device=None) -> torch.Tensor:
    a = np.array(np.asarray(x))
    if a.dtype.name == "bfloat16":          # ml_dtypes, as JAX hands it out
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16) \
            .to(resolve_device(device))
    return torch.as_tensor(a, device=resolve_device(device))


def _fields(obj, names):
    if isinstance(obj, dict):
        return {k: obj[k] for k in names}
    return {k: getattr(obj, k) for k in names}


def store_from_arrays(store, device=None) -> BlockStore:
    return BlockStore(**{k: from_numpy(v, device) for k, v in
                         _fields(store, BlockStore._fields).items()})


def cbl_from_arrays(cbl, device=None) -> CBList:
    """A port CBList from a JAX ``CBList`` (or a dict of its fields)."""
    f = _fields(cbl, CBList._fields)
    return CBList(store=store_from_arrays(f.pop("store"), device),
                  **{k: from_numpy(v, device) for k, v in f.items()})


def cbl_to_numpy(cbl: CBList) -> Dict[str, Any]:
    """A port CBList as ``{field: ndarray}`` with ``store`` a nested dict."""
    out = {k: to_numpy(getattr(cbl, k)) for k in CBList._fields
           if k != "store"}
    out["store"] = {k: to_numpy(getattr(cbl.store, k))
                    for k in BlockStore._fields}
    return out


_CSR_FIELDS = ("offsets", "indices", "weights", "row", "nv")
_TIER_FIELDS = ("delta", "runs", "sealed", "v_epoch", "wgen", "run_version")


def csr_from_arrays(csr, device=None) -> CSRGraph:
    """A port CSRGraph from a JAX ``CSRGraph`` (or a dict of its fields);
    the run's point-read keys and push stream are built on the way."""
    f = _fields(csr, _CSR_FIELDS)
    return CSRGraph(nv=int(f.pop("nv")),
                    **{k: from_numpy(v, device) for k, v in f.items()})


def _shard_rows(tree, rows: slice):
    """``tree`` (nested dicts of ``[S, ...]`` arrays) cut to ``rows``."""
    if isinstance(tree, dict):
        return {k: _shard_rows(v, rows) for k, v in tree.items()}
    return np.asarray(tree)[rows]


def sharded_from_arrays(scbl, device=None, mesh=None) -> ShardedCBList:
    """A port ShardedCBList from a JAX ``ShardedCBList`` (or a dict of its
    ``shards`` and ``v_shard``): the stacked ``[S, ...]`` arrays as they
    are, or on a ``mesh`` this rank's block of them (every rank passes the
    whole stack; a rank outside the mesh takes an empty shard)."""
    f = _fields(scbl, ("shards", "v_shard"))
    if mesh is None:
        return ShardedCBList(shards=cbl_from_arrays(f["shards"], device),
                             v_shard=from_numpy(f["v_shard"], device))
    from repro_torch.distributed.graph import (_local_ids, _phantom,
                                               _restack)
    stack = _fields(f["shards"], CBList._fields)
    stack["store"] = _fields(stack["store"], BlockStore._fields)
    S = int(np.asarray(stack["v_deg"]).shape[0])
    ids = _local_ids(mesh, S)
    if ids:
        shards = cbl_from_arrays(_shard_rows(stack,
                                             slice(ids.start, ids.stop)),
                                 device)
    else:
        first = cbl_from_arrays(_shard_rows(stack, slice(0, 1)), device)
        shards = _restack([_phantom(
            int(first.n_vertices[0]), first.store.keys.shape[1],
            first.store.keys.shape[2], first.v_deg.shape[1],
            first.v_deg.device)])
    return ShardedCBList(shards=shards,
                         v_shard=from_numpy(f["v_shard"], device),
                         mesh=mesh, n_shards=S)


def sharded_to_numpy(scbl: ShardedCBList) -> Dict[str, Any]:
    """A port ShardedCBList as ``{"shards": <cbl_to_numpy of the stack>,
    "v_shard": ndarray}``: on a mesh every rank gathers the whole stack."""
    from repro_torch.distributed.graph import _cbl_map, gather_shards
    whole = _cbl_map(lambda a: gather_shards(scbl, a), scbl.shards)
    return {"shards": cbl_to_numpy(whole), "v_shard": to_numpy(scbl.v_shard)}


def _is_sharded_arrays(delta) -> bool:
    return "shards" in delta if isinstance(delta, dict) \
        else hasattr(delta, "shards")


def _runs_from_arrays(runs, delta=None, device=None):
    """One run, or (over a sharded ``delta``) a tuple of one a shard the
    rank holds from arrays stacked ``[S, ...]``: a rank outside the mesh
    takes an empty run of the stack's capacity."""
    if delta is None:
        return csr_from_arrays(runs, device)
    f = _fields(runs, _CSR_FIELDS)
    nv = int(np.asarray(f.pop("nv")).reshape(-1)[0])
    ids = delta.shard_ids
    if not ids:
        from repro_torch.core.csr import csr_empty
        return (csr_empty(nv, np.asarray(f["indices"]).shape[1],
                          delta.device),)
    return tuple(CSRGraph(nv=nv, **{k: from_numpy(np.asarray(v)[i], device)
                                    for k, v in f.items()})
                 for i in ids)


def tiered_from_arrays(tg, device=None, mesh=None) -> TieredGraph:
    """A port TieredGraph from a JAX ``TieredGraph`` (or a dict of its
    fields), over an unsharded or a sharded delta (on a ``mesh``, this
    rank's shards and runs)."""
    f = _fields(tg, _TIER_FIELDS)
    if _is_sharded_arrays(f["delta"]):
        delta = sharded_from_arrays(f["delta"], device, mesh)
        runs = _runs_from_arrays(f["runs"], delta, device)
    else:
        delta = cbl_from_arrays(f["delta"], device)
        runs = _runs_from_arrays(f["runs"], None, device)
    return TieredGraph(delta=delta, runs=runs,
                       sealed=from_numpy(f["sealed"], device),
                       v_epoch=from_numpy(f["v_epoch"], device),
                       wgen=int(np.asarray(f["wgen"])),
                       run_version=int(np.asarray(f["run_version"])))


def tiered_to_numpy(tg: TieredGraph) -> Dict[str, Any]:
    """A port TieredGraph as ``{field: ndarray}``: the delta as
    :func:`cbl_to_numpy` or :func:`sharded_to_numpy` gives it, the runs'
    arrays (stacked ``[S, ...]`` over a sharded delta, as the JAX package
    keeps them; on a mesh every rank gathers every shard's)."""
    if tg.is_sharded:
        from repro_torch.distributed.graph import gather_shards
        runs = {k: to_numpy(gather_shards(tg.delta, torch.stack(
            [getattr(g, k) for g in tg.run_list])))
            for k in _CSR_FIELDS if k != "nv"}
    else:
        run = tg.runs
        if tg.run_retired:          # the JAX package keeps no retired lanes
            none = torch.zeros(0, dtype=torch.int32, device=tg.device)
            run = csr_merge(run, tg.sealed, none, none, none.float())
        runs = {k: to_numpy(getattr(run, k))
                for k in _CSR_FIELDS if k != "nv"}
    runs["nv"] = tg.run_list[0].nv
    return {"delta": (sharded_to_numpy(tg.delta) if tg.is_sharded
                      else cbl_to_numpy(tg.delta)),
            "runs": runs, "sealed": to_numpy(tg.sealed),
            "v_epoch": to_numpy(tg.v_epoch), "wgen": tg.wgen,
            "run_version": tg.run_version}


def log_from_arrays(log, device=None) -> UpdateLog:
    """A port UpdateLog from a JAX ``UpdateLog`` (or a dict of its fields)."""
    return UpdateLog(**{k: from_numpy(v, device) for k, v in
                        _fields(log, UpdateLog._fields).items()})


def log_to_numpy(log: UpdateLog) -> Dict[str, np.ndarray]:
    return {k: to_numpy(getattr(log, k)) for k in UpdateLog._fields}


def lm_layer_groups(n_layers: int, period: int):
    """Where the port's LM layers sit in the JAX package's tree:
    (``groups``, ``tail``), ``groups[i]`` the port's indices of the layers
    stacked in ``periods["l{i}"]`` (layer ``p * period + i`` at index p),
    ``tail`` those of the ``tail`` list, in order."""
    n_full = n_layers // period
    return ([[p * period + i for p in range(n_full)] for i in range(period)],
            list(range(n_full * period, n_layers)))


def lm_params_from_jax(tree, device=None) -> Dict[str, Any]:
    """The port's LM parameters from a JAX ``init_params`` tree (numpy or
    JAX leaves), its layers placed by :func:`lm_layer_groups`.  Every leaf
    is cut at its period index, so a MoE layer's stacked experts
    [n_periods, E, d, f] become its [E, d, f].  A JAX gradient or AdamW
    moment tree has the parameters' structure and maps the same way."""
    def conv(node, index=None):
        if isinstance(node, dict):
            return {k: conv(v, index) for k, v in node.items()}
        return from_numpy(node if index is None else np.asarray(node)[index],
                          device)

    periods = tree["periods"]
    subs = [periods[f"l{i}"] for i in range(len(periods))]
    tail = tree.get("tail", [])
    n_full = (0 if subs[0] is None
              else len(np.asarray(subs[0]["ln1"]["scale"])))
    groups, tail_ids = lm_layer_groups(n_full * len(subs) + len(tail),
                                       len(subs))
    layers: list = [None] * (n_full * len(subs) + len(tail))
    for sub, ids in zip(subs, groups):
        for p, li in enumerate(ids):
            layers[li] = conv(sub, p)
    for lp, li in zip(tail, tail_ids):
        layers[li] = conv(lp)
    return {"embed": conv(tree["embed"]), "lm_head": conv(tree["lm_head"]),
            "ln_f": conv(tree["ln_f"]), "layers": layers}


_LM_KEYS = frozenset(("embed", "lm_head", "ln_f", "layers"))


def _jax_lm_layout(node, period: int):
    """A port LM tree of flatten indices in the JAX package's layout: the
    layers of ``periods["l{i}"]`` stacked leaf by leaf (``None`` with no
    full period), the ``tail`` key only when there is a tail."""
    layers = node["layers"]
    groups, tail = lm_layer_groups(len(layers), period)
    out = {k: v for k, v in node.items() if k != "layers"}
    out["periods"] = {
        f"l{i}": (T.unflatten(layers[ids[0]], [
            Stacked(ix) for ix in zip(*(T.leaves(layers[j]) for j in ids))])
            if ids else None)
        for i, ids in enumerate(groups)}
    if tail:
        out["tail"] = [layers[j] for j in tail]
    return out


def lm_checkpoint_layout(period: int):
    """The checkpoint layout (``repro_torch.checkpoint``'s ``layout=``) of
    an LM train state in the JAX package's tree: every LM parameter tree in
    it (the parameters, AdamW's ``m`` and ``v``) written as
    ``periods/l{i}`` [n_periods, ...] plus ``tail`` by
    :func:`lm_layer_groups`, the rest as it is, so the JAX package's
    ``restore`` reads the port's checkpoints and the port's reads JAX's,
    bit for bit."""
    def layout(node):
        if isinstance(node, dict):
            if _LM_KEYS <= node.keys():
                return _jax_lm_layout(node, period)
            return {k: layout(v) for k, v in node.items()}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(layout(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(layout(v) for v in node)
        return node
    return layout


def sasrec_params_from_jax(tree, device=None) -> Dict[str, Any]:
    """The port's SASRec parameters from a JAX ``init_params`` tree (numpy
    or JAX leaves), with the same keys and ``blocks`` list."""
    if isinstance(tree, dict):
        return {k: sasrec_params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [sasrec_params_from_jax(v, device) for v in tree]
    return from_numpy(tree, device)


# a GNN tree carries over as it is, as SASRec's does; 0-d leaves (GIN's
# ``eps``) stay 0-d
gnn_params_from_jax = sasrec_params_from_jax
