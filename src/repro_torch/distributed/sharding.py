"""Sharding rules per model family, as ``repro.distributed.sharding``:
a partition spec for every leaf of a cell's arguments and outputs, by the
leaf's path in the port's trees.

LM transformers: Megatron-style tensor parallel on "model" (column-parallel
qkv / up projections, row-parallel o / down), FSDP on "data" for the other
weight dim (over "pod" too on the multi-pod mesh), expert-parallel MoE
(experts over "model"), vocab-parallel ``lm_head``.  The port's layers are
a list (``layers/7/attn/wq``), where the JAX package stacks them by period
with a leading ``[n_periods]`` dim (``periods/l{i}/attn/wq``) and gives
that dim a leading ``None``: a port layer's spec is JAX's without it.

GNNs: vertex-partitioned batch with replicated (small) params.  SASRec:
the item table row-sharded over "model", the batch over the data axes.
Optimizer state mirrors its parameter's spec; 8-bit quantized moments
shard their flat block dim over the whole of ("data", "model").

A spec is port-native: a tuple with one entry per leading tensor dim
(fewer entries replicate the rest), each ``None``, an axis name or a tuple
of two or more axis names, as JAX's ``PartitionSpec`` holds them (:func:`P`
writes a one-axis tuple as the name).  :class:`NamedSharding`
pairs it with a :class:`~torch.distributed.device_mesh.DeviceMesh` and
turns it into DTensor placements: a dim over several axes is ``Shard(d)``
on each of their mesh dims, which DTensor splits outermost first, so the
axes must be listed in mesh order (every rule here does; another order is
refused rather than placed wrongly).

The serve read plane's snapshot replicas (``read_replica_devices``,
``replicate_snapshot``) live in :mod:`repro_torch.serve.replica` and are
re-exported here.
"""
from __future__ import annotations

import dataclasses
import functools
import re
from typing import Any, Tuple

import torch

from repro_torch import tree as T
from repro_torch.launch.mesh import batch_axes, mesh_axis_sizes
from repro_torch.serve.replica import (read_replica_devices,  # noqa: F401
                                       replicate_snapshot)


def _canonical(entry):
    if isinstance(entry, (tuple, list)):
        entry = tuple(entry)
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def P(*entries) -> tuple:
    """A partition spec, in the form JAX's ``PartitionSpec(*entries)``
    keeps: a one-axis tuple entry becomes the axis name, an empty one
    ``None``."""
    return tuple(_canonical(e) for e in entries)


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on the mesh
    dim of each axis that tensor dim ``d`` names, ``Replicate()`` on the
    others."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        dims = [names.index(a) if a in names else None for a in _axes(entry)]
        if None in dims:
            raise ValueError(f"spec {spec}: an axis of {entry!r} is not on "
                             f"the mesh {tuple(names)}")
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: axes {entry!r} are not in mesh "
                             f"order {tuple(names)}; DTensor would split "
                             f"them in another order than the spec says")
        for m in dims:
            if not isinstance(out[m], Replicate):
                raise ValueError(f"spec {spec}: axis {names[m]!r} used twice")
            out[m] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec (JAX's ``NamedSharding``); a leaf of the port's
    trees."""
    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The largest shard's shape (rank 0's), by arithmetic: each dim
        cut over the product of its axes' sizes, rounded up."""
        sizes = mesh_axis_sizes(self.mesh)
        out = list(shape)
        for d, entry in enumerate(self.spec[:len(out)]):
            for a in _axes(entry):
                out[d] = -(-out[d] // sizes[a])
        return tuple(out)

    def local_shape(self, t: torch.Tensor) -> Tuple[int, ...]:
        """Rank 0's local shape of ``t`` placed by this sharding, from
        ``distribute_tensor`` of a meta tensor of ``t``'s shape on the mesh
        (the fake process group's rank 0)."""
        return _local_shape(self.mesh, tuple(t.shape), t.dtype,
                            self.placements)


@functools.lru_cache(maxsize=4096)
def _local_shape(mesh, shape, dtype, places) -> Tuple[int, ...]:
    from torch.distributed.tensor import distribute_tensor
    x = torch.empty(shape, dtype=dtype, device="meta")
    return tuple(distribute_tensor(x, mesh, list(places)).to_local().shape)


def _fit(spec: tuple, shape) -> tuple:
    """Drop sharding on dims the spec ranks beyond the array rank."""
    return spec[:len(shape)] if len(spec) > len(shape) else spec


# ---------------------------------------------------------------------------
# LM params
# ---------------------------------------------------------------------------

_LM_RULES = [
    (r"embed$", P(None, "model")),
    (r"lm_head$", P("data", "model")),
    (r"router$", P(None, None)),
    # MoE expert stacks [E, d, f] / [E, f, d]: experts -> model (EP),
    # second dim -> data (FSDP)
    (r"moe/(wi|wg|wo)$", P("model", "data", None)),
    # dense / shared-expert MLP
    (r"(mlp|shared)/(wi|wg)$", P("data", "model")),
    (r"(mlp|shared)/wo$", P("model", "data")),
    # attention
    (r"attn/(wq|wk|wv)$", P("data", "model")),
    (r"attn/wo$", P("model", "data")),
    (r"attn/b[qkv]$", P("model")),
]


def lm_param_spec(path_str: str, ndim: int, fsdp_axes=("data",)) -> tuple:
    for pat, spec in _LM_RULES:
        if re.search(pat, path_str):
            # the FSDP dim extends over the pod axis on multi-pod meshes
            spec = P(*(fsdp_axes if a == "data" else a for a in spec))
            return _fit(spec, (0,) * ndim)
    return P()                                               # replicate


def _opt_wrap(rule_fn):
    """Optimizer state paths look like m/<param path> or v/<param path>."""
    def fn(path_str: str, leaf) -> tuple:
        m = re.match(r"^(m|v)/(.*)$", path_str)
        inner = m.group(2) if m else path_str
        if path_str == "step" or inner == "step":
            return P()
        # quantized moments QTensor(qcodes [Nblk, 256], qscale [Nblk]): flat
        # blocks shard over the whole mesh (the block count is padded to a
        # multiple of 512 in optim/adamw.py)
        if inner.endswith("/qcodes"):
            return P(("data", "model"), None)
        if inner.endswith("/qscale"):
            return P(("data", "model"))
        return rule_fn(inner, leaf.dim())
    return fn


def _tree_shardings(mesh, tree, spec_fn):
    paths, leaves = T.flatten_with_paths(tree)
    return T.unflatten(tree, [NamedSharding(mesh, spec_fn(p, x))
                              for p, x in zip(paths, leaves)])


def lm_shardings(mesh, cb) -> Any:
    """The argument shardings of an LM cell (train / prefill / decode)."""
    ba = batch_axes(mesh)
    fsdp = ba                                 # ("data",) or ("pod", "data")
    params_sh = _tree_shardings(mesh, cb.arg_specs[0],
                                lambda p, x: lm_param_spec(p, x.dim(), fsdp))
    if cb.kind == "train":
        opt_sh = _tree_shardings(
            mesh, cb.arg_specs[1],
            _opt_wrap(lambda p, nd: lm_param_spec(p, nd, fsdp)))
        batch_sh = {k: NamedSharding(mesh, P(ba, None))
                    for k in cb.arg_specs[2]}
        return (params_sh, opt_sh, batch_sh)

    if cb.kind == "prefill":
        return (params_sh, {"tokens": NamedSharding(mesh, P(ba, None))})

    # decode: cache [L, B, KVH, S, D]
    B = cb.arg_specs[1]["tokens"].shape[0]
    if B == 1:
        # long context: the KV sequence-sharded
        kv_spec = P(None, None, None, ("data", "model"), None)
        tok_spec, len_spec = P(None, None), P(None)
    else:
        kv_spec = P(None, ba, None, "model", None)
        tok_spec, len_spec = P(ba, None), P(ba)
    cache_sh = {"k": NamedSharding(mesh, kv_spec),
                "v": NamedSharding(mesh, kv_spec),
                "lengths": NamedSharding(mesh, len_spec)}
    return (params_sh, {"cache": cache_sh,
                        "tokens": NamedSharding(mesh, tok_spec)})


# ---------------------------------------------------------------------------
# GNN
# ---------------------------------------------------------------------------

def gnn_shardings(mesh, cb) -> Any:
    ba = batch_axes(mesh)
    rep = NamedSharding(mesh, P())
    params_sh = T.tree_map(lambda _: rep, cb.arg_specs[0])
    opt_sh = T.tree_map(lambda _: rep, cb.arg_specs[1])
    feature_sharded = (bool(cb.opt) and cb.arg_specs[2]["x"].shape[1]
                       % mesh_axis_sizes(mesh)["model"] == 0)

    def g_spec(key, leaf):
        if key in ("x", "pos"):
            if feature_sharded and key == "x":
                # the beyond-paper variant: features over "model" make the
                # x[src] gather local (node dim replicated)
                return P(None, "model")
            return P(ba, None)
        return P(ba) if leaf.dim() == 1 else P(ba, None)

    batch_sh = {k: (None if v is None else NamedSharding(mesh, g_spec(k, v)))
                for k, v in cb.arg_specs[2].items()}
    return (params_sh, opt_sh, batch_sh)


# ---------------------------------------------------------------------------
# recsys
# ---------------------------------------------------------------------------

def _sasrec_param_spec(path_str: str, ndim: int) -> tuple:
    return P("model", None) if path_str.endswith("item_emb") else P()


def sasrec_shardings(mesh, cb) -> Any:
    ba = batch_axes(mesh)
    params_sh = _tree_shardings(
        mesh, cb.arg_specs[0], lambda p, x: _sasrec_param_spec(p, x.dim()))
    if cb.kind == "train":
        opt_sh = _tree_shardings(mesh, cb.arg_specs[1],
                                 _opt_wrap(_sasrec_param_spec))
        batch_sh = {k: NamedSharding(mesh, P(ba, None))
                    for k in cb.arg_specs[2]}
        return (params_sh, opt_sh, batch_sh)
    sh = {}
    for k, v in cb.arg_specs[1].items():
        if k == "candidates":
            sh[k] = NamedSharding(mesh, P(None, ba))
        elif v.shape[0] == 1:
            sh[k] = NamedSharding(mesh, P(None, None))
        else:
            sh[k] = NamedSharding(mesh, P(ba, None))
    return (params_sh, sh)


def shardings_for_cell(mesh, cb) -> Any:
    if cb.family == "lm":
        return lm_shardings(mesh, cb)
    if cb.family == "gnn":
        return gnn_shardings(mesh, cb)
    return sasrec_shardings(mesh, cb)


def out_shardings_for_cell(mesh, cb, in_sh) -> Any:
    """Outputs: state stays sharded exactly like the inputs (params / opt /
    cache round-trip), scalars replicate, logits go vocab-parallel."""
    rep = NamedSharding(mesh, P())
    ba = batch_axes(mesh)
    if cb.kind == "train":
        return (rep, rep, in_sh[0], in_sh[1])   # loss, gnorm, params, opt
    if cb.kind == "prefill":
        kv_spec = P(None, ba, None, "model", None)
        cache_sh = {"k": NamedSharding(mesh, kv_spec),
                    "v": NamedSharding(mesh, kv_spec),
                    "lengths": NamedSharding(mesh, P(ba))}
        return (NamedSharding(mesh, P(ba, "model")), cache_sh)
    if cb.kind == "decode":
        B = cb.arg_specs[1]["tokens"].shape[0]
        return (NamedSharding(mesh, P(ba if B > 1 else None, "model")),
                in_sh[1]["cache"])
    if cb.kind in ("serve", "retrieval"):
        if cb.kind == "retrieval":
            return NamedSharding(mesh, P(None, ba))
        B = next(iter(cb.arg_specs[1].values())).shape[0]
        return NamedSharding(mesh, P(ba if B > 1 else None, "model"))
    return None
