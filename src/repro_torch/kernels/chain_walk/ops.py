"""Wrappers of the chain-walk kernels (``csrc/chain_walk.cu``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
Neither wrapper synchronises the host: outputs are sized by the inputs'
shapes, never by the data.
"""
from __future__ import annotations

import torch

from repro_torch import backend
from repro_torch.kernels.chain_walk.ref import locate_ref, rank_walk_ref


def _check(what: str, tensors: dict, dtype) -> None:
    dev = None
    for name, x in tensors.items():
        want = torch.bool if name == "active" else dtype
        if x.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if dev is None:
            dev = x.device
        elif x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")


def locate(keys: torch.Tensor, nxt: torch.Tensor, v_head: torch.Tensor,
           qsrc: torch.Tensor, qdst: torch.Tensor, active: torch.Tensor):
    """FindNeighbor over a CBList store: ``(found_blk, found_lane)`` i32 of
    each query, the first block in chain order of vertex
    ``clamp(qsrc, 0, NV - 1)`` holding ``qdst``; NULL when absent or when
    ``active`` is False."""
    _check("locate", dict(keys=keys, nxt=nxt, v_head=v_head, qsrc=qsrc,
                          qdst=qdst, active=active), torch.int32)
    if keys.dim() != 2 or qsrc.shape != qdst.shape or \
            qsrc.shape != active.shape or qsrc.dim() != 1:
        raise ValueError("locate wants keys[NB, B] and 1-D queries of one "
                         "length")
    if keys.device.type == "cpu":
        return locate_ref(keys, nxt, v_head, qsrc, qdst, active)
    n = qsrc.shape[0]
    fblk = torch.empty(n, dtype=torch.int32, device=keys.device)
    flane = torch.empty(n, dtype=torch.int32, device=keys.device)
    if n:
        backend.launch("chain_walk_locate", keys.data_ptr(), nxt.data_ptr(),
                       v_head.data_ptr(), qsrc.data_ptr(), qdst.data_ptr(),
                       active.data_ptr(), fblk.data_ptr(), flane.data_ptr(),
                       n, keys.shape[1], v_head.shape[0])
    return fblk, flane


def rank_walk(keys: torch.Tensor, count: torch.Tensor, nxt: torch.Tensor,
              heads: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """``out[v, j]``: the key at rank ``ranks[v, j]`` of the chain that
    starts at block ``heads[v]``, walking blocks by their fill count; NULL
    for a NULL head or a rank past the chain's end."""
    _check("rank_walk", dict(keys=keys, count=count, nxt=nxt, heads=heads,
                             ranks=ranks), torch.int32)
    if keys.dim() != 2 or ranks.dim() != 2 or heads.dim() != 1 \
            or ranks.shape[0] != heads.shape[0]:
        raise ValueError("rank_walk wants keys[NB, B], heads[V] and "
                         "ranks[V, k]")
    if keys.device.type == "cpu":
        return rank_walk_ref(keys, count, nxt, heads, ranks)
    V, k = ranks.shape
    out = torch.empty((V, k), dtype=torch.int32, device=keys.device)
    if V and k:
        backend.launch("chain_walk_rank", keys.data_ptr(), count.data_ptr(),
                       nxt.data_ptr(), heads.data_ptr(), ranks.data_ptr(),
                       out.data_ptr(), V, k, keys.shape[1])
    return out
