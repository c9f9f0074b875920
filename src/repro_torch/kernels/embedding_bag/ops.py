"""Wrappers of the EmbeddingBag kernel (``csrc/embedding_bag.cu``).

``embedding_bag(table, bag_ids, weights)`` takes fixed-length ``[B, L]``
bags, as ``repro.kernels.embedding_bag.embedding_bag`` does;
``embedding_bag_sorted(table, ids, seg, weights, num_bags)`` takes a flat
stream of slots sorted by bag, as the Pallas kernel does, and turns ``seg``
into bag offsets with ``searchsorted``.  A CPU tensor takes the plain
version in :mod:`.ref`; a CUDA tensor launches a kernel, chosen from the
shape by :func:`kernel_route`: fixed-length bags of 1-4 slots (the SASRec
lookup's one-slot bags) go to the short-bag kernel, every other shape to
the warp-per-bag kernel.  A meta tensor gives the output's shape alone
(the dry run).  Float32 tables only.
"""
from __future__ import annotations

from numbers import Real
from typing import Union

import torch

from repro_torch import backend
from repro_torch.kernels.embedding_bag.ref import (embedding_bag_ref,
                                                   embedding_bag_sorted_ref)


def _check(table: torch.Tensor, ids: torch.Tensor, ids_dim: int) -> None:
    if table.dim() != 2 or ids.dim() != ids_dim:
        raise ValueError(f"embedding_bag wants table[V, F] and {ids_dim}-D "
                         f"ids, got {tuple(table.shape)} and "
                         f"{tuple(ids.shape)}")
    if table.shape[0] == 0:
        raise ValueError("embedding_bag: empty table")
    if table.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"embedding_bag wants a float32 table and int32 ids, "
                        f"got {table.dtype} and {ids.dtype}")
    if table.device != ids.device:
        raise ValueError("embedding_bag: table and ids on different devices")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("embedding_bag wants contiguous tensors")
    if table.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"embedding_bag: unsupported device {table.device}")


SHORT_BAG_MAX = 4       # longest fixed-length bag of the short-bag kernel


def kernel_route(num_bags: int, bag_len: int, F: int) -> str:
    """The kernel a CUDA call launches for ``num_bags`` bags of ``bag_len``
    slots (0 for a ragged stream) and ``F`` columns: ``"short_bags"`` for
    fixed-length bags of 1 to :data:`SHORT_BAG_MAX` slots (each thread owns
    a few output vectors and loads their ids before their rows),
    ``"warp_per_bag"`` for ragged streams and longer bags.  A dispatch on
    the shape: both are kernels, and both give the same bits.  The C entry
    point picks by the same rule (``kShortMax`` there is this
    :data:`SHORT_BAG_MAX`); this mirror names the kernel for tests and
    reports."""
    if num_bags > 0 and F > 0 and 1 <= bag_len <= SHORT_BAG_MAX:
        return "short_bags"
    return "warp_per_bag"


def _check_weights(weights: torch.Tensor, table: torch.Tensor) -> None:
    if weights.dtype != torch.float32:
        raise TypeError(f"embedding_bag wants float32 weights, got "
                        f"{weights.dtype}")
    if weights.device != table.device:
        raise ValueError("embedding_bag: weights on another device")


def _launch(table, ids, weights, weight: float, row_ptr, bag_len: int,
            num_bags: int) -> torch.Tensor:
    V, F = table.shape
    out = torch.empty((num_bags, F), dtype=torch.float32, device=table.device)
    backend.launch("embedding_bag", table.data_ptr(), ids.data_ptr(),
                   None if weights is None else weights.data_ptr(), weight,
                   None if row_ptr is None else row_ptr.data_ptr(),
                   out.data_ptr(), num_bags, bag_len, F, V)
    return out


def embedding_bag(table: torch.Tensor, bag_ids: torch.Tensor,
                  weights: Union[torch.Tensor, Real, None] = None
                  ) -> torch.Tensor:
    """out[b] = sum_l w[b, l] * table[bag_ids[b, l]]  (ids -1 = padding).

    ``bag_ids`` int32 [B, L]; ``weights`` a float32 tensor broadcastable to
    [B, L], a number (rounded to float32) that weights every slot alike, or
    None for a plain sum.  A number reaches the kernel as it is, with no
    [B, L] weight tensor.
    """
    _check(table, bag_ids, 2)
    if isinstance(weights, torch.Tensor):
        _check_weights(weights, table)
    elif weights is not None and not isinstance(weights, Real):
        raise TypeError(f"embedding_bag wants tensor, number or None "
                        f"weights, got {type(weights).__name__}")
    if table.device.type == "cpu":
        return embedding_bag_ref(table, bag_ids, weights)
    if table.device.type == "meta":
        return table.new_empty((bag_ids.shape[0], table.shape[1]))
    B, L = bag_ids.shape
    if not isinstance(weights, torch.Tensor):
        weight = 1.0 if weights is None else float(weights)
        return _launch(table, bag_ids, None, weight, None, L, B)
    return _launch(table, bag_ids, weights.expand(B, L).contiguous(), 0.0,
                   None, L, B)


def embedding_bag_sorted(table: torch.Tensor, ids: torch.Tensor,
                         seg: torch.Tensor, weights: torch.Tensor,
                         num_bags: int) -> torch.Tensor:
    """out[b] = sum_{i: seg[i] == b} weights[i] * table[ids[i]].

    ``ids``, ``seg`` int32 [N] and ``weights`` float32 [N]; ``seg`` must be
    sorted ascending.  Slots whose ``seg`` is outside [0, num_bags) are
    dropped; a bag with no slot is 0.
    """
    _check(table, ids, 1)
    _check_weights(weights, table)
    if seg.shape != ids.shape or weights.shape != ids.shape:
        raise ValueError(f"embedding_bag_sorted wants ids, seg and weights "
                         f"of one shape, got {tuple(ids.shape)}, "
                         f"{tuple(seg.shape)}, {tuple(weights.shape)}")
    if seg.dtype != torch.int32:
        raise TypeError(f"embedding_bag_sorted wants int32 seg, got "
                        f"{seg.dtype}")
    if seg.device != ids.device:
        raise ValueError("embedding_bag_sorted: seg on another device")
    if not (seg.is_contiguous() and weights.is_contiguous()):
        raise ValueError("embedding_bag_sorted wants contiguous tensors")
    if table.device.type == "cpu":
        return embedding_bag_sorted_ref(table, ids, seg, weights, num_bags)
    if table.device.type == "meta":
        return table.new_empty((num_bags, table.shape[1]))
    bounds = torch.arange(num_bags + 1, dtype=torch.int32, device=seg.device)
    row_ptr = torch.searchsorted(seg, bounds)
    return _launch(table, ids, weights, 0.0, row_ptr, 0, num_bags)
