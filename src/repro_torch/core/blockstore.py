"""Fixed-capacity blocked storage: the CBList allocator substrate, in torch.

A pool of fixed-width blocks with a free-stack allocator, singly-linked
per-owner chains (``nxt``) and per-block owner + sequence number, so the
Global Traversal Chain order is one sort instead of a pointer walk.

Every mutator returns a new store and never writes into a tensor it was
given: pinned snapshots and the service's grow-retry share tensors with the
store they started from.  Store arrays stay int32, as in the JAX package, so
layouts compare bit for bit; indices are cast to int64 where torch needs it.
JAX drops out-of-range scatter indices (``mode="drop"``); torch would raise
or wrap a NULL (-1) index onto the last row, so every scatter here masks its
indices explicitly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

PAD = torch.iinfo(torch.int32).max    # empty key lane: sorts last in a block
NULL = -1                             # null block / vertex id

I32 = torch.int32


class BlockStore(NamedTuple):
    """Pool of ``num_blocks`` blocks of ``block_width`` int32 keys + f32 values."""

    keys: torch.Tensor        # i32[NB, B]  sorted ascending within block, PAD-filled
    vals: torch.Tensor        # f32[NB, B]  payload per key lane
    count: torch.Tensor       # i32[NB]     live lanes per block
    owner: torch.Tensor       # i32[NB]     owning logical id (NULL when free)
    nxt: torch.Tensor         # i32[NB]     next block in the owner chain
    seq: torch.Tensor         # i32[NB]     position within the owner chain
    free_stack: torch.Tensor  # i32[NB]     stack of free block ids
    free_top: torch.Tensor    # i32[]       number of free blocks

    @property
    def num_blocks(self) -> int:
        return self.keys.shape[0]

    @property
    def block_width(self) -> int:
        return self.keys.shape[1]

    @property
    def device(self) -> torch.device:
        return self.keys.device


def arange32(n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=I32, device=device)


def full32(shape, value: int, device) -> torch.Tensor:
    return torch.full(shape if isinstance(shape, tuple) else (shape,), value,
                      dtype=I32, device=device)


def composite_key(major: torch.Tensor, minor: torch.Tensor) -> torch.Tensor:
    """int64 key ordering by ``major`` then ``minor`` (both non-negative
    int32): one sort of it is ``jnp.lexsort((minor, major))``."""
    return major.long() * (1 << 32) + minor.long()


def keep_last(src: torch.Tensor, dst: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """bool mask of the LAST occurrence of each (src, dst) among valid
    entries (a stable sort keeps arrival order within a key)."""
    pad = torch.full_like(src, PAD)
    key = composite_key(torch.where(valid, src, pad),
                        torch.where(valid, dst, pad))
    skey, order = torch.sort(key, stable=True)
    is_last = torch.ones_like(valid)
    is_last[:-1] = skey[:-1] != skey[1:]
    keep = torch.zeros_like(valid)
    keep[order] = is_last
    return keep & valid


def stable_argsort(key: torch.Tensor) -> torch.Tensor:
    return torch.sort(key, stable=True)[1]


def inverse_permutation(order: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.numel(), dtype=order.dtype,
                              device=order.device)
    return inv


def segment_count(seg: torch.Tensor, valid: torch.Tensor,
                  n: int) -> torch.Tensor:
    """i32[n]: number of valid lanes per segment (out-of-range dropped)."""
    ok = valid & (seg >= 0) & (seg < n)
    return torch.bincount(seg[ok].long(), minlength=n)[:n].to(I32)


def segment_sum_int(vals: torch.Tensor, seg: torch.Tensor,
                    n: int) -> torch.Tensor:
    """i32[n] integer segment sum (out-of-range ids dropped; float64
    weights hold integer sums exactly, so the result is deterministic)."""
    ok = (seg >= 0) & (seg < n)
    return torch.bincount(seg[ok].long(), weights=vals[ok].double(),
                          minlength=n)[:n].to(I32)


def make_store(num_blocks: int, block_width: int, device=None) -> BlockStore:
    """An empty store; all blocks on the free stack (top of stack = block 0)."""
    return BlockStore(
        keys=full32((num_blocks, block_width), PAD, device),
        vals=torch.zeros((num_blocks, block_width), dtype=torch.float32,
                         device=device),
        count=torch.zeros(num_blocks, dtype=I32, device=device),
        owner=full32(num_blocks, NULL, device),
        nxt=full32(num_blocks, NULL, device),
        seq=torch.zeros(num_blocks, dtype=I32, device=device),
        # free_stack[top-1] is the next block handed out: blocks are
        # allocated in ascending physical order (GTChain contiguity)
        free_stack=torch.arange(num_blocks - 1, -1, -1, dtype=I32,
                                device=device),
        free_top=torch.tensor(num_blocks, dtype=I32, device=device),
    )


def alloc_blocks(store: BlockStore, k_max: int, k: torch.Tensor):
    """Pop up to ``k`` blocks (static bound ``k_max``) from the free stack.

    Returns ``(store, ids)`` where ``ids`` is i32[k_max]; entries >= k, and
    those past the free blocks left, are NULL.
    """
    slots = arange32(k_max, store.device)
    idx = store.free_top - 1 - slots
    ok = (slots < k) & (idx >= 0)
    ids = torch.where(ok, store.free_stack[idx.clamp(min=0).long()],
                      full32(k_max, NULL, store.device))
    new_top = store.free_top - torch.minimum(k.to(I32), store.free_top)
    return store._replace(free_top=new_top), ids


def free_blocks(store: BlockStore, ids: torch.Tensor) -> BlockStore:
    """Push block ids (NULL entries ignored) back onto the free stack and
    reset them."""
    valid = ids != NULL
    ids_c = ids[valid]                         # valid ids, order preserved
    k = ids_c.numel()
    pos = store.free_top.long() + torch.arange(k, device=store.device)
    keep = pos < store.num_blocks
    fs = store.free_stack.clone()
    fs[pos[keep]] = ids_c[keep]
    rows = ids_c.long()

    def reset(x, fill):
        x = x.clone()
        x[rows] = fill
        return x

    return store._replace(
        free_stack=fs,
        free_top=store.free_top + k,
        keys=reset(store.keys, PAD),
        vals=reset(store.vals, 0.0),
        count=reset(store.count, 0),
        owner=reset(store.owner, NULL),
        nxt=reset(store.nxt, NULL),
        seq=reset(store.seq, 0),
    )


def free_blocks_left(store: BlockStore) -> torch.Tensor:
    return store.free_top


def grow_store(store: BlockStore, new_num_blocks: int) -> BlockStore:
    """Grow the pool to ``new_num_blocks`` blocks (pure pad, no data motion).

    Existing blocks keep their ids, so every chain pointer, owner record and
    vertex head/tail stays valid.  The new blocks go *under* the existing
    free entries: allocation hands out the old free blocks first, then the
    new ids in ascending physical order.
    """
    nb = store.num_blocks
    if new_num_blocks < nb:
        raise ValueError(f"grow_store: {new_num_blocks} < current {nb}")
    if new_num_blocks == nb:
        return store
    k = new_num_blocks - nb
    dev = store.device

    def pad_rows(x, fill):
        return torch.cat([x, torch.full((k,) + tuple(x.shape[1:]), fill,
                                        dtype=x.dtype, device=dev)])

    fresh = torch.arange(new_num_blocks - 1, nb - 1, -1, dtype=I32, device=dev)
    return BlockStore(
        keys=pad_rows(store.keys, PAD),
        vals=pad_rows(store.vals, 0.0),
        count=pad_rows(store.count, 0),
        owner=pad_rows(store.owner, NULL),
        nxt=pad_rows(store.nxt, NULL),
        seq=pad_rows(store.seq, 0),
        free_stack=torch.cat([fresh, store.free_stack]),
        free_top=store.free_top + k,
    )


def gtchain_order(store: BlockStore) -> torch.Tensor:
    """Block ids in Global-Traversal-Chain order (owner-major, chain-seq
    minor); free blocks sort to the end.  i64[NB]."""
    owner = torch.where(store.owner == NULL, full32(store.num_blocks, PAD,
                                                    store.device), store.owner)
    return stable_argsort(composite_key(owner, store.seq))


def gtchain_contiguity(store: BlockStore) -> torch.Tensor:
    """Fraction of GTChain-adjacent live block pairs that are physically
    adjacent (the tuner's ``P_h``); 1.0 right after build/compact."""
    order = gtchain_order(store)
    live = store.owner[order] != NULL
    adj = (order[1:] - order[:-1]) == 1
    pair_live = live[1:] & live[:-1]
    n = pair_live.sum().clamp(min=1)
    return (adj & pair_live).sum().float() / n.float()


def sort_blocks(store: BlockStore, block_ids: torch.Tensor) -> BlockStore:
    """Re-sort the key lanes of the given blocks (dupes allowed, NULL
    ignored, PAD trails)."""
    ids = torch.unique(block_ids[block_ids != NULL]).long()
    rows_k, order = torch.sort(store.keys[ids], dim=1, stable=True)
    rows_v = torch.gather(store.vals[ids], 1, order)
    keys = store.keys.clone()
    vals = store.vals.clone()
    keys[ids] = rows_k
    vals[ids] = rows_v
    return store._replace(keys=keys, vals=vals)


def compact(store: BlockStore) -> BlockStore:
    """Physically permute blocks into GTChain order (defragmentation)."""
    order = gtchain_order(store)                      # new position -> old id
    inv = inverse_permutation(order).to(I32)          # old id -> new position
    nxt = store.nxt[order]
    nxt = torch.where(nxt == NULL, nxt, inv[nxt.clamp(min=0).long()])
    n_live = (store.owner != NULL).sum().to(I32)
    nb = store.num_blocks
    return BlockStore(
        keys=store.keys[order],
        vals=store.vals[order],
        count=store.count[order],
        owner=store.owner[order],
        nxt=nxt,
        seq=store.seq[order],
        free_stack=torch.arange(nb - 1, -1, -1, dtype=I32, device=store.device),
        free_top=nb - n_live,
    )
