"""Paged KV cache: CBList's storage discipline applied to serving, as in
``repro.models.transformer.kvcache``.

A sequence's KV history is a chain of pages in a fixed pool, as a vertex's
edges are a chain of blocks in CBList: appending a token fills the tail
page's slack, else pops a page from the free stack; the block table is each
sequence's chain; decode attention reads the chain through the paged kernel.

The functions are pure unless told otherwise: they clone what they write and
return a new cache.  ``inplace=True`` writes into the given cache's tensors
instead; the serve loop owns its caches and uses it, so a decode step does
not copy the pool.  An in-place ``append`` also writes the block table,
lengths and free-stack top into the cache's own tensors, so every address
stays fixed from step to step, as a captured CUDA graph needs.

Out-of-range ids are handled explicitly where JAX relies on its scatter and
gather modes: a token whose page could not be allocated (the pool ran dry,
page id ``P``) or whose slot was never allocated (``-1``) is not written,
and ``attend`` clamps ``-1`` to page 0 as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.backend import resolve_device
from repro_torch.kernels.paged_attention import decode_attention


class PagedKVCache(NamedTuple):
    k_pages: torch.Tensor      # [KVH, P, page, D]
    v_pages: torch.Tensor      # [KVH, P, page, D]
    block_table: torch.Tensor  # i32[B, NP_max]  (-1 = unallocated)
    lengths: torch.Tensor      # i32[B]
    free_stack: torch.Tensor   # i32[P]
    free_top: torch.Tensor     # i32[]

    @property
    def page_size(self) -> int:
        return self.k_pages.shape[2]


def init_paged_cache(batch: int, n_kv_heads: int, head_dim: int,
                     num_pages: int, page_size: int = 128,
                     max_pages_per_seq: int = 0, dtype=torch.bfloat16,
                     device=None) -> PagedKVCache:
    dev = resolve_device(device)
    npmax = max_pages_per_seq or num_pages // batch
    pages = (n_kv_heads, num_pages, page_size, head_dim)
    i32 = dict(dtype=torch.int32, device=dev)
    return PagedKVCache(
        k_pages=torch.zeros(pages, dtype=dtype, device=dev),
        v_pages=torch.zeros(pages, dtype=dtype, device=dev),
        block_table=torch.full((batch, npmax), -1, **i32),
        lengths=torch.zeros((batch,), **i32),
        free_stack=torch.arange(num_pages - 1, -1, -1, **i32),
        free_top=torch.tensor(num_pages, **i32))


def _pages(cache: PagedKVCache, inplace: bool):
    if inplace:
        return cache.k_pages, cache.v_pages
    return cache.k_pages.clone(), cache.v_pages.clone()


def append(cache: PagedKVCache, k_new: torch.Tensor, v_new: torch.Tensor, *,
           inplace: bool = False) -> PagedKVCache:
    """Append one token's K/V to every sequence.  k_new, v_new [B, KVH, D].

    Leaves the state bit-identical to JAX ``append``, with no host sync.
    With ``inplace`` the returned cache holds the given cache's own tensors,
    each updated in place.
    """
    B = k_new.shape[0]
    page = cache.page_size
    P = cache.k_pages.shape[1]
    npmax = cache.block_table.shape[1]
    lengths = cache.lengths
    need = (lengths % page) == 0                         # a new page needed
    # vectorised free-stack pop (as blockstore.alloc_blocks)
    need_i = need.to(torch.int32)
    rank = torch.cumsum(need_i, 0, dtype=torch.int32) - need_i
    idx = cache.free_top - 1 - rank
    new_page = torch.where(need & (idx >= 0),
                           cache.free_stack[idx.clamp(min=0).long()], P)
    n_new = need_i.sum(dtype=torch.int32)

    slot = (lengths // page).clamp(max=npmax - 1).long()
    b_idx = torch.arange(B, device=lengths.device)
    bt = cache.block_table if inplace else cache.block_table.clone()
    bt[b_idx, slot] = torch.where(need, new_page.to(torch.int32),
                                  bt[b_idx, slot])
    page_id = bt[b_idx, slot]                            # P if alloc failed
    offset = (lengths % page).long()

    # rows whose page is outside the pool are not written.  To stay free of
    # host syncs they repeat the first valid row's write (same place, same
    # value); with no valid row at all every row rewrites page 0, offset 0
    # with its own current contents
    ok = (page_id >= 0) & (page_id < P)
    src = torch.where(ok, b_idx, torch.argmax(ok.to(torch.int32)))
    ok_src = ok[src]
    dst_page = torch.where(ok_src, page_id[src], 0).long()
    dst_off = torch.where(ok_src, offset[src], 0)
    k_pages, v_pages = _pages(cache, inplace)
    for pool, new in ((k_pages, k_new), (v_pages, v_new)):
        vals = torch.where(ok_src[None, :, None],
                           new[src].transpose(0, 1).to(pool.dtype),
                           pool[:, 0, 0][:, None, :])
        pool[:, dst_page, dst_off] = vals
    if inplace:
        lengths.add_(1)
        cache.free_top.sub_(n_new)
        return cache
    return cache._replace(k_pages=k_pages, v_pages=v_pages, block_table=bt,
                          lengths=lengths + 1,
                          free_top=cache.free_top - n_new)


def append_many(cache: PagedKVCache, k_seq: torch.Tensor, v_seq: torch.Tensor,
                counts: Optional[torch.Tensor] = None, *,
                inplace: bool = False) -> PagedKVCache:
    """Append ``counts[b]`` tokens to sequence b in one vectorised pass.

    k_seq, v_seq [B, KVH, T, D]; token t of sequence b is appended when
    ``t < counts[b]`` (all T when ``counts`` is None).  The result is that of
    T successive :func:`append` calls in which, at step t, only the sequences
    with ``t < counts[b]`` append: pages are popped in (step, sequence)
    order.  One host sync (the count of page allocations).
    """
    B, _, T, _ = k_seq.shape
    page = cache.page_size
    P = cache.k_pages.shape[1]
    npmax = cache.block_table.shape[1]
    dev = k_seq.device
    L0 = cache.lengths.long()
    counts = (torch.full((B,), T, device=dev) if counts is None
              else counts.to(dev).long())
    t = torch.arange(T, device=dev)
    live = t[None, :] < counts[:, None]                   # [B, T]
    pos = L0[:, None] + t[None, :]
    need = live & (pos % page == 0)
    # page allocations in the order of the step-by-step appends
    ev_t, ev_b = need.T.nonzero(as_tuple=True)
    n_ev = ev_t.numel()
    idx = cache.free_top.long() - 1 - torch.arange(n_ev, device=dev)
    ev_page = torch.where(idx >= 0,
                          cache.free_stack[idx.clamp(min=0)].long(), P)
    ev_slot = (pos[ev_b, ev_t] // page).clamp(max=npmax - 1)

    # block table: the last allocation into each (sequence, slot) stays
    key = ev_b * npmax + ev_slot
    sorted_key, perm = torch.sort(key, stable=True)
    last = torch.ones_like(sorted_key, dtype=torch.bool)
    last[:-1] = sorted_key[1:] != sorted_key[:-1]
    keep = perm[last]
    bt = cache.block_table.clone()
    bt.view(-1)[key[keep]] = ev_page[keep].to(torch.int32)

    # each token's page: that of the allocation at its page's first position
    # when it fell in this call, else the slot's entry from before the call
    start = (pos // page) * page
    ev_page_at = torch.full((B, T), P, dtype=torch.long, device=dev)
    ev_page_at[ev_b, ev_t] = ev_page
    fresh = start >= L0[:, None]
    slot = (pos // page).clamp(max=npmax - 1)
    before = cache.block_table.gather(1, slot).long()
    tok_page = torch.where(
        fresh, ev_page_at.gather(1, (start - L0[:, None]).clamp(0, T - 1)),
        before)
    write = live & (tok_page >= 0) & (tok_page < P)
    b_w, t_w = write.nonzero(as_tuple=True)
    k_pages, v_pages = _pages(cache, inplace)
    for pool, new in ((k_pages, k_seq), (v_pages, v_seq)):
        pool[:, tok_page[b_w, t_w], pos[b_w, t_w] % page] = \
            new[b_w, :, t_w].transpose(0, 1).to(pool.dtype)
    return cache._replace(
        k_pages=k_pages, v_pages=v_pages, block_table=bt,
        lengths=(L0 + counts).to(torch.int32),
        free_top=(cache.free_top - n_ev).to(torch.int32))


def attend(cache: PagedKVCache, q: torch.Tensor, *, scale: float,
           window: int = 0, softcap: float = 0.0,
           impl: str = "cuda") -> torch.Tensor:
    """q [B, H, D] (one token per sequence) -> [B, H, D]."""
    B, H, D = q.shape
    KVH = cache.k_pages.shape[0]
    qg = q.reshape(B, KVH, H // KVH, D)
    bt = cache.block_table.clamp(min=0)
    o = decode_attention(qg, cache.k_pages, cache.v_pages, bt, cache.lengths,
                         scale=scale, window=window, softcap=softcap,
                         impl=impl)
    return o.reshape(B, H, D)
