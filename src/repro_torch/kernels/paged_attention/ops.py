"""Paged decode attention: the ``impl`` switch and the wrappers of the
split-KV paged kernel (``csrc/paged_attention.cu``).

``decode_attention(..., impl="torch")`` is the plain version (the JAX
package's ``impl="xla"``); ``impl="cuda"`` goes through
:func:`paged_attention`, which runs the plain version for a CPU tensor and
launches the kernel for a CUDA tensor, at the split size
:func:`split_pages` picks from the shapes.  :func:`paged_attention_split`
is the kernel at a given split size, and its CPU counterpart the split
kernel's plain arithmetic (``paged_attention_split_ref``).
"""
from __future__ import annotations

import torch

from repro_torch import backend
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_attention_split_ref)

MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 2048       # G * D rounded up to 64, 128 or 256
MAX_GROUP = 32
# the split kernel keeps 3 CTAs on each SM; a grid of this many waves of
# them balances splits of unequal live length
CTAS_PER_SM, WAVES = 3, 4


def _padded_head_dim(D: int) -> int:
    return 64 if D <= 64 else 128 if D <= 128 else 256


def _check(q, k_pages, v_pages, block_table, lengths) -> None:
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"paged_attention wants q[B, KVH, G, D] and pages"
                         f"[KVH, P, page, D], got {tuple(q.shape)}, "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    B, KVH, G, D = q.shape
    if (k_pages.shape[0], k_pages.shape[3]) != (KVH, D):
        raise ValueError(f"paged_attention: pages {tuple(k_pages.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"paged_attention wants block_table[{B}, NP] and "
                         f"lengths[{B}], got {tuple(block_table.shape)} and "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in backend.DTYPE_FLAGS or not q.dtype == k_pages.dtype \
            == v_pages.dtype:
        raise TypeError(f"paged_attention wants float32 or bfloat16 q and "
                        f"pages of one type, got {q.dtype}, {k_pages.dtype}, "
                        f"{v_pages.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention wants int32 block_table and lengths")
    if len({t.device for t in (q, k_pages, v_pages, block_table,
                               lengths)}) != 1:
        raise ValueError("paged_attention: inputs on different devices")
    if D > MAX_HEAD_DIM or G > MAX_GROUP or \
            G * _padded_head_dim(D) > MAX_GROUP_WIDTH:
        raise ValueError(f"paged_attention: G = {G}, D = {D} exceed the "
                         f"kernel's G <= {MAX_GROUP}, G * D <= "
                         f"{MAX_GROUP_WIDTH}, D <= {MAX_HEAD_DIM}")


def split_pages(npmax: int, batch: int, kv_heads: int, sms: int) -> int:
    """Block-table slots a split covers: enough splits that ``batch *
    kv_heads * n_split`` CTAs fill ``WAVES`` waves of ``sms`` SMs.  From
    the shapes alone, never from the lengths, so a captured CUDA graph
    stays valid as the sequences grow."""
    want = -(-WAVES * CTAS_PER_SM * sms // max(1, batch * kv_heads))
    return -(-npmax // max(1, min(npmax, want)))


def paged_attention_split(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, block_table: torch.Tensor,
                          lengths: torch.Tensor, *, scale: float,
                          window: int = 0, softcap: float = 0.0,
                          pages_per_split: int) -> torch.Tensor:
    """:func:`paged_attention` with each split covering
    ``pages_per_split`` block-table slots.

    A CPU tensor takes the split kernel's plain arithmetic
    (``paged_attention_split_ref``); a CUDA tensor launches the kernel.
    """
    _check(q, k_pages, v_pages, block_table, lengths)
    npmax = block_table.shape[1]
    if not 1 <= pages_per_split <= npmax:
        raise ValueError(f"paged_attention: pages_per_split must be in "
                         f"[1, {npmax}], got {pages_per_split}")
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return paged_attention_split_ref(q, k_pages, v_pages, block_table,
                                         lengths, scale=scale, window=window,
                                         softcap=softcap,
                                         pages_per_split=pages_per_split)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    q, k_pages, v_pages, block_table, lengths = (
        x.contiguous() for x in (q, k_pages, v_pages, block_table, lengths))
    B, KVH, G, D = q.shape
    n_split = -(-npmax // pages_per_split)
    o = torch.empty_like(q)
    f32 = dict(dtype=torch.float32, device=q.device)
    o_part = torch.empty((B, KVH, n_split, G, D), **f32)
    ml_part = torch.empty((B, KVH, n_split, G, 2), **f32)
    backend.launch("paged_attention", q.data_ptr(), k_pages.data_ptr(),
                   v_pages.data_ptr(), block_table.data_ptr(),
                   lengths.data_ptr(), o.data_ptr(), o_part.data_ptr(),
                   ml_part.data_ptr(), backend.DTYPE_FLAGS[q.dtype], B, KVH,
                   G, D, k_pages.shape[1], k_pages.shape[2], npmax,
                   int(pages_per_split), float(scale), int(window),
                   float(softcap))
    return o


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """One decode step: q [B, KVH, G, D] over the first ``lengths[b]`` keys
    of the pages [KVH, P, page, D] that ``block_table`` names.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    at the split size :func:`split_pages` picks for the card.
    """
    _check(q, k_pages, v_pages, block_table, lengths)
    if q.device.type == "meta":
        return torch.empty_like(q)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                                   scale=scale, window=window,
                                   softcap=softcap)
    B, KVH = q.shape[:2]
    sms = (torch.cuda.get_device_properties(q.device).multi_processor_count
           if q.device.type == "cuda" else 1)
    return paged_attention_split(
        q, k_pages, v_pages, block_table, lengths, scale=scale,
        window=window, softcap=softcap,
        pages_per_split=split_pages(block_table.shape[1], B, KVH, sms))


def decode_attention(q, k_pages, v_pages, block_table, lengths, *,
                     scale: float, window: int = 0, softcap: float = 0.0,
                     impl: str = "cuda") -> torch.Tensor:
    """Paged decode attention through the plain version or the kernel."""
    if backend.resolve_impl(impl) == "torch":
        return paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                                   scale=scale, window=window,
                                   softcap=softcap)
    return paged_attention(q, k_pages, v_pages, block_table, lengths,
                           scale=scale, window=window, softcap=softcap)
