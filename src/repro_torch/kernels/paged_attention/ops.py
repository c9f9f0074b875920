"""Paged decode attention: the ``impl`` switch and the wrapper of the
paged kernel (``csrc/paged_attention.cu``).

``decode_attention(..., impl="torch")`` is the plain version (the JAX
package's ``impl="xla"``); ``impl="cuda"`` goes through
:func:`paged_attention`, which runs the plain version for a CPU tensor and
launches the kernel for a CUDA tensor.
"""
from __future__ import annotations

import torch

from repro_torch import backend
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 2048       # G * D rounded up to 64, 128 or 256
MAX_GROUP = 32


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


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, *, scale: float, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """One decode step: q [B, KVH, G, D] over the first ``lengths[b]`` keys
    of the pages [KVH, P, page, D] that ``block_table`` names.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    _check(q, k_pages, v_pages, block_table, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pages, v_pages, block_table, lengths,
                                   scale=scale, window=window,
                                   softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    q, k_pages, v_pages, block_table, lengths = (
        x.contiguous() for x in (q, k_pages, v_pages, block_table, lengths))
    B, KVH, G, D = q.shape
    o = torch.empty_like(q)
    backend.launch("paged_attention", q.data_ptr(), k_pages.data_ptr(),
                   v_pages.data_ptr(), block_table.data_ptr(),
                   lengths.data_ptr(), o.data_ptr(),
                   backend.DTYPE_FLAGS[q.dtype], B, KVH, G, D,
                   k_pages.shape[1], k_pages.shape[2], block_table.shape[1],
                   float(scale), int(window), float(softcap))
    return o


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
