"""Wrapper of the GTChain segment-sum kernel (``csrc/segment_sum.cu``).

``segment_matmul(data, seg, num_rows)`` is a drop-in for a segment sum,
like its JAX counterpart.  The wrapper owns the layout contract with plain
tensor ops (a stable sort of the destinations, out-of-range rows last, and
row offsets by ``searchsorted``); the kernel only reduces.  A CPU tensor
takes the plain version in :mod:`.ref`; a CUDA tensor launches the kernel.
"""
from __future__ import annotations

import torch

from repro_torch import backend
from repro_torch.kernels.segment_matmul.ref import segment_sum_ref

INT32_MAX = torch.iinfo(torch.int32).max


def sorted_layout(seg: torch.Tensor, num_rows: int):
    """``(order, row_ptr)``: stable destination order, invalid rows last,
    and each row's span ``row_ptr[r]:row_ptr[r + 1]`` of that order."""
    key = torch.where((seg >= 0) & (seg < num_rows), seg,
                      torch.full_like(seg, INT32_MAX))
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_rows + 1, dtype=torch.int32, device=seg.device)
    row_ptr = torch.searchsorted(sorted_key, bounds)
    return order, row_ptr


def segment_sum_sorted(data: torch.Tensor, order: torch.Tensor,
                       row_ptr: torch.Tensor, num_rows: int) -> torch.Tensor:
    """Launch the kernel over a stream already laid out by
    :func:`sorted_layout`; ``data`` is f32[E, F] on the card."""
    F = data.shape[1]
    out = torch.empty((num_rows, F), dtype=torch.float32, device=data.device)
    backend.launch("segment_sum", data.data_ptr(), order.data_ptr(),
                   row_ptr.data_ptr(), out.data_ptr(), num_rows, F)
    return out


def _check(data: torch.Tensor, seg: torch.Tensor) -> None:
    if data.dim() != 2 or seg.dim() != 1 or data.shape[0] != seg.shape[0]:
        raise ValueError(f"segment_matmul wants data[E, F] and seg[E], got "
                         f"{tuple(data.shape)} and {tuple(seg.shape)}")
    if data.dtype != torch.float32 or seg.dtype != torch.int32:
        raise TypeError(f"segment_matmul wants float32 data and int32 seg, "
                        f"got {data.dtype} and {seg.dtype}")
    if data.device != seg.device:
        raise ValueError("segment_matmul: data and seg on different devices")
    if not (data.is_contiguous() and seg.is_contiguous()):
        raise ValueError("segment_matmul wants contiguous tensors")


def segment_matmul(data: torch.Tensor, seg: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """Segment-sum of ``data`` rows by ``seg`` -> f32[num_rows, F]."""
    _check(data, seg)
    if data.device.type == "cpu":
        return segment_sum_ref(data, seg, num_rows)
    if data.device.type != "cuda":
        raise ValueError(f"segment_matmul: unsupported device {data.device}")
    order, row_ptr = sorted_layout(seg, num_rows)
    return segment_sum_sorted(data, order, row_ptr, num_rows)
