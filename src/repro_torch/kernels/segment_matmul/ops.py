"""Wrappers of the GTChain segment-sum kernel (``csrc/segment_sum.cu``).

The kernel sums a destination-sorted stream in CSR form: row ``r`` owns
``data_sorted[row_ptr[r]:row_ptr[r + 1]]`` (``row_ptr[0] == 0``), and
:func:`merge_path_partition` cuts rows and items together into tiles of
equal work.  The engine builds the sorted stream once per CBList snapshot
(``core.engine.sweep_plan``); ``segment_matmul(data, seg, num_rows)`` is the
one-off drop-in for an unsorted stream: :func:`sorted_layout`, the data
permuted by ``gather_rows`` (JAX's ``apply_perm``), then
:func:`segment_sum_csr`.  A CPU tensor takes the plain versions in
:mod:`.ref`; a CUDA tensor launches the kernels; a meta tensor gives the
output's shape alone (the dry run).
"""
from __future__ import annotations

import torch

from repro_torch import backend
from repro_torch.kernels.block_gather.ops import gather_rows
from repro_torch.kernels.segment_matmul.ref import segment_sum_csr_ref

INT32_MAX = torch.iinfo(torch.int32).max
# merge items per kernel tile at feature width F: 256 threads in groups of
# FL = min(next_pow2(F), 32) lanes, 24 items a group (csrc/segment_sum.cu)
_TILE_LANES, _ITEMS_PER_GROUP, _MAX_FEAT_LANES = 256, 24, 32


def csr_items_per_cta(F: int) -> int:
    """The kernel's merge items per tile at feature width ``F``."""
    fl = min(1 << max(F - 1, 0).bit_length(), _MAX_FEAT_LANES)
    return _TILE_LANES // fl * _ITEMS_PER_GROUP


def _check_stream_size(n: int) -> None:
    if n > INT32_MAX:
        raise ValueError(f"segment sum: a stream of {n} items does not fit "
                         "the kernel's int32 layout")


def sorted_layout(seg: torch.Tensor, num_rows: int):
    """``(order, row_ptr)``, both int32: stable destination order, invalid
    rows last, and each row's span ``row_ptr[r]:row_ptr[r + 1]`` of it."""
    _check_stream_size(seg.numel())
    key = torch.where((seg >= 0) & (seg < num_rows), seg,
                      torch.full_like(seg, INT32_MAX))
    sorted_key, order = torch.sort(key, stable=True)
    bounds = torch.arange(num_rows + 1, dtype=torch.int32, device=seg.device)
    row_ptr = torch.searchsorted(sorted_key, bounds, out_int32=True)
    return order.to(torch.int32), row_ptr


def merge_path_partition(row_ptr: torch.Tensor, items_per_cta: int,
                         num_items: int | None = None) -> torch.Tensor:
    """Where each CTA's share of the merged (row ends ∪ items) sequence
    starts: int32 ``[n_ctas + 1, 2]`` of (row, item), the last row
    ``(num_rows, num_items)``.

    Diagonal ``d`` of the merge splits at ``x`` rows and ``d - x`` items,
    where ``x`` counts the rows whose end comes before it:
    ``row_ptr[r + 1] + r + 1 <= d`` (a row's end follows its last item).
    A meta ``row_ptr`` holds no count: the caller names ``num_items`` and
    gets the partition's shape alone.
    """
    if items_per_cta < 1:
        raise ValueError(f"items_per_cta must be >= 1, got {items_per_cta}")
    num_rows = row_ptr.numel() - 1
    dev = row_ptr.device
    if dev.type != "meta":
        num_items = int(row_ptr[-1])
    elif num_items is None:
        raise ValueError("merge_path_partition: a meta row_ptr needs "
                         "num_items")
    _check_stream_size(num_items)
    total = num_rows + num_items
    n_ctas = -(-total // items_per_cta)
    if dev.type == "meta":
        return torch.empty((n_ctas + 1, 2), dtype=torch.int32, device=dev)
    diag = (torch.arange(n_ctas + 1, dtype=torch.int64, device=dev)
            * items_per_cta).clamp_(max=total)
    ends = row_ptr[1:].long() + torch.arange(1, num_rows + 1, device=dev)
    rows = torch.searchsorted(ends, diag, right=True)
    return torch.stack([rows, diag - rows], dim=1).to(torch.int32)


def _check_csr(data_sorted: torch.Tensor, row_ptr: torch.Tensor,
               parts: torch.Tensor) -> None:
    if data_sorted.dim() != 2 or row_ptr.dim() != 1 or row_ptr.numel() < 1:
        raise ValueError(f"segment_sum_csr wants data_sorted[V, F] and "
                         f"row_ptr[R + 1], got {tuple(data_sorted.shape)} and "
                         f"{tuple(row_ptr.shape)}")
    if data_sorted.dtype != torch.float32 or row_ptr.dtype != torch.int32 \
            or parts.dtype != torch.int32:
        raise TypeError(f"segment_sum_csr wants float32 data and int32 "
                        f"row_ptr and parts, got {data_sorted.dtype}, "
                        f"{row_ptr.dtype} and {parts.dtype}")
    if not (data_sorted.device == row_ptr.device == parts.device):
        raise ValueError("segment_sum_csr: tensors on different devices")
    if not (data_sorted.is_contiguous() and row_ptr.is_contiguous()
            and parts.is_contiguous()):
        raise ValueError("segment_sum_csr wants contiguous tensors")
    _check_stream_size(data_sorted.shape[0])
    total = row_ptr.numel() - 1 + data_sorted.shape[0]
    n_ctas = -(-total // csr_items_per_cta(max(data_sorted.shape[1], 1)))
    if parts.dim() != 2 or tuple(parts.shape) != (n_ctas + 1, 2):
        raise ValueError(
            f"segment_sum_csr: parts {tuple(parts.shape)} is not the "
            f"partition of this stream ({n_ctas + 1}, 2); make it with "
            f"merge_path_partition(row_ptr, csr_items_per_cta(F)) over a "
            f"stream of row_ptr[-1] items")


def segment_sum_csr(data_sorted: torch.Tensor, row_ptr: torch.Tensor,
                    parts: torch.Tensor) -> torch.Tensor:
    """f32[R, F]: row ``r`` sums ``data_sorted[row_ptr[r]:row_ptr[r + 1]]``.

    ``data_sorted`` holds exactly ``row_ptr[-1]`` rows; ``parts`` is
    ``merge_path_partition(row_ptr, csr_items_per_cta(F))``.
    """
    _check_csr(data_sorted, row_ptr, parts)
    if data_sorted.device.type == "cpu":
        return segment_sum_csr_ref(data_sorted, row_ptr)
    if data_sorted.device.type == "meta":
        return data_sorted.new_empty((row_ptr.numel() - 1,
                                      data_sorted.shape[1]))
    if data_sorted.device.type != "cuda":
        raise ValueError(f"segment_sum_csr: unsupported device "
                         f"{data_sorted.device}")
    num_rows = row_ptr.numel() - 1
    F = data_sorted.shape[1]
    n_ctas = parts.shape[0] - 1
    out = torch.empty((num_rows, F), dtype=torch.float32,
                      device=data_sorted.device)
    if num_rows == 0 or F == 0:
        return out
    carry = torch.empty(2 * n_ctas * F, dtype=torch.float64,
                        device=data_sorted.device)
    backend.launch("segment_sum", data_sorted.data_ptr(), row_ptr.data_ptr(),
                   parts.data_ptr(), carry.data_ptr(), out.data_ptr(),
                   num_rows, F, n_ctas)
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
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"segment_matmul: unsupported device {data.device}")


def segment_matmul(data: torch.Tensor, seg: torch.Tensor,
                   num_rows: int) -> torch.Tensor:
    """Segment-sum of ``data`` rows by ``seg`` -> f32[num_rows, F]; rows of
    ``seg`` outside [0, num_rows) are dropped."""
    _check(data, seg)
    order, row_ptr = sorted_layout(seg, num_rows)
    n_valid = int(row_ptr[-1])
    if n_valid:
        data_sorted = gather_rows(data, order[:n_valid], rows_per_step=1)
    else:
        data_sorted = data.new_empty((0, data.shape[1]))
    parts = merge_path_partition(row_ptr,
                                 csr_items_per_cta(max(data.shape[1], 1)))
    return segment_sum_csr(data_sorted, row_ptr, parts)
