"""Wrapper of the row-group gather kernel (``csrc/block_gather.cu``)."""
from __future__ import annotations

import torch

from repro_torch import backend
from repro_torch.kernels.block_gather.ref import block_gather_ref


def _check(table: torch.Tensor, ids: torch.Tensor, rows_per_step: int) -> None:
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"gather_rows wants table[R, F] and ids[N], got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if rows_per_step < 1 or table.shape[0] % rows_per_step:
        raise ValueError(f"gather_rows: {table.shape[0]} rows are not whole "
                         f"groups of {rows_per_step}")
    if table.shape[0] == 0:
        raise ValueError("gather_rows: empty table")
    if table.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"gather_rows wants a float32 table and int32 ids, "
                        f"got {table.dtype} and {ids.dtype}")
    if table.device != ids.device:
        raise ValueError("gather_rows: table and ids on different devices")
    if not (table.is_contiguous() and ids.is_contiguous()):
        raise ValueError("gather_rows wants contiguous tensors")


def gather_rows(table: torch.Tensor, ids: torch.Tensor, *,
                rows_per_step: int = 8,
                launch_name: str = "block_gather") -> torch.Tensor:
    """out[i*G:(i+1)*G] = table[ids[i]*G:(ids[i]+1)*G] with G = rows_per_step.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
    counted in ``backend.LAUNCHES[launch_name]`` (``"plan_block_gather"``
    for the sweep plan's build); a meta tensor gives the output's shape and
    nothing else (the dry run).
    """
    if launch_name not in ("block_gather", "plan_block_gather"):
        raise ValueError(f"gather_rows: no launch count {launch_name!r}")
    _check(table, ids, rows_per_step)
    if table.device.type == "cpu":
        return block_gather_ref(table, ids, rows_per_step)
    if table.device.type == "meta":
        return table.new_empty((ids.shape[0] * rows_per_step,
                                table.shape[1]))
    if table.device.type != "cuda":
        raise ValueError(f"gather_rows: unsupported device {table.device}")
    F = table.shape[1]
    n = ids.shape[0]
    out = torch.empty((n * rows_per_step, F), dtype=torch.float32,
                      device=table.device)
    backend.launch(launch_name, table.data_ptr(), ids.data_ptr(),
                   out.data_ptr(), n, rows_per_step * F,
                   table.shape[0] // rows_per_step)
    return out
