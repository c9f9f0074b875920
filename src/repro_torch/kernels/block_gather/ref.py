"""Plain torch version of the row-group gather (the kernel's oracle)."""
import torch


def block_gather_ref(table: torch.Tensor, ids: torch.Tensor,
                     rows_per_step: int = 8) -> torch.Tensor:
    """``index_select`` of row groups; out-of-range ids clamp, as in JAX."""
    R, F = table.shape
    n_groups = R // rows_per_step
    grouped = table.reshape(n_groups, rows_per_step * F)
    safe = ids.long().clamp(0, n_groups - 1)
    return grouped.index_select(0, safe).reshape(-1, F)
