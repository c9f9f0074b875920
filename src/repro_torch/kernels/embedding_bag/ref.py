"""Plain torch versions of EmbeddingBag (the kernel's oracle), as
``repro.kernels.embedding_bag.ref``: gather at ``max(ids, 0)`` (ids >= V
read row V - 1, as JAX clamps a gather), weight by ``w * (ids >= 0)`` and
sum."""
import torch


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def embedding_bag_ref(table: torch.Tensor, bag_ids: torch.Tensor,
                      weights=None) -> torch.Tensor:
    """bag_ids [B, L] (-1 = padding), weights broadcastable to [B, L], a
    number, or None (sum mode) -> [B, F]."""
    B, L = bag_ids.shape
    if weights is None:
        weights = 1.0
    if isinstance(weights, torch.Tensor):
        w = weights.expand(B, L) * (bag_ids >= 0)
    else:        # a number, applied in the table's type (no host copy)
        w = (bag_ids >= 0).to(table.dtype) * weights
    return (_rows(table, bag_ids) * w[:, :, None]).sum(1)


def embedding_bag_sorted_ref(table: torch.Tensor, ids: torch.Tensor,
                             seg: torch.Tensor, weights: torch.Tensor,
                             num_bags: int) -> torch.Tensor:
    """Flat slots ``(ids, seg, weights)`` [N] -> [num_bags, F]; slot i adds
    to bag ``seg[i]``, slots with ``seg`` outside [0, num_bags) are dropped
    and a bag with no slot is 0."""
    rows = _rows(table, ids) * (weights * (ids >= 0))[:, None]
    seg = torch.where((seg >= 0) & (seg < num_bags), seg, num_bags)
    out = torch.zeros((num_bags + 1, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    return out.index_add_(0, seg.long(), rows)[:num_bags]
