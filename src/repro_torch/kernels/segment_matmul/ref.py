"""Plain torch version of the GTChain segment sum (the kernel's oracle)."""
import torch


def segment_sum_ref(data: torch.Tensor, seg: torch.Tensor,
                    num_rows: int) -> torch.Tensor:
    """y[r, :] = sum over edges e with seg[e] == r of data[e, :].

    Out-of-range segment ids (padding) are dropped: ``index_add_`` over the
    valid lanes only.
    """
    valid = (seg >= 0) & (seg < num_rows)
    out = torch.zeros((num_rows,) + data.shape[1:], dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, seg[valid].long(), data[valid])
