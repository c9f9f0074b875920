"""Plain torch versions of the GTChain segment sum (the kernel's oracles)."""
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


def segment_sum_csr_ref(data_sorted: torch.Tensor,
                        row_ptr: torch.Tensor) -> torch.Tensor:
    """y[r, :] = sum of data_sorted[row_ptr[r]:row_ptr[r + 1], :].

    The stream is destination-sorted; rows past ``row_ptr[-1]`` are not
    read.  ``index_add_`` adds each row's items in stream order.
    """
    lengths = row_ptr[1:] - row_ptr[:-1]
    num_rows = lengths.numel()
    seg = torch.repeat_interleave(
        torch.arange(num_rows, device=row_ptr.device), lengths.long())
    out = torch.zeros((num_rows,) + data_sorted.shape[1:],
                      dtype=data_sorted.dtype, device=data_sorted.device)
    return out.index_add_(0, seg, data_sorted[:seg.numel()])
