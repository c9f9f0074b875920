"""Plain torch versions of the sweep-plan patch (the kernels' oracle).

The lanes stream is sorted by (dst, src): destination ``d``'s lanes are
``src[row_ptr[d]:row_ptr[d + 1]]``, ascending.  A record is a (dst, src)
key; the records are sorted by it and unique.
"""
import torch


def locate_lanes_ref(src: torch.Tensor, row_ptr: torch.Tensor,
                     rdst: torch.Tensor, rsrc: torch.Tensor):
    """``(pos, found)``: each record's first lane in its destination's
    segment whose source is not below its own (a binary search, all
    records in step), and whether that lane holds the record's key."""
    lo = row_ptr[rdst.long()].long()
    end = row_ptr[rdst.long() + 1].long()
    if not src.numel():
        return lo.to(torch.int32), torch.zeros_like(rsrc, dtype=torch.bool)
    last = src.numel() - 1
    hi = end.clone()
    while bool((lo < hi).any()):
        mid = (lo + hi) // 2
        open_ = lo < hi
        below = src[mid.clamp(max=last)] < rsrc
        lo = torch.where(open_ & below, mid + 1, lo)
        hi = torch.where(open_ & ~below, mid, hi)
    found = (lo < end) & (src[lo.clamp(max=last)] == rsrc)
    return lo.to(torch.int32), found


def merge_lanes_ref(src: torch.Tensor, w: torch.Tensor, pos: torch.Tensor,
                    cum_found: torch.Tensor, cum_ins: torch.Tensor,
                    rsrc: torch.Tensor, rw: torch.Tensor, num_lanes: int):
    """The new ``(src, w)`` streams of ``num_lanes`` lanes: old lane ``i``
    moves to ``i`` less the deleted lanes before it plus the inserts at or
    before it, unless a record deletes it; insert ``k`` goes after the kept
    old lanes before ``pos[k]`` and the inserts before it.  ``cum_found`` /
    ``cum_ins`` are the exclusive prefix counts of the records that delete
    a lane / insert one."""
    pos = pos.long()
    i = torch.arange(src.numel(), device=src.device)
    lo = torch.searchsorted(pos, i)                  # records before lane i
    hi = torch.searchsorted(pos, i, right=True)      # ... or at it
    dropped = cum_found.long()[lo]
    kept = cum_found.long()[hi] == dropped
    dest = (i - dropped + cum_ins.long()[hi])[kept]
    new_src = torch.empty(num_lanes, dtype=src.dtype, device=src.device)
    new_w = torch.empty(num_lanes, dtype=w.dtype, device=w.device)
    new_src[dest] = src[kept]
    new_w[dest] = w[kept]
    ins = cum_ins[1:] != cum_ins[:-1]
    before = torch.searchsorted(pos, pos)            # records with pos < p
    idest = (pos - cum_found.long()[before] + cum_ins.long()[:-1])[ins]
    new_src[idest] = rsrc[ins]
    new_w[idest] = rw[ins]
    return new_src, new_w
