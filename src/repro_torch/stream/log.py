"""Edge-update log: a fixed-capacity ring buffer, in torch.

Writers append (src, dst, w, op) records; the flush path drains them in
arrival order into one BatchUpdate.  At admission:

  * **coalescing** — within an appended batch only the *last* op per
    (src, dst) key survives;
  * **high-watermark backpressure** — a batch that would push the pending
    count past ``high_watermark * capacity`` is rejected whole;
  * **fixed shapes** — capacity is static; append/drain are scatters and
    gathers over the ring.

Sequence numbers are absolute (monotone ``head``/``tail`` counters); the
snapshot layer records ``head`` at flush time as its applied watermark.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core import blockstore as bs
from repro_torch.core.blockstore import I32, PAD
from repro_torch.core.updates import INSERT, NOP


class UpdateLog(NamedTuple):
    src: torch.Tensor    # i32[C] ring storage
    dst: torch.Tensor    # i32[C]
    w: torch.Tensor      # f32[C]
    op: torch.Tensor     # i32[C]  (+1 insert / -1 delete; NOP never stored)
    head: torch.Tensor   # i32[]  absolute seq of the oldest pending record
    tail: torch.Tensor   # i32[]  absolute seq of the next append slot

    @property
    def capacity(self) -> int:
        return self.src.shape[0]


class LogReceipt(NamedTuple):
    """What :func:`append` did with the offered batch."""
    admitted: torch.Tensor   # bool[]  whole batch accepted?
    appended: torch.Tensor   # i32[]   records written (post-coalescing)
    coalesced: torch.Tensor  # i32[]   records cancelled at admission
    pending: torch.Tensor    # i32[]   records waiting in the log afterwards


class PendingView(NamedTuple):
    """Non-destructive, cross-batch-coalesced view of the pending records:
    ``live`` marks the net op per (src, dst) key — what the next flush
    applies."""
    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor
    op: torch.Tensor
    live: torch.Tensor


def make_log(capacity: int, device=None) -> UpdateLog:
    return UpdateLog(
        src=torch.zeros(capacity, dtype=I32, device=device),
        dst=torch.zeros(capacity, dtype=I32, device=device),
        w=torch.zeros(capacity, dtype=torch.float32, device=device),
        op=torch.full((capacity,), NOP, dtype=I32, device=device),
        head=torch.tensor(0, dtype=I32, device=device),
        tail=torch.tensor(0, dtype=I32, device=device),
    )


def log_pending(log: UpdateLog) -> torch.Tensor:
    return log.tail - log.head


def _coalesce_mask(src: torch.Tensor, dst: torch.Tensor,
                   valid: torch.Tensor) -> torch.Tensor:
    """Keep only the LAST occurrence of each (src, dst) among valid entries
    (a stable sort keeps arrival order within a key)."""
    pad = torch.full_like(src, PAD)
    key = bs.composite_key(torch.where(valid, src, pad),
                           torch.where(valid, dst, pad))
    skey, order = torch.sort(key, stable=True)
    is_last = torch.ones_like(valid)
    is_last[:-1] = skey[:-1] != skey[1:]
    keep = torch.zeros_like(valid)
    keep[order] = is_last
    return keep & valid


def append(log: UpdateLog, src: torch.Tensor, dst: torch.Tensor,
           w: Optional[torch.Tensor] = None, op: Optional[torch.Tensor] = None,
           valid: Optional[torch.Tensor] = None,
           high_watermark: float = 1.0) -> Tuple[UpdateLog, LogReceipt]:
    """Admit a batch into the log (coalesced, watermark-gated,
    all-or-nothing)."""
    C = log.capacity
    dev = src.device
    if w is None:
        w = torch.ones(src.shape, dtype=torch.float32, device=dev)
    if op is None:
        op = torch.full(src.shape, INSERT, dtype=I32, device=dev)
    if valid is None:
        valid = torch.ones(src.shape, dtype=torch.bool, device=dev)
    valid = valid & (op != NOP)

    keep = _coalesce_mask(src, dst, valid)
    n = keep.sum().to(I32)
    coalesced = valid.sum().to(I32) - n

    pending0 = log.tail - log.head
    limit = min(int(high_watermark * C), C)
    admitted = pending0 + n <= limit

    # ring positions for kept entries, in arrival order
    rank = torch.cumsum(keep.to(I32), 0).to(I32) - 1
    slot = ((log.tail + rank) % C).long()
    sel = keep & admitted

    def put(ring, vals):
        ring = ring.clone()
        ring[slot[sel]] = vals[sel]
        return ring

    new = log._replace(src=put(log.src, src), dst=put(log.dst, dst),
                       w=put(log.w, w), op=put(log.op, op),
                       tail=log.tail + torch.where(admitted, n, 0))
    receipt = LogReceipt(admitted=admitted,
                         appended=torch.where(admitted, n, 0),
                         coalesced=coalesced,
                         pending=new.tail - new.head)
    return new, receipt


def _window(log: UpdateLog):
    C = log.capacity
    k = torch.arange(C, dtype=I32, device=log.src.device)
    live = k < log.tail - log.head
    pos = ((log.head + k) % C).long()
    return (torch.where(live, log.src[pos], 0),
            torch.where(live, log.dst[pos], 0),
            torch.where(live, log.w[pos], 0.0),
            torch.where(live, log.op[pos], NOP),
            live)


def drain(log: UpdateLog):
    """Pop every pending record in arrival (FIFO) order.

    Returns ``(log', (src, dst, w, op, valid))`` — capacity-sized, ``valid``
    marking the live prefix, invalid lanes NOP.
    """
    return log._replace(head=log.tail), _window(log)


def merge_views(shadow_src: torch.Tensor, shadow_dst: torch.Tensor,
                shadow_w: torch.Tensor, shadow_op: torch.Tensor,
                shadow_valid: torch.Tensor, log: UpdateLog) -> PendingView:
    """Pending view spanning an in-flight shadow flush plus the live log,
    re-coalesced across ``[shadow records | pending log records]`` (the log
    records arrived later and supersede shadow records on the same key)."""
    s, d, w, op, lvalid = _window(log)
    src = torch.cat([shadow_src, s])
    dst = torch.cat([shadow_dst, d])
    valid = torch.cat([shadow_valid, lvalid])
    return PendingView(src=src, dst=dst, w=torch.cat([shadow_w, w]),
                       op=torch.cat([shadow_op, op]),
                       live=_coalesce_mask(src, dst, valid))


def peek(log: UpdateLog) -> PendingView:
    """Read (not pop) every pending record, coalesced across append
    batches."""
    src, dst, w, op, valid = _window(log)
    return PendingView(src=src, dst=dst, w=w, op=op,
                       live=_coalesce_mask(src, dst, valid))
