"""Read-your-writes overlay: pending log records atop a pinned snapshot.

A point or degree read first resolves against the immutable snapshot, then
the coalesced pending window of the update log
(:class:`repro_torch.stream.log.PendingView`) overrides per key — the same
last-op-per-key net effect the next flush applies, so an overlay read is
bit-identical to flushing first and reading the new snapshot:

  * pending **insert** of (s, d)  -> found, with the pending weight (upsert:
    replaces an existing edge's weight, adds the edge and +1 degree
    otherwise);
  * pending **delete** of (s, d)  -> not found, weight 0 (no degree change
    when the edge never existed);
  * delete-then-reinsert sequences are already collapsed to their final op
    by the view's coalescing.

During a double-buffered flush the service's pending view spans *shadow +
log*, re-coalesced across the concatenation; the combines below take any
view length.  They match keys by sorting the view and binary-searching the
queries (O((P + Q) log P), no [Q, P] match matrix), so the view may be a
log of millions of slots.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.blockstore import I32
from repro_torch.core.updates import DELETE, INSERT, read_edges
from repro_torch.stream import snapshot as snap
from repro_torch.stream.log import PendingView
from repro_torch.stream.snapshot import Snapshot


def _key(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """int64 key, one-to-one over int32 (src, dst) pairs."""
    return (src.long() << 32) | (dst.long() & 0xFFFFFFFF)


def _combine_point(base_found: torch.Tensor, base_w: torch.Tensor,
                   pend: PendingView, qsrc: torch.Tensor, qdst: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    P = pend.src.shape[0]
    if P == 0:
        return base_found, base_w
    # sort the view by key, the live lane first among lanes of one key (a
    # coalesced view holds at most one live lane per key)
    by_live = torch.sort((~pend.live).to(torch.uint8), stable=True)[1]
    skey, order = torch.sort(_key(pend.src, pend.dst)[by_live], stable=True)
    order = by_live[order]
    q = _key(qsrc, qdst)
    pos = torch.searchsorted(skey, q).clamp(max=P - 1)
    idx = order[pos]
    hit = (skey[pos] == q) & pend.live[idx]
    is_ins = pend.op[idx] == INSERT
    found = torch.where(hit, is_ins, base_found)
    w = torch.where(hit, torch.where(is_ins, pend.w[idx], 0.0), base_w)
    return found, w


def _combine_degrees(base_deg: torch.Tensor, pend: PendingView,
                     pend_exists: torch.Tensor, verts: torch.Tensor
                     ) -> torch.Tensor:
    delta = ((pend.live & (pend.op == INSERT) & ~pend_exists).long()
             - (pend.live & (pend.op == DELETE) & pend_exists).long())
    ssrc, order = torch.sort(pend.src)
    csum = torch.zeros(ssrc.shape[0] + 1, dtype=torch.long,
                       device=ssrc.device)
    csum[1:] = torch.cumsum(delta[order], 0)
    v = verts.to(ssrc.dtype)
    per_vert = (csum[torch.searchsorted(ssrc, v, right=True)]
                - csum[torch.searchsorted(ssrc, v)])
    return base_deg + per_vert.to(I32)


def overlay_point_reads(snapshot: Snapshot, pend: PendingView,
                        qsrc: torch.Tensor, qdst: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(found, weight) as of snapshot ⊕ pending window."""
    base_found, base_w = snap.query_edges(snapshot, qsrc, qdst)
    return _combine_point(base_found, base_w, pend, qsrc, qdst)


def overlay_degrees(snapshot: Snapshot, pend: PendingView,
                    verts: torch.Tensor) -> torch.Tensor:
    """Out-degrees as of snapshot ⊕ pending window: a live pending record
    shifts its source's degree only when it changes topology (an insert of
    a new key +1, a delete of an existing key -1)."""
    base = snap.query_degrees(snapshot, verts)
    # existence of each live pending key in the base; dead lanes do not
    # walk (they are masked by pend.live in the combine)
    pend_exists, _ = read_edges(snapshot.cbl, pend.src, pend.dst,
                                active=pend.live)
    return _combine_degrees(base, pend, pend_exists, verts)
