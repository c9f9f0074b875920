"""Epoch-versioned graph snapshots for concurrent read serving.

Every CBList mutator returns new tensors, so a snapshot is a pinned
reference: readers holding a :class:`Snapshot` see one consistent graph
however many flushes or maintenance passes replace the service's head
version.  ``epoch`` counts flushes; ``watermark`` is the absolute log
sequence number applied into this version.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.core.blockstore import I32
from repro_torch.core.cblist import CBList
from repro_torch.core.updates import read_edges


class Snapshot(NamedTuple):
    cbl: CBList
    epoch: torch.Tensor      # i32[] version counter (bumps per flush)
    watermark: torch.Tensor  # i32[] log sequence applied into this version


def snapshot_of(cbl: CBList, epoch: int = 0, watermark: int = 0) -> Snapshot:
    dev = cbl.device
    return Snapshot(cbl=cbl, epoch=torch.tensor(epoch, dtype=I32, device=dev),
                    watermark=torch.tensor(watermark, dtype=I32, device=dev))


def advance(snap: Snapshot, cbl: CBList, watermark) -> Snapshot:
    """New version: updated storage, bumped epoch, new applied watermark."""
    return Snapshot(cbl=cbl, epoch=snap.epoch + 1,
                    watermark=torch.as_tensor(watermark, dtype=I32,
                                              device=cbl.device))


def query_edges(snap: Snapshot, qsrc: torch.Tensor, qdst: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched read_edge(src, dst) -> (found, weight) as of the watermark."""
    return read_edges(snap.cbl, qsrc, qdst)


def query_degrees(snap: Snapshot, verts: torch.Tensor) -> torch.Tensor:
    """Batched out-degree lookup as of the watermark; out-of-range ids
    report degree 0."""
    nv = snap.cbl.capacity_vertices
    in_range = (verts >= 0) & (verts < nv)
    return torch.where(in_range, snap.cbl.v_deg[verts.clamp(0, nv - 1).long()],
                       0)
