"""Epoch-versioned graph snapshots for concurrent read serving.

Every CBList mutator returns new tensors, so a snapshot is a pinned
reference: readers holding a :class:`Snapshot` see one consistent graph
however many flushes or maintenance passes replace the service's head
version.  ``epoch`` counts flushes; ``watermark`` is the absolute log
sequence number applied into this version; ``run_version`` counts the
seal / unseal repartitions of a :class:`~repro_torch.core.tiered.
TieredGraph` (0 for an untiered CBList), so a tiered view is identified by
``(run_version, epoch, watermark)``.  The read paths dispatch on the
storage type: they union both tiers, and on a sharded store every shard
answers and the owner's answer is kept.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch.core.blockstore import I32
from repro_torch.core.cblist import CBList
from repro_torch.core.updates import read_edges
from repro_torch.graph.sampler import SampledGraph, sample_subgraph


class Snapshot(NamedTuple):
    cbl: CBList              # or a TieredGraph / ShardedCBList: the same
                             # vertex-table surface
    epoch: torch.Tensor      # i32[] version counter (bumps per flush)
    watermark: torch.Tensor  # i32[] log sequence applied into this version
    run_version: int = 0     # sealed-tier generation (0: untiered)

    @property
    def num_edges(self) -> torch.Tensor:
        return self.cbl.num_edges

    @property
    def version(self) -> Tuple[int, int]:
        """Concrete ``(epoch, watermark)`` of this view, as the serve
        scheduler stamps it on responses (one host read)."""
        epoch, watermark = torch.stack([self.epoch, self.watermark]).tolist()
        return int(epoch), int(watermark)

    @property
    def tier_version(self) -> Tuple[int, int, int]:
        """``(run_version, epoch, watermark)``: the tiered identity; untiered
        storage pins run_version 0."""
        return int(self.run_version), int(self.epoch), int(self.watermark)


def _run_version_of(cbl) -> int:
    return int(getattr(cbl, "run_version", 0))


def snapshot_of(cbl: CBList, epoch: int = 0, watermark: int = 0) -> Snapshot:
    dev = cbl.device
    return Snapshot(cbl=cbl, epoch=torch.tensor(epoch, dtype=I32, device=dev),
                    watermark=torch.tensor(watermark, dtype=I32, device=dev),
                    run_version=_run_version_of(cbl))


def advance(snap: Snapshot, cbl: CBList, watermark) -> Snapshot:
    """New version: updated storage, bumped epoch, new applied watermark,
    the storage's sealed-run generation."""
    return Snapshot(cbl=cbl, epoch=snap.epoch + 1,
                    watermark=torch.as_tensor(watermark, dtype=I32,
                                              device=cbl.device),
                    run_version=_run_version_of(cbl))


def _to(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device, non_blocking=True)
    if isinstance(x, tuple):             # CBList, BlockStore, shard runs
        vals = [_to(v, device) for v in x]
        return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)
    if dataclasses.is_dataclass(x):      # TieredGraph, its CSRGraph runs
                                         # and a ShardedCBList
        return dataclasses.replace(x, **{
            f.name: _to(getattr(x, f.name), device)
            for f in dataclasses.fields(x) if f.init})
    return x


def device_replica(snap: Snapshot, device) -> Snapshot:
    """The same pinned version with its storage tensors copied to
    ``device`` (asynchronous copies: the first read on the replica waits
    for them on its stream).  Epoch, watermark and run_version identify the
    same view, so every read path answers bit-identically from the copy."""
    device = torch.device(device)
    return Snapshot(cbl=_to(snap.cbl, device),
                    epoch=snap.epoch.to(device, non_blocking=True),
                    watermark=snap.watermark.to(device, non_blocking=True),
                    run_version=snap.run_version)


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


def sample_khop(snap: Snapshot, seeds: torch.Tensor,
                generator: torch.Generator,
                fanout: Sequence[int] = (15, 10)) -> SampledGraph:
    """K-hop fanout neighbourhood sample over the pinned version: every hop
    reads the same epoch."""
    return sample_subgraph(snap.cbl, seeds, generator, fanout=tuple(fanout))
