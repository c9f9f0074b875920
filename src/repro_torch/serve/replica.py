"""ReadPlane: snapshot fan-out reads over R device replicas.

Snapshots are immutable and versioned, so scaling reads is data placement:
copy the pinned serving snapshot to R devices (:func:`replicate_snapshot`)
and deal read mega-batches round-robin across the copies.  Each dispatch
launches on its replica's device without waiting; the scheduler collects
the results afterwards with one synchronisation and host copy per batch
(:meth:`ServeFrontend.step`'s collect pass).

Bit-identity is by construction: every replica holds the same tensors and
runs the same read functions, so which replica served a batch shows only
in the latency.  The replica count is clamped to the CUDA devices present
(one on a one-card host; a host snapshot has one replica), and to one on
a process-group mesh, where the ranks are the read fan-out.

Epoch advance: the plane re-broadcasts when the service publishes a new
snapshot (object identity).  A broadcast replaces whole replicas, and
in-flight batches finish against the replica objects they dispatched
with.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

import repro_torch.obs as obs
from repro_torch.distributed.graph import mesh_of
from repro_torch.stream import snapshot as snap
from repro_torch.stream.snapshot import Snapshot


def read_replica_devices(n_replicas: int, home: torch.device,
                         devices=None, mesh=None) -> List[torch.device]:
    """Devices for the read plane's replicas: replica 0 on ``home`` (the
    snapshot's own device, served in place), then the other CUDA devices;
    the count clamps to the devices present.

    On a process-group ``mesh`` the plane holds ``home`` only: the ranks
    are the read fan-out, each serving its own shards from the device it
    owns, and a copy on another card would hold this rank's shards on a
    device another rank owns and issue the read collectives from there."""
    if mesh is not None:
        devices = [home]
    elif devices is None:
        devices = [home]
        if home.type == "cuda":
            devices += [torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())
                        if i != (home.index or 0)]
    devices = [torch.device(d) for d in devices]
    n = max(1, min(int(n_replicas), len(devices)))
    return devices[:n]


def replicate_snapshot(snapshot: Snapshot, n_replicas: int,
                       devices=None) -> List[Snapshot]:
    """``n`` replicas of ``snapshot`` (clamped to the devices present):
    replica 0 is the snapshot itself, the others asynchronous copies of its
    tensors (:func:`repro_torch.stream.snapshot.device_replica`)."""
    home = snapshot.cbl.device
    targets = read_replica_devices(n_replicas, home, devices,
                                   mesh=mesh_of(snapshot.cbl))
    return [snapshot if r == 0 else snap.device_replica(snapshot, dev)
            for r, dev in enumerate(targets)]


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without blocking the host: staged through
    pinned memory and copied on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class ReadPlane:
    """R replicas of the pinned snapshot + a round-robin dispatch cursor."""

    def __init__(self, snapshot: Snapshot, n_replicas: int = 1, devices=None):
        self._want = max(1, int(n_replicas))
        self._devices = devices
        self._replicas: list = []
        self._pinned: Optional[Snapshot] = None
        self._version: Tuple[int, int] = (0, 0)
        self._cursor = 0
        self.broadcast(snapshot)

    @property
    def n_replicas(self) -> int:
        """Replicas actually placed (requested count clamped to devices)."""
        return len(self._replicas)

    @property
    def pinned(self) -> Snapshot:
        """The snapshot every replica currently mirrors."""
        return self._pinned

    @property
    def version(self) -> Tuple[int, int]:
        """``(epoch, watermark)`` of the pinned snapshot, cached as host
        ints so dispatch stamping costs no device read."""
        return self._version

    def broadcast(self, snapshot: Snapshot) -> bool:
        """Mirror a newly published snapshot (no-op on the same object); the
        copies overlap with reads already in flight on the old replicas."""
        if self._pinned is snapshot:
            return False
        with obs.span("serve.broadcast", cat="serve", replicas=self._want):
            self._replicas = replicate_snapshot(snapshot, self._want,
                                                self._devices)
        self._pinned = snapshot
        self._version = snapshot.version
        return True

    def _next(self) -> Tuple[int, Snapshot]:
        r = self._cursor
        self._cursor = (r + 1) % len(self._replicas)
        return r, self._replicas[r]

    # ---- fan-out read dispatches (not waited on: callers collect later) --

    def query_edges(self, qsrc: np.ndarray, qdst: np.ndarray):
        """(replica_index, (found, w)) — launched, not synchronised."""
        r, s = self._next()
        dev = s.cbl.device
        return r, snap.query_edges(s, to_device(qsrc, dev),
                                   to_device(qdst, dev))

    def query_degrees(self, verts: np.ndarray):
        r, s = self._next()
        return r, (snap.query_degrees(s, to_device(verts, s.cbl.device)),)

    def sample_khop(self, seeds: np.ndarray, salt: int,
                    fanout: Sequence[int]):
        """A k-hop sample drawn from a generator seeded with ``salt`` on the
        replica's device."""
        r, s = self._next()
        dev = s.cbl.device
        gen = torch.Generator(device=dev).manual_seed(int(salt))
        return r, tuple(snap.sample_khop(s, to_device(seeds, dev), gen,
                                         fanout))
