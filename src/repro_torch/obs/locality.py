"""Locality profiling: the cache-behaviour statistics the paper's thesis
turns on, measured instead of assumed.

A CBList sweep's cost tracks how many *blocks* it touches per edge and how
deep the per-vertex chains it must hop.  Per sweep this module computes:

  * **delta chain hops** — blocks per live vertex chain (``v_level``):
    mean and max.  Every hop past the first is a dependent fetch (the
    quantity the paper's coroutine schedule exists to cover);
  * **run-vs-delta lane mix** — the fraction of live edges served by the
    sealed CSR tier of a :class:`~repro_torch.core.tiered.TieredGraph` vs
    the mutable delta (an untiered CBList: every lane is a delta lane);
  * **blocks-touched-per-edge** — blocks a full sweep visits over live
    edges (1/block_width is the dense ideal; near 1.0 is pointer chasing).

Host-side arithmetic over one reduction of the vertex table, gated behind
``REPRO_OBS`` by the callers and taken at the program entry point
(:func:`repro_torch.core.program.run_program`).  The recorded
``locality.contiguity`` gauge doubles as the signal bus's
``sweep_contiguity`` source.
"""
from __future__ import annotations

from typing import Optional

import torch


def _chain_stats(v_level: torch.Tensor, v_deg: torch.Tensor):
    """(chain blocks total, max chain depth, live vertices, live edges) in
    one host read."""
    live = v_deg > 0
    lvl = torch.where(live, v_level, 0).long()
    stats = torch.stack([lvl.sum(),
                         lvl.max() if lvl.numel() else lvl.sum(),
                         live.sum(), v_deg.long().sum()])
    return tuple(float(x) for x in stats.tolist())


def sweep_profile(storage) -> dict:
    """Locality statistics of one sweep over ``storage`` (a CBList, a
    ShardedCBList or a TieredGraph) as a flat host-side dict."""
    from repro_torch.core import blockstore as bs
    from repro_torch.core.cblist import CBList
    from repro_torch.core.tiered import TieredGraph
    run_edges = 0.0
    delta = storage
    if isinstance(storage, TieredGraph):
        delta = storage.delta
        run_edges = float(sum(g.n_live for g in storage.run_list))
    blocks, hops_max, n_live, delta_edges = _chain_stats(delta.v_level,
                                                         delta.v_deg)
    if isinstance(delta, CBList):
        contiguity = float(bs.gtchain_contiguity(delta.store))
    else:
        from repro_torch.distributed.graph import shard_contiguity
        contiguity = float(shard_contiguity(delta))
    edges = delta_edges + run_edges
    # the sealed tier is one contiguous stream: ceil(lanes / width) blocks
    run_blocks = -(-run_edges // storage.block_width) if run_edges else 0.0
    return {
        "chain_hops_mean": blocks / n_live if n_live else 0.0,
        "chain_hops_max": hops_max,
        "delta_lane_fraction": delta_edges / edges if edges else 0.0,
        "run_lane_fraction": run_edges / edges if edges else 0.0,
        "blocks_per_edge": (blocks + run_blocks) / edges if edges else 0.0,
        "contiguity": contiguity,
        "live_vertices": n_live,
        "live_edges": edges,
    }


# gauges a profile refreshes (the bounded, fixed label-free set)
_GAUGE_KEYS = ("chain_hops_mean", "chain_hops_max", "delta_lane_fraction",
               "run_lane_fraction", "blocks_per_edge", "contiguity")


def record_sweep(storage, task: str = "sweep") -> Optional[dict]:
    """Profile ``storage`` and publish the statistics as ``locality.*``
    gauges plus a ``locality.sweeps{task=...}`` counter; None (and no
    device work) when observability is disabled."""
    import repro_torch.obs as obs
    if not obs.enabled():
        return None
    prof = sweep_profile(storage)
    reg = obs.registry()
    for key in _GAUGE_KEYS:
        reg.gauge(f"locality.{key}").set(prof[key])
    reg.counter("locality.sweeps", task=str(task)).inc()
    return prof
