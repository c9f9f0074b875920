"""The comparison that decides ``correct``.

What the window produced -- the point reads of the final snapshot, its live
edge count and the last result of each analytics job -- against the
plain reference (:mod:`graphbench.reference`) over the same stream.  Each
compared number has its limit in ``limits.json``; a run is correct when
every number is at or under its limit.

Numbers (each only where the cell produces it):

* ``edges_wrong`` -- read-back pairs whose found flag, or whose weight bit
  for bit, differs from the live window's (exact: limit 0);
* ``live_edges_off`` -- the snapshot's live edge count off the window's;
* each job's own numbers, from its module ``reference/<job>.py``:
  ``pagerank_l1``, ``bfs_wrong``, ``sssp_reach_wrong`` and
  ``sssp_max_rel``, ``wcc_wrong``.

:func:`control` gives the same numbers for the reference put in the
program's place one step down: values held in bfloat16 (the stated
precision is float32), and an edge set one round behind (the stated
guarantee is that a flushed round is visible).
"""
from __future__ import annotations

import importlib
import json
from pathlib import Path
from typing import Dict, Optional

import torch

from graphbench.reference import graph as ref

HERE = Path(__file__).resolve().parent
LIMITS = json.loads((HERE / "limits.json").read_text())


def _edges(found, w, want_found, want_w, live_count, edges):
    wrong = (found != want_found) | (
        found & want_found & (w.view(torch.int32) != want_w.view(torch.int32)))
    return {"edges_wrong": int(wrong.sum()),
            "live_edges_off": abs(int(live_count) - int(edges))}


def job(name: str):
    """The reference module of the analytics job ``name``
    (``reference/<name>.py``)."""
    if not (HERE / "reference" / f"{name}.py").is_file():
        raise ValueError(f"no reference for job {name!r}")
    return importlib.import_module(f"graphbench.reference.{name}")


def reference_results(stream, jobs, store: Optional[torch.dtype] = None):
    """The reference's result of each job ``{name: (round, params)}`` over
    the live window after that round (float64, or with ``store`` the
    control's precision)."""
    out = {}
    for name, (k, params) in jobs.items():
        src, dst, w = stream.live(k)
        out[name] = job(name).solve(src, dst, w, stream.nv, params,
                                    store=store)
        del src, dst, w
    return out


def compare(results: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor]
            ) -> Dict[str, float]:
    nums = {}
    for name, got in results.items():
        nums.update(job(name).compare(got, want[name]))
    return nums


def expected_reads(stream, k: int, qsrc, qdst, w_store=None):
    """The live window's answer to the read-back pairs after ``k``
    rounds."""
    src, dst, w = stream.live(k)
    if w_store is not None:
        w = w.to(w_store).to(torch.float32)
    table = ref.edge_table(src, dst, w, stream.nv)
    del src, dst, w
    return ref.lookup(table, qsrc, qdst, stream.nv)


def numbers(stream, out) -> Dict[str, float]:
    """Every compared number of a run's outputs ``out`` (see
    :func:`graphbench.harness.collect`)."""
    want_found, want_w = expected_reads(stream, out.rounds, out.qsrc,
                                        out.qdst)
    nums = _edges(out.found, out.w, want_found, want_w, out.live_count,
                  stream.edges)
    nums.update(compare(out.results, reference_results(stream, out.jobs)))
    return nums


def control(stream, out) -> Dict[str, Dict[str, float]]:
    """The compared numbers of the reference in the program's place, one
    step down: ``bf16`` (weights and values held in bfloat16) and
    ``behind`` (the edge set one round behind the last flush)."""
    k = out.rounds
    f16, w16 = expected_reads(stream, k, out.qsrc, out.qdst, torch.bfloat16)
    want_found, want_w = expected_reads(stream, k, out.qsrc, out.qdst)
    bf16 = _edges(f16, w16, want_found, want_w, stream.edges,
                  stream.edges)
    exact = reference_results(stream, out.jobs)
    low = reference_results(stream, out.jobs, torch.bfloat16)
    bf16.update(compare(low, exact))
    fb, wb = expected_reads(stream, k - 1, out.qsrc, out.qdst)
    behind = _edges(fb, wb, want_found, want_w, stream.edges,
                    stream.edges)
    return {"bf16": bf16, "behind": behind}


def verdict(nums: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    """``{name: {"value", "limit"}}`` of every compared number."""
    return {name: {"value": v, "limit": LIMITS[name]}
            for name, v in nums.items()}


def passed(checks) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
