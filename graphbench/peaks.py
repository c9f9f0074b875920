"""The card's peaks and the byte counts of the benchmark's rooflines.

Peaks are the NVIDIA H100 SXM data sheet's, which assume the card's full
700 W; :func:`power_limit_w` reads the limit the card is set to, which the
harness reports beside every run.
"""
from __future__ import annotations

import subprocess
from typing import Optional

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, 80 GB HBM3


def sweep_bytes(edges: int, vertices: int) -> int:
    """Bytes one dense sweep over the graph has to move at the least: each
    live edge's two endpoints read once (8 B) and each vertex's value read
    and its new value written once (8 B).  Only the snapshot's counts
    enter, never a plan's padding or a kernel's tiles, so the count is the
    same whatever implements the sweep."""
    return 8 * int(edges) + 8 * int(vertices)


def sweep_seconds(edges: int, vertices: int) -> float:
    """The least time of one dense sweep at the card's memory peak."""
    return sweep_bytes(edges, vertices) / HBM_BYTES_PER_S


def power_limit_w() -> Optional[float]:
    """The power limit of card 0 as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits", "-i", "0"],
            capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
