"""The ``sssp`` job: weighted distances from the job's source, and the
compared numbers ``sssp_reach_wrong``, the vertices reached on one side
only (exact), and ``sssp_max_rel``, the largest relative gap of a reached
distance."""
import torch

from graphbench.reference import graph as ref


def solve(src, dst, w, nv: int, params: dict, store=None):
    low = {} if store is None else dict(dtype=torch.float32, store=store)
    return ref.sssp(src, dst, w, nv, int(params["source"]), **low)


def compare(got, want):
    got = got[:want.numel()].to(torch.float64)
    reach_g, reach_w = torch.isfinite(got), torch.isfinite(want)
    both = reach_g & reach_w & (want > 0)
    rel = ((got - want).abs() / want.clamp(min=1e-300))[both]
    return {"sssp_reach_wrong": int((reach_g != reach_w).sum()),
            "sssp_max_rel": float(rel.max()) if rel.numel() else 0.0}
