"""The ``pagerank`` job: the reference's ranks and the compared number
``pagerank_l1``, sum of |program - reference| over the sum of the
reference (the reference run to an L1 change under 1e-11 in float64)."""
import torch

from graphbench.reference import graph as ref


def solve(src, dst, w, nv: int, params: dict, store=None):
    low = {} if store is None else dict(dtype=torch.float32, store=store,
                                        max_iters=200)
    return ref.pagerank(src, dst, nv,
                        damping=float(params.get("damping", 0.85)), **low)


def compare(got, want):
    got = got[:want.numel()].to(torch.float64)
    return {"pagerank_l1": float((got - want).abs().sum()
                                 / want.abs().sum())}
