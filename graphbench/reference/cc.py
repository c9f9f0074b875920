"""The ``cc`` job: weakly connected components labelled by their least
vertex id, and the compared number ``wcc_wrong``, the vertices whose label
differs (exact)."""
from graphbench.reference import graph as ref


def solve(src, dst, w, nv: int, params: dict, store=None):
    return ref.wcc(src, dst, nv)


def compare(got, want):
    return {"wcc_wrong": int((got[:want.numel()].long()
                              != want.long()).sum())}
