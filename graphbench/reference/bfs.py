"""The ``bfs`` job: directed levels from the job's source, and the compared
number ``bfs_wrong``, the vertices whose level differs (exact)."""
from graphbench.reference import graph as ref


def solve(src, dst, w, nv: int, params: dict, store=None):
    return ref.bfs(src, dst, nv, int(params["source"]))


def compare(got, want):
    return {"bfs_wrong": int((got[:want.numel()].long()
                              != want.long()).sum())}
