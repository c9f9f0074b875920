"""The plain reference against textbook oracles on small graphs: power
iteration in numpy, a queue BFS, Dijkstra, union-find, a dict of edges."""
import heapq
from collections import deque

import numpy as np
import pytest
import torch

from graphbench.reference import graph as ref


def small_graph(seed, nv=60, ne=240):
    rng = np.random.default_rng(seed)
    pairs = sorted({(int(a), int(b)) for a, b in
                    zip(rng.integers(0, nv, ne), rng.integers(0, nv, ne))})
    src = torch.tensor([p[0] for p in pairs], dtype=torch.int32)
    dst = torch.tensor([p[1] for p in pairs], dtype=torch.int32)
    w = torch.tensor(0.1 + 0.9 * rng.random(len(pairs)), dtype=torch.float32)
    return nv, src, dst, w


SEEDS = (0, 1, 2)


@pytest.mark.parametrize("seed", SEEDS)
def test_edge_table_reads(seed):
    nv, src, dst, w = small_graph(seed)
    table = ref.edge_table(src, dst, w, nv)
    adj = {(int(a), int(b)): float(x) for a, b, x in zip(src, dst, w)}
    qs = torch.randint(0, nv, (500,), generator=torch.Generator()
                       .manual_seed(seed))
    qd = torch.randint(0, nv, (500,), generator=torch.Generator()
                       .manual_seed(seed + 9))
    found, got = ref.lookup(table, qs, qd, nv)
    for a, b, f, x in zip(qs.tolist(), qd.tolist(), found.tolist(),
                          got.tolist()):
        assert f == ((a, b) in adj)
        assert x == (adj[(a, b)] if f else 0.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_pagerank(seed):
    nv, src, dst, _ = small_graph(seed)
    a = np.zeros((nv, nv))
    deg = np.bincount(src.numpy(), minlength=nv)
    for s, t in zip(src.tolist(), dst.tolist()):
        a[t, s] += 1.0 / deg[s]
    r = np.full(nv, 1.0 / nv)
    for _ in range(500):
        r = 0.15 / nv + 0.85 * (a @ r + r[deg == 0].sum() / nv)
    got = ref.pagerank(src, dst, nv).numpy()
    np.testing.assert_allclose(got, r, rtol=1e-9, atol=0)
    assert abs(got.sum() - 1.0) < 1e-9


@pytest.mark.parametrize("seed", SEEDS)
def test_bfs(seed):
    nv, src, dst, _ = small_graph(seed)
    out = {v: [] for v in range(nv)}
    for s, t in zip(src.tolist(), dst.tolist()):
        out[s].append(t)
    want = [-1] * nv
    want[3] = 0
    q = deque([3])
    while q:
        v = q.popleft()
        for u in out[v]:
            if want[u] < 0:
                want[u] = want[v] + 1
                q.append(u)
    assert ref.bfs(src, dst, nv, 3).tolist() == want


@pytest.mark.parametrize("seed", SEEDS)
def test_sssp(seed):
    nv, src, dst, w = small_graph(seed)
    out = {v: [] for v in range(nv)}
    for s, t, x in zip(src.tolist(), dst.tolist(), w.double().tolist()):
        out[s].append((t, x))
    want = [float("inf")] * nv
    want[5] = 0.0
    heap = [(0.0, 5)]
    while heap:
        dv, v = heapq.heappop(heap)
        if dv > want[v]:
            continue
        for u, x in out[v]:
            if dv + x < want[u]:
                want[u] = dv + x
                heapq.heappush(heap, (want[u], u))
    got = ref.sssp(src, dst, w, nv, 5).tolist()
    np.testing.assert_allclose(got, want, rtol=1e-12)


@pytest.mark.parametrize("seed", SEEDS)
def test_wcc(seed):
    nv, src, dst, _ = small_graph(seed, ne=70)
    parent = list(range(nv))

    def find(v):
        while parent[v] != v:
            v = parent[v]
        return v
    for s, t in zip(src.tolist(), dst.tolist()):
        a, b = find(s), find(t)
        parent[max(a, b)] = min(a, b)
    want = [min(u for u in range(nv) if find(u) == find(v))
            for v in range(nv)]
    assert ref.wcc(src, dst, nv).tolist() == want


def test_lower_precision_moves_the_values():
    nv, src, dst, w = small_graph(0)
    exact = ref.pagerank(src, dst, nv)
    low = ref.pagerank(src, dst, nv, dtype=torch.float32,
                       store=torch.bfloat16, max_iters=200)
    assert float((low.double() - exact).abs().sum()) > 1e-4
    d64 = ref.sssp(src, dst, w, nv, 5)
    d16 = ref.sssp(src, dst, w, nv, 5, dtype=torch.float32,
                   store=torch.bfloat16)
    fin = torch.isfinite(d64) & (d64 > 0)
    assert float(((d16.double() - d64).abs() / d64)[fin].max()) > 1e-4
