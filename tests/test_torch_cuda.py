"""The port's CUDA kernels on the card: each against its plain version, and
small GraphService, LM and SASRec runs on the card against the same ones on
the host.
Every test is marked ``cuda`` and skips without a CUDA device; the file
imports no JAX, so it runs where only torch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)

pytestmark = pytest.mark.cuda


def _to_card(tree):
    """A parameter tree (dicts and lists of tensors) copied to the card."""
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_card(v) for v in tree]
    return tree.cuda()


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("E,F,rows", [(100_000, 1, 5_000), (20_000, 16, 700),
                                      (5, 3, 9), (0, 1, 4)])
def test_segment_sum_kernel_matches_float64_sum(gen, E, F, rows):
    from repro_torch import backend
    from repro_torch.kernels import segment_matmul, segment_sum_ref
    data = torch.rand((E, F), generator=gen, device="cuda")
    seg = torch.randint(-1, rows + 1, (E,), generator=gen, device="cuda",
                        dtype=torch.int32)
    before = backend.LAUNCHES["segment_sum"]
    got = segment_matmul(data, seg, rows)
    assert backend.LAUNCHES["segment_sum"] == before + 1
    ref = segment_sum_ref(data.double(), seg, rows)
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, segment_matmul(data, seg, rows))   # deterministic
    torch.cuda.synchronize()


def _csr_case(gen, case):
    """(data_sorted, row_ptr) of one CSR stream shape: rows of random
    lengths at F, one hub row of 10^6 items among short rows, 10^5 empty
    rows around a few full ones, no items at all, or a stream that starts
    one float past a 16-byte boundary."""
    kind, F = case
    if kind == "hub":
        lens = torch.randint(0, 20, (3_000,), generator=gen, device="cuda")
        lens[1_234] = 1_000_000
    elif kind == "empty":
        lens = torch.zeros(100_000, dtype=torch.int64, device="cuda")
        lens[::20_000] = 3_000
    elif kind == "none":
        lens = torch.zeros(5_000, dtype=torch.int64, device="cuda")
    else:
        lens = torch.randint(0, 40, (20_000,), generator=gen, device="cuda")
    row_ptr = torch.zeros(lens.numel() + 1, dtype=torch.int32, device="cuda")
    row_ptr[1:] = lens.cumsum(0)
    V = int(row_ptr[-1])
    skew = 1 if kind == "offset" else 0
    data = torch.rand(V * F + skew, generator=gen, device="cuda") - 0.25
    return data[skew:].view(V, F), row_ptr


@pytest.mark.parametrize("case", [("random", 1), ("random", 4),
                                  ("random", 16), ("random", 3),
                                  ("random", 50), ("offset", 1),
                                  ("offset", 5), ("hub", 1), ("hub", 16),
                                  ("empty", 1), ("none", 1), ("none", 16)])
def test_segment_sum_csr_kernel_matches_float64_sum(gen, case):
    """The merge-path kernel against its plain version run in float64 (a
    float64 sum: the kernel adds in float64 and rounds once), bit-identical
    on a repeat, one launch a call."""
    from repro_torch import backend
    from repro_torch.kernels.segment_matmul import (merge_path_partition,
                                                    segment_sum_csr,
                                                    segment_sum_csr_ref)
    from repro_torch.kernels.segment_matmul.ops import csr_items_per_cta
    data, row_ptr = _csr_case(gen, case)
    parts = merge_path_partition(row_ptr, csr_items_per_cta(data.shape[1]))
    before = backend.LAUNCHES["segment_sum"]
    got = segment_sum_csr(data, row_ptr, parts)
    assert backend.LAUNCHES["segment_sum"] == before + 1
    torch.cuda.synchronize()
    ref64 = segment_sum_csr_ref(data.double(), row_ptr)
    torch.testing.assert_close(got.double(), ref64, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, segment_sum_csr(data, row_ptr, parts))


def test_segment_sum_csr_rejects_a_partition_of_another_width(gen):
    from repro_torch.kernels.segment_matmul import (merge_path_partition,
                                                    segment_sum_csr)
    from repro_torch.kernels.segment_matmul.ops import csr_items_per_cta
    data, row_ptr = _csr_case(gen, ("random", 16))
    parts = merge_path_partition(row_ptr, csr_items_per_cta(1))
    with pytest.raises(ValueError):
        segment_sum_csr(data, row_ptr, parts)


@pytest.mark.parametrize("N,F,skew", [(4 * 10_000 + 1, 1, 1),
                                      (4 * 10_000 + 1, 1, 0),
                                      (4 * 10_000 + 3, 1, 2),
                                      (30_000, 16, 0), (20_000, 50, 0),
                                      (20_000, 50, 1), (7, 1, 3)])
def test_block_gather_kernel_is_exact_at_the_engine_shapes(gen, N, F, skew):
    """x[ids] at F = 1 (N = 4k + 1 and 4k + 3, ids sliced off a 16-byte
    boundary), push_feat's F = 16 and SASRec's F = 50, bit for bit."""
    from repro_torch import backend
    from repro_torch.kernels import block_gather_ref, gather_rows
    rows = 50_000
    table = torch.rand((rows, F), generator=gen, device="cuda")
    ids = torch.randint(-3, rows + 3, (N + skew,), generator=gen,
                        device="cuda", dtype=torch.int32)[skew:]
    before = backend.LAUNCHES["block_gather"]
    got = gather_rows(table, ids, rows_per_step=1)
    assert backend.LAUNCHES["block_gather"] == before + 1
    assert torch.equal(got, block_gather_ref(table, ids, 1))


def _card_graph(nv=3_000, ne=40_000, seed=4):
    from repro_torch.core.cblist import blocks_needed, build_from_coo
    from repro_torch.data.synthetic import rmat_edges
    src, dst = rmat_edges(nv, ne, seed=seed, device="cuda")
    w = torch.rand(ne, generator=torch.Generator(device="cuda")
                   .manual_seed(seed), device="cuda") + 0.1
    return build_from_coo(src, dst, w, num_vertices=nv,
                          num_blocks=blocks_needed(src, nv, 8) + 64,
                          block_width=8)


def test_planned_sweeps_on_the_card_match_the_plain_route(gen):
    """push (default and PageRank's message), pull and push_feat (F = 16)
    through the sweep plan's kernels against ``impl="torch"``, with and
    without an active mask."""
    from repro_torch import backend
    from repro_torch.core import engine as E
    cbl = _card_graph()
    nv = cbl.capacity_vertices
    plan = E.sweep_plan(cbl)
    x = torch.rand(nv, generator=gen, device="cuda")
    xf = torch.rand((nv, 16), generator=gen, device="cuda")
    active = torch.rand(nv, generator=gen, device="cuda") < 0.5
    tol = dict(rtol=1e-5, atol=1e-6)
    for act in (None, active):
        for kw in ({}, {"dense_f": lambda xs, w: xs}):
            before = dict(backend.LAUNCHES)
            got = E.process_edge_push(cbl, x, act, impl="cuda", plan=plan,
                                      **kw)
            assert backend.LAUNCHES["segment_sum"] == \
                before["segment_sum"] + 1
            assert backend.LAUNCHES["block_gather"] == \
                before["block_gather"] + 1
            torch.testing.assert_close(
                got, E.process_edge_push(cbl, x, act, impl="torch", **kw),
                **tol)
        torch.testing.assert_close(
            E.process_edge_pull(cbl, x, act, impl="cuda", plan=plan),
            E.process_edge_pull(cbl, x, act, impl="torch"), **tol)
        torch.testing.assert_close(
            E.process_edge_push_feat(cbl, xf, act, impl="cuda", plan=plan),
            E.process_edge_push_feat(cbl, xf, act, impl="torch"), **tol)


def test_pagerank_on_the_card_builds_one_plan(gen):
    from repro_torch import backend
    from repro_torch.graph.algorithms import pagerank
    cbl = _card_graph()
    backend.reset_launch_counts()
    got, iters = pagerank(cbl, impl="cuda", return_stats=True)
    assert backend.PLAN_BUILDS == 1
    assert backend.LAUNCHES["segment_sum"] == iters
    assert backend.LAUNCHES["block_gather"] == iters
    ref = pagerank(cbl, impl="torch")
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=0.0)


def _card_run(gen, nv=120_000, device="cuda"):
    """A sealed CSR run on ``device`` (its edges drawn on the card): a hub
    row of 10^5 edges among short rows, most rows empty, a few parallel
    edges."""
    from repro_torch.core.csr import csr_build
    lens = torch.zeros(nv, dtype=torch.int64, device="cuda")
    lens[::37] = torch.randint(1, 30, (len(lens[::37]),), generator=gen,
                               device="cuda")
    lens[4_321] = 100_000
    src = torch.repeat_interleave(torch.arange(nv, device="cuda"), lens)
    dst = torch.randint(0, nv, (src.numel(),), generator=gen, device="cuda")
    dst[:50] = dst[50:100]
    src[:50] = src[50:100]
    w = torch.rand(src.numel(), generator=gen, device="cuda") + 0.1
    return csr_build(src.to(device, torch.int32), dst.to(device, torch.int32),
                     w.to(device), nv, capacity=1 << 21)


@pytest.mark.parametrize("F", [1, 16])
def test_run_sweeps_on_the_card_match_their_plain_versions(gen, F):
    """The sealed run's push / pull / push_feat through ``gather_rows`` and
    ``segment_sum_csr`` on the card against the same sweeps' plain
    versions on the host (the kernel route on CPU tensors) and
    ``impl="torch"`` on the card, with and without an active mask; each
    sum sweep launches each kernel once."""
    from repro_torch import backend
    from repro_torch.core import csr as C
    run = _card_run(gen)
    host = _card_run(torch.Generator(device="cuda").manual_seed(0),
                     device="cpu")
    nv = run.nv
    x = torch.rand((nv, F) if F > 1 else nv, generator=gen, device="cuda")
    active = torch.rand(nv, generator=gen, device="cuda") < 0.5
    tol = dict(rtol=1e-5, atol=1e-6)
    sweeps = ((C.csr_push_feat,) if F > 1 else (C.csr_push, C.csr_pull))
    for fn in sweeps:
        for act in (None, active):
            what = f"{fn.__name__} F={F} active={act is not None}"
            before = dict(backend.LAUNCHES)
            got = fn(run, x, act, impl="cuda")
            for name in ("segment_sum", "block_gather"):
                assert backend.LAUNCHES[name] == before[name] + 1, \
                    f"{what}: {name} launches"
            # the float64 sum: impl="torch" on float64 values, as
            # chip_smoke.py's phase 3 holds the sweeps (a float32
            # index_add_ on the card adds in any order, and over the hub's
            # 10^5 edges its error reaches the tolerance)
            ref = fn(run, x.double(), act, impl="torch")
            host_act = None if act is None else act.cpu()
            torch.testing.assert_close(
                got.double(), ref, **tol,
                msg=lambda m: f"{what}: kernel route on the card against "
                              f"the float64 sum: {m}")
            torch.testing.assert_close(
                fn(host, x.cpu(), host_act, impl="cuda").double(),
                ref.cpu(), **tol,
                msg=lambda m: f"{what}: plain route on the host against the "
                              f"float64 sum: {m}")
            assert torch.equal(got, fn(run, x, act, impl="cuda")), \
                f"{what}: a repeat of the kernel route differs"
    torch.cuda.synchronize()


def test_tiered_reads_and_pagerank_on_the_card_match_the_untiered(gen):
    """Half the vertices sealed on the card: point reads bit for bit the
    all-delta graph's (no host sync), PageRank within rtol 1e-4 with one
    plan (the delta's) and the run tier's sweeps through both kernels."""
    from repro_torch import backend
    from repro_torch.core.tiered import seal, tier_from_cbl
    from repro_torch.core.updates import read_edges
    from repro_torch.graph.algorithms import pagerank
    cbl = _card_graph()
    nv = cbl.capacity_vertices
    tg = seal(tier_from_cbl(cbl), torch.arange(nv, device="cuda") % 2 == 0)
    # a move: the delta keeps its capacity, the sealed chains' blocks free
    assert tg.runs.n_live > 0 and tg.num_blocks == cbl.store.num_blocks
    assert int(tg.delta.store.free_top) > int(cbl.store.free_top)
    from repro_torch.core.cblist import to_coo
    qs, qd, _, _ = to_coo(cbl)
    qs = torch.cat([qs, torch.randint(0, nv, (5_000,), generator=gen,
                                      device="cuda", dtype=torch.int32)])
    qd = torch.cat([qd, torch.randint(0, nv, (5_000,), generator=gen,
                                      device="cuda", dtype=torch.int32)])
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = read_edges(tg, qs, qd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for a, b in zip(got, read_edges(cbl, qs, qd)):
        assert torch.equal(a, b)
    backend.reset_launch_counts()
    ranks, iters = pagerank(tg, impl="cuda", return_stats=True)
    assert backend.PLAN_BUILDS == 1
    for name in ("segment_sum", "block_gather"):
        assert backend.LAUNCHES[name] == 2 * iters, name
    torch.testing.assert_close(ranks, pagerank(cbl, impl="torch"),
                               rtol=1e-4, atol=0.0)


def test_tier_moves_on_the_card_match_the_host(gen):
    """The tier moves on the card: a seal, an unseal that leaves retired
    lanes, and a seal that merges over them (the run's push stream through
    the plan patch's locate and merge kernels, one launch each), lane for
    lane the same moves on the host; the push stream the one a fresh build
    lays out; reads bit for bit and PageRank within rtol 1e-4 of the
    all-delta graph's."""
    from repro_torch import backend
    from repro_torch.core import tiered as T
    from repro_torch.core.csr import CSRGraph
    from repro_torch.core.updates import read_edges
    from repro_torch.graph.algorithms import pagerank
    from repro_torch.stream.snapshot import _to
    cbl = _card_graph()
    nv = cbl.capacity_vertices
    v = torch.arange(nv, device="cuda")
    out = {}
    for dev in ("cuda", "cpu"):
        tg = T.seal(T.tier_from_cbl(_to(cbl, dev)), (v % 2 == 0).to(dev))
        tg = T.unseal(tg, (v % 4 == 0).to(dev))
        assert tg.run_retired > 0
        assert int(tg.num_edges) == int(cbl.num_edges)
        before = dict(backend.LAUNCHES)
        tg = T.seal(tg, (v % 3 == 0).to(dev))
        if dev == "cuda":
            for name in ("plan_patch_locate", "plan_patch_merge"):
                assert backend.LAUNCHES[name] == before[name] + 1, name
        out[dev] = tg
    card, host = out["cuda"], out["cpu"]
    assert card.run_retired == 0 and bool(card.sealed.any())
    for k in ("offsets", "indices", "weights", "row", "key", "push_src",
              "push_w", "push_ptr"):
        assert torch.equal(getattr(card.runs, k).cpu(),
                           getattr(host.runs, k)), k
    for k, a in card.delta.store._asdict().items():
        assert torch.equal(a.cpu(), getattr(host.delta.store, k)), k
    fresh = CSRGraph(offsets=card.runs.offsets, indices=card.runs.indices,
                     weights=card.runs.weights, row=card.runs.row, nv=nv)
    for k in ("push_src", "push_w", "push_ptr"):
        assert torch.equal(getattr(card.runs, k), getattr(fresh, k)), k
    from repro_torch.core.cblist import to_coo
    qs, qd, _, _ = to_coo(cbl)
    qs = torch.cat([qs, torch.randint(0, nv, (5_000,), generator=gen,
                                      device="cuda", dtype=torch.int32)])
    qd = torch.cat([qd, torch.randint(0, nv, (5_000,), generator=gen,
                                      device="cuda", dtype=torch.int32)])
    for a, b in zip(read_edges(card, qs, qd), read_edges(cbl, qs, qd)):
        assert torch.equal(a, b)
    torch.testing.assert_close(pagerank(card, impl="cuda"),
                               pagerank(cbl, impl="torch"),
                               rtol=1e-4, atol=0.0)


@pytest.mark.parametrize("rows_per_step,F", [(1, 1), (4, 1), (1, 16), (2, 3)])
def test_block_gather_kernel_matches_index_select(gen, rows_per_step, F):
    from repro_torch.kernels import block_gather_ref, gather_rows
    groups = 5_000
    table = torch.rand((groups * rows_per_step, F), generator=gen,
                       device="cuda")
    ids = torch.randint(0, groups, (70_000,), generator=gen, device="cuda",
                        dtype=torch.int32)
    got = gather_rows(table, ids, rows_per_step=rows_per_step)
    assert torch.equal(got, block_gather_ref(table, ids, rows_per_step))
    torch.cuda.synchronize()


# EmbeddingBag: positive rows and weights, so no cancellation; float32 sums
# of up to 64 terms stay within 64 float32 roundings of the float64 sum
BAG_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("F", [1, 16, 50, 64])
def test_embedding_bag_kernel_matches_float64_sum(gen, F, weighted):
    """Ragged bags of 0-64 slots through ``embedding_bag_sorted``, ids -1
    and >= V among them; deterministic on a repeat."""
    from repro_torch import backend
    from repro_torch.kernels import (embedding_bag_sorted,
                                     embedding_bag_sorted_ref)
    V, nb = 5_000, 3_000
    table = torch.rand((V, F), generator=gen, device="cuda")
    lens = torch.randint(0, 65, (nb,), generator=gen, device="cuda")
    lens[:3] = torch.tensor([0, 1, 64], device="cuda")
    seg = torch.repeat_interleave(
        torch.arange(nb, dtype=torch.int32, device="cuda"), lens)
    ids = torch.randint(-1, V + 5, (seg.numel(),), generator=gen,
                        device="cuda", dtype=torch.int32)
    w = (torch.rand(seg.numel(), generator=gen, device="cuda") if weighted
         else torch.ones(seg.numel(), device="cuda"))
    before = backend.LAUNCHES["embedding_bag"]
    got = embedding_bag_sorted(table, ids, seg, w, nb)
    assert backend.LAUNCHES["embedding_bag"] == before + 1
    ref = embedding_bag_sorted_ref(table.double(), ids, seg, w.double(), nb)
    torch.testing.assert_close(got.double(), ref, **BAG_TOL)
    assert not got[lens == 0].any()
    assert torch.equal(got, embedding_bag_sorted(table, ids, seg, w, nb))


@pytest.mark.parametrize("F", [1, 16, 50, 64])
def test_embedding_bag_kernel_fixed_bags_without_weights(gen, F):
    """[B, L] bags, weights None, -1 padding at the tail and ids >= V."""
    from repro_torch.kernels import embedding_bag, embedding_bag_ref
    V, B, L = 3_000, 2_000, 40
    table = torch.rand((V, F), generator=gen, device="cuda")
    ids = torch.randint(0, V + 10, (B, L), generator=gen, device="cuda",
                        dtype=torch.int32)
    keep = torch.randint(0, L + 1, (B, 1), generator=gen, device="cuda")
    ids = torch.where(torch.arange(L, device="cuda") < keep, ids, -1)
    got = embedding_bag(table, ids)
    torch.testing.assert_close(got.double(),
                               embedding_bag_ref(table.double(), ids),
                               **BAG_TOL)


@pytest.mark.parametrize("offset", [0, 1])
def test_embedding_bag_kernel_one_slot_bags_are_exact(gen, offset):
    """The SASRec lookup: one slot per bag, a scalar weight; bit for bit the
    plain version, also from a table whose rows are not 8-byte aligned."""
    from repro_torch.kernels import embedding_bag, embedding_bag_ref
    V, F, N = 10_000, 50, 30_000
    table = torch.randn(V * F + offset, generator=gen,
                        device="cuda")[offset:].view(V, F)
    ids = torch.randint(-1, V, (N, 1), generator=gen, device="cuda",
                        dtype=torch.int32)
    w = torch.full((), 50 ** 0.5, device="cuda")
    got = embedding_bag(table, ids, w)
    assert torch.equal(got, embedding_bag_ref(table, ids, w))
    assert not got[ids[:, 0] < 0].any()


@pytest.mark.parametrize("F", [50, 49, 64])
@pytest.mark.parametrize("L", [1, 2, 3, 4])
def test_embedding_bag_short_kernel_is_exact(gen, L, F):
    """Fixed-length bags of 1-4 slots go to the short-bag kernel: one-slot
    bags bit for bit the plain version; 2-4 slots within rtol 1e-5 of a
    float64 sum and bit for bit the warp-per-bag kernel (both fmaf in slot
    order; the plain version rounds each product before it adds).  Ids -1
    and >= V among the slots; a number, a one-element tensor and a tensor
    of weights; bit-identical on a repeat."""
    from repro_torch import backend
    from repro_torch.kernels import (embedding_bag, embedding_bag_ref,
                                     embedding_bag_sorted)
    from repro_torch.kernels.embedding_bag.ops import kernel_route
    V, B = 4_000, 20_001
    assert kernel_route(B, L, F) == "short_bags"
    assert kernel_route(B, 0, F) == "warp_per_bag"
    table = torch.rand((V, F), generator=gen, device="cuda")
    ids = torch.randint(-1, V + 5, (B, L), generator=gen, device="cuda",
                        dtype=torch.int32)
    w_bag = torch.rand((B, L), generator=gen, device="cuda")
    seg = torch.arange(B, dtype=torch.int32,
                       device="cuda").repeat_interleave(L)
    for w in (None, 7.0710678, torch.full((), 0.37, device="cuda"), w_bag):
        before = backend.LAUNCHES["embedding_bag"]
        got = embedding_bag(table, ids, w)
        assert backend.LAUNCHES["embedding_bag"] == before + 1
        assert torch.equal(got, embedding_bag(table, ids, w))
        assert not got[(ids < 0).all(dim=1)].any()
        if L == 1:
            assert torch.equal(got, embedding_bag_ref(table, ids, w))
        wd = w.double() if isinstance(w, torch.Tensor) else w
        torch.testing.assert_close(
            got.double(), embedding_bag_ref(table.double(), ids, wd),
            **BAG_TOL)
        w_flat = torch.ones((B, L), device="cuda") if w is None else (
            torch.tensor(w, dtype=torch.float32, device="cuda")
            if not isinstance(w, torch.Tensor) else w).expand(B, L)
        warp = embedding_bag_sorted(table, ids.reshape(-1), seg,
                                    w_flat.reshape(-1).contiguous(), B)
        assert torch.equal(got, warp)


def test_sasrec_on_the_card_matches_the_host(gen):
    """SASRec at the smoke config: the same weights and histories on the
    card (both kernels) and on the host (plain versions)."""
    from repro_torch import backend
    from repro_torch.configs.sasrec import smoke_config
    from repro_torch.models.recsys import sasrec as M
    cfg = smoke_config()
    params = M.init_params(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    on_card = _to_card(params)
    host = torch.Generator().manual_seed(5)
    seq = torch.randint(0, cfg.n_items + 1, (16, cfg.seq_len),
                        generator=host, dtype=torch.int32)
    cands = torch.randint(1, cfg.n_items + 1, (16, 64), generator=host,
                          dtype=torch.int32)
    before = dict(backend.LAUNCHES)
    card = M.score_candidates(on_card, cfg, seq.cuda(), cands.cuda())
    assert backend.LAUNCHES["embedding_bag"] > before["embedding_bag"]
    assert backend.LAUNCHES["block_gather"] > before["block_gather"]
    torch.testing.assert_close(card.cpu(), M.score_candidates(params, cfg,
                                                              seq, cands),
                               rtol=1e-5, atol=1e-6)
    vals, _ = M.serve_step_topk(on_card, cfg, seq.cuda(), k=10)
    torch.testing.assert_close(vals.cpu(), M.serve_step_topk(params, cfg, seq,
                                                             k=10)[0],
                               rtol=1e-5, atol=1e-6)


def test_service_on_the_card_matches_the_host(gen):
    import numpy as np

    from repro_torch import interop
    from repro_torch.data.synthetic import rmat_edges, update_stream
    from repro_torch.stream.service import GraphService
    src, dst = rmat_edges(500, 4000, seed=1, device="cpu")
    svcs = [GraphService.from_coo(src, dst, num_vertices=500, block_width=8,
                                  log_capacity=2048, device=d)
            for d in ("cuda", "cpu")]
    for s, d, w, op in update_stream(500, (src, dst), 600, 2, seed=2,
                                     device="cpu"):
        reps = []
        for svc in svcs:
            svc.apply(s, d, w, op)
            reps.append(svc.flush())
        assert reps[0] == reps[1]
        a, b = (interop.cbl_to_numpy(svc.snapshot.cbl) for svc in svcs)
        for k in b["store"]:
            np.testing.assert_array_equal(a["store"][k], b["store"][k])
        for k in ("v_deg", "v_level", "v_head", "v_tail"):
            np.testing.assert_array_equal(a[k], b[k])
    pr = [interop.to_numpy(svc.analytics("pagerank")) for svc in svcs]
    np.testing.assert_allclose(pr[0], pr[1], rtol=1e-5, atol=1e-8)
    for name in ("bfs", "cc"):
        out = [interop.to_numpy(svc.analytics(name)) for svc in svcs]
        np.testing.assert_array_equal(out[0], out[1])


@pytest.mark.parametrize("S", [2, 3])
def test_sharded_service_on_the_card_matches_the_host(gen, S):
    """``GraphService(n_shards=S)`` on the card and on the host: flush
    reports and the stacked stores bit for bit, reads and BFS / CC exact,
    PageRank within rtol; the graph kernels launch on every shard."""
    import numpy as np

    from repro_torch import backend, interop
    from repro_torch.data.synthetic import rmat_edges, update_stream
    from repro_torch.stream.service import GraphService
    src, dst = rmat_edges(500, 4000, seed=3, device="cpu")
    svcs = [GraphService.from_coo(src, dst, num_vertices=500, block_width=8,
                                  log_capacity=2048, n_shards=S, device=d)
            for d in ("cuda", "cpu")]
    for s, d, w, op in update_stream(500, (src, dst), 600, 2, seed=4,
                                     device="cpu"):
        reps = []
        for svc in svcs:
            svc.apply(s, d, w, op)
            reps.append(svc.flush())
        assert reps[0] == reps[1]
        a, b = (interop.sharded_to_numpy(svc.snapshot.cbl) for svc in svcs)
        np.testing.assert_array_equal(a["v_shard"], b["v_shard"])
        for k in b["shards"]["store"]:
            np.testing.assert_array_equal(a["shards"]["store"][k],
                                          b["shards"]["store"][k])
        for k in ("v_deg", "v_level", "v_head", "v_tail"):
            np.testing.assert_array_equal(a["shards"][k], b["shards"][k])
        found = [interop.to_numpy(svc.query_edges(s, d)[0]) for svc in svcs]
        np.testing.assert_array_equal(found[0], found[1])
    backend.reset_launch_counts()
    pr = [interop.to_numpy(svc.analytics("pagerank")) for svc in svcs]
    assert backend.PLAN_BUILDS == S
    assert backend.LAUNCHES["segment_sum"] >= S
    assert backend.LAUNCHES["block_gather"] >= S
    np.testing.assert_allclose(pr[0], pr[1], rtol=1e-5, atol=1e-8)
    for name in ("bfs", "cc"):
        out = [interop.to_numpy(svc.analytics(name)) for svc in svcs]
        np.testing.assert_array_equal(out[0], out[1])


# attention kernels: float32 within rtol 1e-4 of the plain version (the sums
# run in another order); bfloat16 paged attention within one bf16 ulp (2^-7
# relative), since it computes in float32 and rounds once at the end
ATTN_TOL = {torch.float32: dict(rtol=1e-4, atol=1e-5),
            torch.bfloat16: dict(rtol=2 ** -7, atol=1e-5)}
# the bf16 flash kernel (tensor cores) rounds P to bf16 before P·V: each p
# moves by at most 2^-8 · p, the output by at most 2^-8 · max_k |v[k, d]|
FLASH_KERNEL = {torch.float32: "flash_attention",
                torch.bfloat16: "flash_attention_wgmma"}


def _assert_flash_close(got, ref, v, group):
    """float32: ATTN_TOL; bf16: |got - ref| <= 2^-7 |ref| + 2^-8 max_k |v|
    + 1e-5 per (b, head, d)."""
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, ref, **ATTN_TOL[torch.float32])
        return
    ref = ref.float()
    vmax = v.float().abs().amax(dim=2, keepdim=True) \
        .repeat_interleave(group, dim=1)
    err = (got.float() - ref).abs()
    bound = 2 ** -7 * ref.abs() + 2 ** -8 * vmax + 1e-5
    assert bool((err <= bound).all()), \
        f"max err {float(err.max()):.3e}, worst err/bound " \
        f"{float((err / bound).max()):.3f}"


def _flash_case(gen, dtype, B, H, KVH, S, D, causal, window, cap,
                strided=False):
    """One call of the flash kernel against the plain version: the launch
    counted under the dtype's kernel, a repeat bit-identical."""
    from repro_torch import backend
    from repro_torch.kernels import attention_ref, flash_attention
    if strided:              # [B, S, H, D] viewed as [B, H, S, D], no copy
        q, k, v = (torch.randn((B, S, n, D), generator=gen, device="cuda")
                   .to(dtype).transpose(1, 2) for n in (H, KVH, KVH))
    else:
        q, k, v = (torch.randn((B, n, S, D), generator=gen, device="cuda")
                   .to(dtype) for n in (H, KVH, KVH))
    kw = dict(scale=D ** -0.5, causal=causal, window=window, softcap=cap)
    before = dict(backend.LAUNCHES)
    got = flash_attention(q, k, v, **kw)
    assert backend.LAUNCHES[FLASH_KERNEL[dtype]] == \
        before[FLASH_KERNEL[dtype]] + 1
    other = FLASH_KERNEL[torch.float32 if dtype == torch.bfloat16
                         else torch.bfloat16]
    assert backend.LAUNCHES[other] == before[other]
    torch.cuda.synchronize()
    _assert_flash_close(got, attention_ref(q, k, v, **kw), v, H // KVH)
    assert torch.equal(got, flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,KVH,S,D,causal,window,cap", [
    (1, 2, 2, 64, 16, True, 0, 0.0),
    (2, 4, 2, 128, 32, True, 0, 50.0),
    (1, 2, 1, 64, 16, True, 32, 0.0),
    (1, 2, 2, 64, 16, False, 0, 0.0),
    (2, 4, 2, 1, 128, True, 0, 50.0),          # S = 1
    (1, 4, 2, 200, 128, True, 48, 50.0),       # ragged S, window
    (1, 2, 1, 130, 96, False, 40, 0.0),        # non-causal with a window
    (1, 2, 2, 70, 256, True, 0, 30.0),         # widest head
    (1, 32, 4, 300, 128, True, 0, 0.0),        # qwen3-moe: G = 8, no cap
])
def test_flash_attention_kernel_matches_plain(gen, dtype, B, H, KVH, S, D,
                                              causal, window, cap):
    _flash_case(gen, dtype, B, H, KVH, S, D, causal, window, cap)


@pytest.mark.parametrize("S", [127, 128, 129, 1000])
@pytest.mark.parametrize("D", [64, 96, 128, 256])
def test_flash_attention_bf16_tile_edges(gen, S, D):
    """bf16 through the tensor-core kernel around the 128-row query tile
    and the 128-key (64 at D 256) kv tile, every head width template."""
    _flash_case(gen, torch.bfloat16, 1, 4, 2, S, D, True, 0, 50.0)


@pytest.mark.parametrize("S", [32, 33, 64, 65, 127, 128, 129, 1000])
@pytest.mark.parametrize("D", [16, 20, 32, 64, 96, 128, 256])
def test_flash_attention_f32_tile_edges(gen, S, D):
    """float32 through the split-TF32 kernel around its query tiles (64
    rows a warpgroup, 128 a CTA; 64 at D 256) and its kv tiles (64 keys at
    D <= 64, 32 above), every head-dim template (DP 32, 64, 128, 256) and a
    D off the 8-column grid."""
    _flash_case(gen, torch.float32, 1, 4, 2, S, D, True, 0, 50.0)


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [100, 4096])
def test_flash_attention_f32_groups_and_windows(gen, G, window):
    """float32: windows inside S and past it, 1, 2 and 4 query heads to a
    kv head, the model's strided [B, S, H, D] views."""
    _flash_case(gen, torch.float32, 2, 2 * G, 2, 700, 128, True, window,
                50.0, strided=True)


def _attention_f64(q, k, v, *, scale, causal, window, softcap):
    """The plain attention in float64: the exact answer to hold float32
    results to."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    qg = q.double().reshape(B, KVH, H // KVH, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.double()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    live = pos[:, None] >= pos[None, :] if causal else \
        torch.ones((S, S), dtype=torch.bool, device=q.device)
    if window > 0:
        live &= (pos[:, None] - pos[None, :]) < window
    p = torch.softmax(torch.where(live, s, -1e30), dim=-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v.double()) \
        .reshape(B, H, S, D)


@pytest.mark.parametrize("B,H,KVH,S,D,window,cap", [
    (2, 4, 2, 64, 16, 8, 50.0),        # the Gemma-2 smoke config, local
    (2, 4, 2, 64, 16, 0, 50.0),        # and global layer
    (1, 4, 2, 512, 128, 0, 50.0),      # the 27B head
    (1, 2, 1, 300, 64, 96, 0.0),       # a window, no softcap
    (1, 2, 2, 512, 256, 0, 50.0),      # the widest head
])
def test_flash_attention_f32_twice_the_input_scale(gen, B, H, KVH, S, D,
                                                   window, cap):
    """float32 at twice standard-normal inputs (logits four times as
    large): the split-TF32 kernel within 1e-4 |exact| + 1e-5 of the float64
    answer.  Split TF32 keeps 22 of float32's 24 bits, so its margin shrinks
    with the logits; float32 done plainly loses margin the same way (at
    D 256 the plain version misses this bound).  With every S product in
    one accumulator the kernel missed it at D 128 and 256: this holds the
    separate accumulator of the small products.  Prints the worst err /
    bound of the kernel and of the float32 plain version against the
    float64 answer."""
    from repro_torch.kernels import attention_ref, flash_attention
    q, k, v = (2 * torch.randn((B, n, S, D), generator=gen, device="cuda")
               for n in (H, KVH, KVH))
    kw = dict(scale=D ** -0.5, causal=True, window=window, softcap=cap)
    exact = _attention_f64(q, k, v, **kw)
    bound = 1e-4 * exact.abs() + 1e-5
    got = flash_attention(q, k, v, **kw)
    kernel = float(((got.double() - exact).abs() / bound).max())
    plain = float(((attention_ref(q, k, v, **kw).double() - exact).abs()
                   / bound).max())
    print(f"x2 S={S} D={D} window={window}: worst err/bound kernel "
          f"{kernel:.3f}, float32 plain {plain:.3f}")
    assert kernel <= 1.0, f"kernel err/bound {kernel:.3f}"
    assert torch.equal(got, flash_attention(q, k, v, **kw))


@pytest.mark.parametrize("G", [1, 2, 4])
@pytest.mark.parametrize("window", [100, 200, 4096])
def test_flash_attention_bf16_groups_and_windows(gen, G, window):
    """Windows that end inside a kv tile (100, 200) and one past S, with
    1, 2 and 4 query heads to a kv head."""
    _flash_case(gen, torch.bfloat16, 2, 2 * G, 2, 700, 128, True, window,
                50.0)


def test_flash_attention_kernel_takes_strided_heads(gen):
    """q/k/v as the model hands them over: [B, S, H, D] viewed as
    [B, H, S, D] (no copy)."""
    from repro_torch.kernels import attention_ref, flash_attention
    B, S, H, KVH, D = 2, 150, 4, 2, 128
    q = torch.randn((B, S, H, D), generator=gen, device="cuda").transpose(1, 2)
    k = torch.randn((B, S, KVH, D), generator=gen, device="cuda") \
        .transpose(1, 2)
    v = torch.randn((B, S, KVH, D), generator=gen, device="cuda") \
        .transpose(1, 2)
    kw = dict(scale=D ** -0.5, causal=True, window=64, softcap=50.0)
    got = flash_attention(q, k, v, **kw)
    torch.testing.assert_close(got, attention_ref(q, k, v, **kw),
                               **ATTN_TOL[torch.float32])


@pytest.mark.parametrize("S,window", [(150, 64), (1000, 300)])
def test_flash_attention_bf16_takes_strided_heads(gen, S, window):
    """The model's [B, S, H, D] views in bf16 go into the tensor maps as
    they are."""
    _flash_case(gen, torch.bfloat16, 2, 4, 2, S, 128, True, window, 50.0,
                strided=True)


def test_flash_attention_bf16_rejects_head_dim_off_the_tma_grid(gen):
    from repro_torch.kernels import flash_attention
    q, k, v = (torch.randn((1, 2, 64, 20), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    with pytest.raises(ValueError):
        flash_attention(q, k, v, scale=0.25)


def _paged_inputs(gen, B, KVH, G, D, page, NP, P, dtype):
    q = torch.randn((B, KVH, G, D), generator=gen, device="cuda").to(dtype)
    kp = torch.randn((KVH, P, page, D), generator=gen, device="cuda").to(dtype)
    vp = torch.randn((KVH, P, page, D), generator=gen, device="cuda").to(dtype)
    perm = torch.randperm(P, generator=gen, device="cuda")[:B * NP]
    bt = perm.reshape(B, NP).to(torch.int32)
    return q, kp, vp, bt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KVH,G,D,page,NP,window,cap", [
    (2, 2, 4, 16, 8, 6, 0, 0.0),
    (3, 1, 8, 32, 16, 4, 0, 50.0),
    (2, 2, 2, 16, 8, 6, 24, 0.0),
    (4, 4, 2, 128, 128, 5, 200, 50.0),         # the Gemma-2 group shape
    (2, 2, 2, 256, 32, 3, 0, 0.0),
    (2, 2, 2, 18, 8, 4, 0, 50.0),              # rows not 16-byte aligned
    (8, 4, 8, 128, 128, 5, 0, 0.0),            # the qwen3-moe group shape
])
def test_paged_attention_kernel_matches_plain(gen, dtype, B, KVH, G, D, page,
                                              NP, window, cap):
    from repro_torch import backend
    from repro_torch.kernels import paged_attention, paged_attention_ref
    P = B * NP + 3
    q, kp, vp, bt = _paged_inputs(gen, B, KVH, G, D, page, NP, P, dtype)
    # lengths 0, 1, a page boundary and its neighbour, and random ones;
    # slots past each length are -1, as the KV cache leaves them
    edge = torch.tensor([0, 1, page, page + 1, NP * page], device="cuda")
    lens = torch.randint(1, NP * page + 1, (B,), generator=gen,
                         device="cuda")
    lens[:min(B, 5)] = edge[:min(B, 5)]
    lens = lens.to(torch.int32)
    slots = torch.arange(NP, device="cuda")[None, :]
    bt = torch.where(slots * page < lens[:, None], bt, -1).to(torch.int32)
    kw = dict(scale=D ** -0.5, window=window, softcap=cap)
    before = backend.LAUNCHES["paged_attention"]
    got = paged_attention(q, kp, vp, bt, lens, **kw)
    assert backend.LAUNCHES["paged_attention"] == before + 1
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, bt, lens, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[dtype])
    # lengths == 0 is the reference's uniform average over every slot
    empty = lens == 0
    if bool(empty.any()):
        assert torch.isfinite(got[empty].float()).all()


def test_paged_attention_kernel_clamps_out_of_pool_ids(gen):
    """Ids >= P (a dry pool) read page P - 1 and -1 reads page 0, as the
    plain version does; no address outside the pool is formed."""
    from repro_torch.kernels import paged_attention, paged_attention_ref
    B, KVH, G, D, page, NP, P = 3, 2, 2, 64, 16, 4, 12
    q, kp, vp, bt = _paged_inputs(gen, B, KVH, G, D, page, NP, P,
                                  torch.float32)
    bt[0, 1] = P
    bt[1, 2] = -1
    bt[2, 0] = P + 1000
    lens = torch.full((B,), NP * page, dtype=torch.int32, device="cuda")
    kw = dict(scale=D ** -0.5, window=0, softcap=50.0)
    got = paged_attention(q, kp, vp, bt, lens, **kw)
    torch.testing.assert_close(got, paged_attention_ref(q, kp, vp, bt, lens,
                                                        **kw),
                               **ATTN_TOL[torch.float32])


def test_lm_serve_on_the_card_matches_the_host(gen):
    """``serve`` at the Gemma-2 smoke config (float32): the same weights
    and prompts on the card (flash and paged kernels) and on the host (plain
    versions) give the same greedy tokens and close prefill logits."""
    from repro_torch import backend
    from repro_torch.configs.gemma2_27b import smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import model as M
    cfg = smoke_config()
    params = M.init_params(cfg, seed=3, device="cpu")
    on_card = _to_card(params)
    host = torch.Generator().manual_seed(4)
    lens = torch.randint(20, 70, (5,), generator=host)
    prompts = torch.randint(0, cfg.vocab, (5, int(lens.max())),
                            generator=host)
    before = dict(backend.LAUNCHES)
    res = [serve(cfg, p, prompts, lens, 12, page=16, device=d)
           for p, d in ((on_card, "cuda"), (params, "cpu"))]
    assert backend.LAUNCHES["flash_attention"] > before["flash_attention"]
    assert backend.LAUNCHES["paged_attention"] > before["paged_attention"]
    torch.testing.assert_close(res[0].prefill_logits.cpu(),
                               res[1].prefill_logits, rtol=1e-4, atol=1e-5)
    assert torch.equal(res[0].tokens.cpu(), res[1].tokens)
    for c_card, c_host in zip(res[0].caches, res[1].caches):
        assert torch.equal(c_card.block_table.cpu(), c_host.block_table)
        assert torch.equal(c_card.free_top.cpu(), c_host.free_top)


def _split_case(gen, dtype, case):
    """Inputs of one split-kernel case: (q, k_pages, v_pages, block_table,
    lengths, window, softcap).  B = 4, KVH = 2, G = 2, D = 32, page 8, 6
    slots.  ``lengths`` 0, 1, full (48) and one inside a page; ``window``
    starts inside a split; ``ids`` puts -1 and ids >= P in live slots."""
    B, KVH, G, D, page, NP, P = 4, 2, 2, 32, 8, 6, 30
    q, kp, vp, bt = _paged_inputs(gen, B, KVH, G, D, page, NP, P, dtype)
    lens = torch.tensor([0, 1, NP * page, 29], dtype=torch.int32,
                        device="cuda")
    window, cap = {"plain": (0, 0.0), "softcap": (0, 50.0),
                   "window": (13, 0.0), "window_softcap": (21, 50.0),
                   "ids": (0, 50.0)}[case]
    if case == "ids":
        bt[2, 1], bt[2, 4], bt[3, 0] = -1, P, P + 7
    return q, kp, vp, bt, lens, window, cap


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pps", [1, 2, 6])
@pytest.mark.parametrize("case", ["plain", "softcap", "window",
                                  "window_softcap", "ids"])
def test_paged_attention_split_kernel_matches_plain(gen, dtype, pps, case):
    """The split kernel at 1, 2 and all 6 slots a split against the plain
    version, one launch each, and two launches give the same bits."""
    from repro_torch import backend
    from repro_torch.kernels import paged_attention_ref, paged_attention_split
    q, kp, vp, bt, lens, window, cap = _split_case(gen, dtype, case)
    kw = dict(scale=q.shape[-1] ** -0.5, window=window, softcap=cap)
    before = backend.LAUNCHES["paged_attention"]
    got = paged_attention_split(q, kp, vp, bt, lens, pages_per_split=pps,
                                **kw)
    assert backend.LAUNCHES["paged_attention"] == before + 1
    torch.cuda.synchronize()
    ref = paged_attention_ref(q, kp, vp, bt, lens, **kw)
    torch.testing.assert_close(got.float(), ref.float(), **ATTN_TOL[dtype])
    assert torch.equal(got, paged_attention_split(
        q, kp, vp, bt, lens, pages_per_split=pps, **kw))


def test_lm_serve_graph_matches_the_eager_loop(gen):
    """``serve`` at the Gemma-2 smoke config on the card: the decode steps
    replayed from one CUDA graph give the eager loop's greedy tokens and
    cache state, with the same paged launches counted on both routes."""
    from repro_torch import backend
    from repro_torch.configs.gemma2_27b import smoke_config
    from repro_torch.launch.serve import serve
    from repro_torch.models.transformer import model as M
    cfg = smoke_config()
    params = M.init_params(cfg, seed=5, device="cuda")
    lens = torch.randint(20, 70, (5,), generator=gen, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (5, int(lens.max())),
                            generator=gen, device="cuda")
    res, launches = [], []
    for graph in (True, False):
        backend.reset_launch_counts()
        res.append(serve(cfg, params, prompts, lens, 12, page=16,
                         device="cuda", graph=graph))
        launches.append(backend.LAUNCHES["paged_attention"])
    assert [r.graph for r in res] == [True, False]
    assert launches[0] == launches[1] == cfg.n_layers * 12
    assert torch.equal(res[0].tokens, res[1].tokens)
    for c_graph, c_eager in zip(res[0].caches, res[1].caches):
        for name in ("block_table", "lengths", "free_top"):
            assert torch.equal(getattr(c_graph, name), getattr(c_eager, name))
        torch.testing.assert_close(c_graph.k_pages, c_eager.k_pages,
                                   **ATTN_TOL[torch.float32])


# ---- the FindNeighbor chain walks ------------------------------------------

def _walk_store(width, hub_blocks=0, seed=0):
    """A CBList on the host with overlapping chains (parallel and re-inserted
    edges after two update batches) and, with ``hub_blocks``, vertex 0
    holding a chain of that many blocks; its edges and the card's copy."""
    from repro_torch.core.cblist import build_from_coo
    from repro_torch.core.updates import batch_update_stats
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.stream.snapshot import device_replica, snapshot_of
    g = torch.Generator().manual_seed(seed)
    nv = 3000
    src, dst = rmat_edges(nv, 20_000, seed=seed, device="cpu")
    if hub_blocks:
        hub = torch.arange(1, hub_blocks * width + 1, dtype=torch.int32) % nv
        keep = src != 0
        src = torch.cat([src[keep], torch.zeros_like(hub)])
        dst = torch.cat([dst[keep], hub])
    cbl = build_from_coo(src, dst, None, num_vertices=nv,
                         num_blocks=40_000 + 2 * hub_blocks,
                         block_width=width)
    for _ in range(2):
        n = 4000
        us = torch.cat([src[torch.randint(0, src.numel(), (n // 2,),
                                          generator=g)],
                        torch.randint(0, nv, (n // 2,), generator=g,
                                      dtype=torch.int32)])
        ud = torch.cat([dst[torch.randint(0, dst.numel(), (n // 2,),
                                          generator=g)],
                        torch.randint(0, nv, (n // 2,), generator=g,
                                      dtype=torch.int32)])
        op = torch.where(torch.rand(n, generator=g) < 0.3, -1, 1).to(
            torch.int32)
        cbl, stats = batch_update_stats(cbl, us, ud, None, op)
        assert int(stats.dropped_edges) == 0
    return cbl, (src, dst), device_replica(snapshot_of(cbl), "cuda").cbl


@pytest.mark.parametrize("width,hub_blocks", [(8, 1100), (32, 1100),
                                              (128, 0), (10, 0), (256, 0),
                                              (1030, 0)])
def test_chain_walk_locate_matches_plain(gen, width, hub_blocks):
    """Widths 8-128 take one pass of 16-byte loads, 256 two chunks a lane,
    10 and 1030 single keys (1030: several passes)."""
    from repro_torch import backend
    from repro_torch.kernels.chain_walk import locate, locate_ref
    cbl, (src, dst), card = _walk_store(width, hub_blocks)
    g = torch.Generator().manual_seed(1)
    n = 50_000
    pick = torch.randint(0, src.numel(), (n // 2,), generator=g)
    qs = torch.cat([src[pick], torch.randint(-5, 3010, (n // 2,),
                                             generator=g, dtype=torch.int32)])
    qd = torch.cat([dst[pick], torch.randint(0, 3000, (n // 2,),
                                             generator=g, dtype=torch.int32)])
    if hub_blocks:                       # keys at the hub chain's far end
        qs[:64] = 0
        qd[:64] = torch.arange(hub_blocks * width - 64, hub_blocks * width,
                               dtype=torch.int32) % 3000 + 1
        qs[64:96], qd[64:96] = 0, 5000       # absent: the whole chain
    active = torch.rand(n, generator=g) < 0.9
    st, cst = cbl.store, card.store
    ref = locate_ref(st.keys, st.nxt, cbl.v_head, qs, qd, active)
    assert int((ref[0] != -1).sum()) > n // 4
    before = backend.LAUNCHES["chain_walk_locate"]
    args = (cst.keys, cst.nxt, card.v_head, qs.cuda(), qd.cuda(),
            active.cuda())
    got = locate(*args)
    assert backend.LAUNCHES["chain_walk_locate"] == before + 1
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert torch.equal(a.cpu(), b)
    assert all(torch.equal(a, b) for a, b in zip(got, locate(*args)))


@pytest.mark.parametrize("width,hub_blocks", [(8, 1100), (32, 0), (128, 0)])
def test_chain_walk_rank_matches_plain(gen, width, hub_blocks):
    from repro_torch import backend
    from repro_torch.kernels.chain_walk import rank_walk, rank_walk_ref
    cbl, _, card = _walk_store(width, hub_blocks, seed=3)
    g = torch.Generator().manual_seed(4)
    verts = torch.randint(0, 3000, (4000,), generator=g)
    verts[:8] = 0
    deg = cbl.v_deg[verts]
    heads = torch.where(deg > 0, cbl.v_head[verts], -1).to(torch.int32)
    k = 15
    ranks = (torch.rand((4000, k), generator=g)
             * (deg.clamp(min=1)[:, None] + 2)).to(torch.int32)   # some past
    st, cst = cbl.store, card.store
    ref = rank_walk_ref(st.keys, st.count, st.nxt, heads, ranks)
    before = backend.LAUNCHES["chain_walk_rank"]
    got = rank_walk(cst.keys, cst.count, cst.nxt, heads.cuda(), ranks.cuda())
    assert backend.LAUNCHES["chain_walk_rank"] == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), ref)
    assert int((ref != -1).sum()) > ref.numel() // 3


def test_read_edges_on_the_card_makes_no_host_sync(gen):
    from repro_torch.core.updates import read_edges
    cbl, (src, dst), card = _walk_store(32, 200)
    qs, qd = src[:5000].cuda(), dst[:5000].cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        found, w = read_edges(card, qs, qd)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = read_edges(cbl, src[:5000], dst[:5000])
    assert torch.equal(found.cpu(), ref[0]) and torch.equal(w.cpu(), ref[1])


# ---- the serving frontend on the card --------------------------------------

def _serve_trace(nv, src, dst, n=300, seed=0):
    """(dt, request) pairs of all five kinds over two tenants."""
    import numpy as np

    from repro_torch.serve import (Analytics, DegreeRead, KHopSample,
                                   PointRead, UpdateBatch)
    rng = np.random.default_rng(seed)
    s, d = src.numpy(), dst.numpy()
    out = []
    for i in range(n):
        m = int(rng.integers(4, 33))
        tenant = "fraud" if rng.random() < 0.5 else "dashboard"
        cls = "interactive" if tenant == "fraud" else "standard"
        k = int(rng.choice(5, p=[0.45, 0.2, 0.25, 0.07, 0.03]))
        j = rng.integers(0, len(s), m)
        if k == 0:
            req = PointRead(qsrc=s[j], qdst=d[j], tenant=tenant,
                            latency_class=cls)
        elif k == 1:
            req = DegreeRead(verts=rng.integers(0, nv, m), tenant=tenant,
                             latency_class=cls)
        elif k == 2:
            req = UpdateBatch(src=np.where(rng.random(m) < 0.5, s[j],
                                           rng.integers(0, nv, m)),
                              dst=np.where(rng.random(m) < 0.5, d[j],
                                           rng.integers(0, nv, m)),
                              op=np.where(rng.random(m) < 0.2, -1, 1),
                              w=rng.random(m).astype(np.float32),
                              tenant="fraud", latency_class="batch")
        elif k == 3:
            req = KHopSample(seeds=s[j[:4]], seed=i, tenant=tenant,
                             latency_class=cls)
        else:
            req = Analytics(name="pagerank", kw=(("max_iters", 8),),
                            tenant="dashboard", latency_class="batch")
        out.append((float(rng.exponential(1 / 2000)), req))
    return out


def _serve_run(device, nv, src, dst, trace):
    from repro_torch.serve import (ManualClock, ServeFrontend,
                                   choose_serve_plan)
    from repro_torch.stream.service import GraphService
    svc = GraphService.from_coo(src, dst, num_vertices=nv, block_width=8,
                                log_capacity=1024, device=device)
    clock = ManualClock()
    front = ServeFrontend(svc, choose_serve_plan(
        2000.0, 16.0, log_capacity=1024), clock=clock, fanout=(4, 3))
    front.register_tenant("fraud", read_your_writes=True)
    front.register_tenant("dashboard")
    tickets = []
    for dt, req in trace:
        clock.advance(dt)
        tickets.append(front.submit(req))
        front.step()
    front.drain(flush=True)
    return front, tickets


def test_serve_trace_on_the_card_matches_the_host(gen):
    """The same trace through ServeFrontend on the card and on the host:
    point and degree values, update receipts and every version bit for bit,
    PageRank within rtol 1e-5, the same report counts; k-hop samples (drawn
    from each device's generator) hold their invariants."""
    import numpy as np

    from repro_torch import backend
    from repro_torch.core.updates import read_edges
    from repro_torch.data.synthetic import rmat_edges
    src, dst = rmat_edges(800, 6000, seed=4, device="cpu")
    trace = _serve_trace(800, src, dst)
    backend.reset_launch_counts()
    card, card_t = _serve_run("cuda", 800, src, dst, trace)
    assert backend.LAUNCHES["chain_walk_locate"] > 0
    assert backend.LAUNCHES["chain_walk_rank"] > 0
    host, host_t = _serve_run("cpu", 800, src, dst, trace)
    for a, b in zip(card_t, host_t):
        assert a.done and b.done and a.version == b.version
        kind = a.request.kind
        if kind in ("point_read", "degree_read"):
            for k in a.value:
                np.testing.assert_array_equal(a.value[k], b.value[k])
        elif kind == "update":
            assert a.value == b.value
        elif kind == "analytics":
            torch.testing.assert_close(a.value.cpu(), b.value, rtol=1e-5,
                                       atol=1e-8)
        else:
            v = a.value
            ok = torch.as_tensor(v["valid"])
            found, _ = read_edges(card.service.snapshot.cbl,
                                  torch.as_tensor(v["src"]).cuda(),
                                  torch.as_tensor(v["dst"]).cuda())
            # edges sampled at an older version may since be deleted
            assert int((found.cpu() & ok).sum()) >= int(ok.sum()) // 2
    a, b = card.report(), host.report()
    for k in ("kinds", "service", "completed", "admission"):
        assert a[k] == b[k], k


def test_serve_dispatch_on_the_card_makes_no_host_sync(gen):
    """A point-read micro-batch's dispatch (snapshot replica, chain walk)
    runs under sync debug mode "error"; the collect pass then syncs once."""
    import numpy as np

    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.serve import (ManualClock, PointRead, ServeFrontend,
                                   choose_serve_plan)
    from repro_torch.stream.service import GraphService
    src, dst = rmat_edges(800, 6000, seed=5, device="cpu")
    svc = GraphService.from_coo(src, dst, num_vertices=800, block_width=32,
                                device="cuda")
    clock = ManualClock()
    front = ServeFrontend(svc, choose_serve_plan(2000.0, 16.0), clock=clock)
    t = front.submit(PointRead(qsrc=src[:40].numpy(), qdst=dst[:40].numpy()))
    clock.advance(1.0)
    front.read_plane.broadcast(svc.snapshot)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        front._pump((("point_read", False),), clock())
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert not t.done and len(front._inflight) == 1
    front._collect(clock())
    assert t.done and bool(np.all(t.value["found"]))


# ---------------------------------------------------------------------------
# GNN training: the aggregation's two kernels forward and backward
# ---------------------------------------------------------------------------

def _rmat_batch(n, e, d_in, n_classes, seed):
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.models.gnn.common import GraphBatch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    src, dst = rmat_edges(n, e, seed=seed, device="cuda")
    E = src.numel()
    return GraphBatch(
        x=torch.randn((n, d_in), generator=gen, device="cuda"),
        edge_src=src, edge_dst=dst,
        edge_valid=torch.rand(E, generator=gen, device="cuda") < 0.95,
        node_valid=torch.ones(n, dtype=torch.bool, device="cuda"),
        graph_id=torch.zeros(n, dtype=torch.int32, device="cuda"),
        labels=torch.randint(0, n_classes, (n,), generator=gen,
                             device="cuda", dtype=torch.int32)).with_plan()


def test_gnn_aggregation_past_2_31_elements_matches_plain(gen):
    """scatter_sum(h[src], dst) at E x F > 2^31 (the int64 paths of both
    kernels): forward and backward within rtol 1e-5 of float64 sums, one
    launch of each kernel each way, bit-identical on a repeat."""
    from repro_torch import backend
    from repro_torch.models.gnn.common import aggregate
    g = _rmat_batch(1 << 20, 40_000_000, 64, 2, seed=3)
    p = g.plan
    assert p.num_valid * 64 > 2 ** 31
    h = g.x.clone().requires_grad_()
    backend.reset_launch_counts()
    out = aggregate(h, g)
    assert backend.LAUNCHES["segment_sum"] == 1
    assert backend.LAUNCHES["block_gather"] == 1
    grad_out = torch.randn(out.shape, generator=gen, device="cuda")
    (grad_h,) = torch.autograd.grad(out, h, grad_out)
    assert backend.LAUNCHES["segment_sum"] == 2
    assert backend.LAUNCHES["block_gather"] == 2
    torch.cuda.synchronize()
    src, dst = p.src_by_dst.long(), p.dst_by_src.long()
    for got, table, ids, seg in (
            (out, g.x, src, torch.repeat_interleave(
                torch.arange(g.num_nodes, device="cuda"),
                (p.dst_row_ptr[1:] - p.dst_row_ptr[:-1]).long())),
            (grad_h, grad_out, dst, torch.repeat_interleave(
                torch.arange(g.num_nodes, device="cuda"),
                (p.src_row_ptr[1:] - p.src_row_ptr[:-1]).long()))):
        for f0 in range(0, 64, 16):      # a float64 stream 16 wide at a time
            ref = torch.zeros((g.num_nodes, 16), dtype=torch.float64,
                              device="cuda").index_add_(
                0, seg, table[:, f0:f0 + 16].double()[ids])
            torch.testing.assert_close(got[:, f0:f0 + 16].double(), ref,
                                       rtol=1e-5, atol=1e-6)
    assert torch.equal(out, aggregate(g.x, g))


def test_gin_step_through_the_kernels_matches_plain(gen):
    """One gin-tu training step's loss and gradients through the kernels
    against ``impl="torch"`` on the card: the loss within rtol 1e-5, each
    gradient leaf within 1e-4 of its largest |value| (+1e-6); 9 + 9 graph
    kernel launches (forward 5 + 5, backward 4 + 4)."""
    from repro_torch import backend
    from repro_torch import tree as T
    from repro_torch.configs.gin_tu import full_config
    from repro_torch.launch.train import value_and_grad
    from repro_torch.models.gnn import gin
    cfg = full_config(d_in=100, n_classes=47)
    g = _rmat_batch(20_000, 400_000, cfg.d_in, cfg.n_classes, seed=4)
    params = gin.init_params(cfg, gen, device="cuda")
    backend.reset_launch_counts()
    lk, gk = value_and_grad(lambda p, b: gin.loss_fn(p, cfg, b))(params, g)
    assert backend.LAUNCHES["segment_sum"] == 9
    assert backend.LAUNCHES["block_gather"] == 9
    lt, gt = value_and_grad(lambda p, b: gin.loss_fn(p, cfg, b, "torch"))(
        params, g)
    assert backend.LAUNCHES["segment_sum"] == 9
    torch.testing.assert_close(lk, lt, rtol=1e-5, atol=0)
    for a, b in zip(T.leaves(gk), T.leaves(gt)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) \
            + 1e-6


# ---------------------------------------------------------------------------
# Equiformer-v2 and SASRec training on the graph kernels
# ---------------------------------------------------------------------------

def _molecule_batch(n_graphs, seed, d_in=64, atoms=30, pairs=32):
    """``n_graphs`` graphs of ``atoms`` atoms, each graph's ``pairs``
    closest atom pairs in both directions, positions N(0, 1.5^2)."""
    from repro_torch.models.gnn.common import GraphBatch
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pos = 1.5 * torch.randn((n_graphs, atoms, 3), generator=gen,
                            device="cuda")
    iu = torch.triu_indices(atoms, atoms, 1, device="cuda")
    d2 = ((pos[:, iu[0]] - pos[:, iu[1]]) ** 2).sum(-1)
    near = d2.topk(pairs, largest=False).indices
    base = (torch.arange(n_graphs, device="cuda") * atoms)[:, None]
    i, j = iu[0][near] + base, iu[1][near] + base
    n = n_graphs * atoms
    return GraphBatch(
        x=torch.randn((n, d_in), generator=gen, device="cuda"),
        edge_src=torch.cat([i, j], 1).reshape(-1).to(torch.int32),
        edge_dst=torch.cat([j, i], 1).reshape(-1).to(torch.int32),
        edge_valid=torch.ones(2 * pairs * n_graphs, dtype=torch.bool,
                              device="cuda"),
        node_valid=torch.ones(n, dtype=torch.bool, device="cuda"),
        graph_id=(torch.arange(n, device="cuda") // atoms).to(torch.int32),
        pos=pos.reshape(n, 3),
        labels=torch.randn((n_graphs,), generator=gen,
                           device="cuda")).with_plan()


def _routes_agree(loss_fn, params, batch, want):
    """One value and gradient through the kernels against ``impl="torch"``
    on the card: the loss within rtol 1e-5, each gradient leaf within 1e-4
    of its largest |value| (+1e-6), the launches exactly ``want``."""
    from repro_torch import backend
    from repro_torch import tree as T
    from repro_torch.launch.train import value_and_grad
    backend.reset_launch_counts()
    lk, gk = value_and_grad(loss_fn)(params, batch)
    assert {k: backend.LAUNCHES[k] for k in want} == want
    lt, gt = value_and_grad(lambda p, b: loss_fn(p, b, "torch"))(
        params, batch)
    torch.testing.assert_close(lk, lt, rtol=1e-5, atol=0)
    for a, b in zip(T.leaves(gk), T.leaves(gt)):
        assert bool(torch.isfinite(a).all())
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max()) \
            + 1e-6
    return gk


@pytest.mark.parametrize("truncate", [False, True])
def test_equiformer_step_through_the_kernels_matches_plain(gen, truncate):
    """Equiformer-v2 at full width (d 128, l_max 6, m_max 2, 8 heads), 2
    layers, 16 molecules: the kernel route against ``impl="torch"``;
    2 + 4L block_gather and 2L segment_sum launches."""
    import dataclasses
    from repro_torch.configs.equiformer_v2 import full_config
    from repro_torch.models.gnn import equiformer_v2 as EQ
    cfg = dataclasses.replace(full_config(d_in=64), n_layers=2,
                              truncate_rotation=truncate)
    g = _molecule_batch(16, seed=5)
    params = EQ.init_params(cfg, gen, device="cuda")
    _routes_agree(lambda p, b, impl="cuda": EQ.loss_fn(p, cfg, b, impl),
                  params, g, {"segment_sum": 4, "block_gather": 10})


def test_sasrec_step_through_the_kernels_matches_plain(gen):
    """SASRec at its full config (2^20-row table) on 2,048 users of
    ``sasrec_batches``: the kernel route against ``impl="torch"``, 1 + 2 +
    1 launches, the padding row's gradient 0."""
    from repro_torch.configs.sasrec import full_config
    from repro_torch.data.synthetic import sasrec_batches
    from repro_torch.models.recsys import sasrec as S
    cfg = full_config()
    params = S.init_params(cfg, gen, device="cuda")
    seq, pos, neg = next(sasrec_batches(cfg.n_items, 2048, cfg.seq_len,
                                        seed=6, device="cuda"))
    b = S.TrainBatch(seq, pos, neg,
                     S.lookup_plan(seq, pos, neg, cfg.n_items + 1))
    grads = _routes_agree(
        lambda p, b, impl="cuda": S.loss_fn(p, cfg, b.seq, b.pos, b.neg,
                                            impl=impl, plan=b.plan),
        params, b, {"embedding_bag": 1, "block_gather": 2,
                    "segment_sum": 1})
    assert not grads["item_emb"][0].any()


@pytest.mark.parametrize("F", [6272, 50])
def test_lane_sum_at_the_training_widths_matches_float64(gen, F):
    """``plan.lane_sum`` (a gather into id order and the CSR sum) at
    Equiformer-v2's K·C = 6272 over a molecule plan by source and by
    destination, and at SASRec's F = 50 over 10^6 lanes into 2^20 rows
    (most rows empty, a hot id among them): within rtol 1e-5 of a float64
    ``index_add_`` and bit-identical on a repeat."""
    from repro_torch.models.plan import edge_plan, lane_sum
    if F == 50:
        n = 1 << 20
        ids = torch.randint(0, n, (1_000_000,), generator=gen,
                            device="cuda", dtype=torch.int32)
        ids[::7] = 12_345
        ids[::11] = -1                                # a history pad
        plan = edge_plan(ids, ids >= 0, n)
        sides = [("dst", ids)]
    else:
        g = _molecule_batch(128, seed=7)
        plan, n = g.plan, g.num_nodes
        sides = [("dst", g.edge_dst), ("src", g.edge_src)]
    for side, ids in sides:
        grad = torch.randn((ids.numel(), F), generator=gen, device="cuda")
        got = lane_sum(plan, side, grad)
        keep = ids >= 0
        for f0 in range(0, F, 512):                   # float64 in slices
            ref = torch.zeros((n, min(512, F - f0)), dtype=torch.float64,
                              device="cuda").index_add_(
                0, ids[keep].long(), grad[keep, f0:f0 + 512].double())
            torch.testing.assert_close(got[:, f0:f0 + 512].double(), ref,
                                       rtol=1e-5, atol=1e-6)
        assert torch.equal(got, lane_sum(plan, side, grad))
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# LM training: the MoE dispatch and combine on the graph kernels
# ---------------------------------------------------------------------------

def test_lm_moe_step_through_the_kernels_matches_plain(gen):
    """qwen3-moe at its float32 smoke config, its capacity cut to 1.25 so
    lanes drop, 8 sequences of 64 ``token_stream`` tokens: the kernel route
    against ``impl="torch"``; 4 block_gather and 2 segment_sum launches a
    layer (dispatch, combine gather and sum; their backward)."""
    import dataclasses
    from repro_torch.configs.qwen3_moe_30b_a3b import smoke_config
    from repro_torch.data.synthetic import token_stream
    from repro_torch.models.transformer import model as M
    cfg = dataclasses.replace(smoke_config(), capacity_factor=1.25)
    params = M.init_params(cfg, 3, device="cuda")
    batch = next(token_stream(cfg.vocab, 8, 64, seed=4, device="cuda"))
    _routes_agree(
        lambda p, b, impl="cuda": M.loss_fn(p, cfg, b[0], b[1], impl),
        params, batch, {"block_gather": 4 * cfg.n_layers,
                        "segment_sum": 2 * cfg.n_layers})


def test_moe_kernel_route_matches_plain_at_full_width_bf16(gen):
    """One qwen3-moe MoE layer at full width in bf16 (d 2048, 128 experts
    top-8, d_ff 768) over 4,096 tokens (C = 321): y within one bf16 ulp
    (2^-7 relative) of the plain route's, both summing in float32 and
    rounding once; every gradient leaf's largest difference within 2^-7 of
    its largest |value|; the launches of one forward and backward."""
    from repro_torch import backend
    from repro_torch import tree as T
    from repro_torch.configs.qwen3_moe_30b_a3b import full_config
    from repro_torch.models.transformer import layers as L
    cfg = full_config()
    p = L.init_moe(gen, cfg, "cuda")
    x = torch.randn((1, 4096, cfg.d_model), generator=gen, device="cuda",
                    dtype=cfg.dtype)
    w = torch.randn(x.shape, generator=gen, device="cuda")
    assert L.capacity(cfg, 4096) == 321

    def run(impl):
        leaves = [t.detach().requires_grad_() for t in T.leaves(p)]
        xx = x.detach().requires_grad_()
        y, aux = L.apply_moe(T.unflatten(p, leaves), cfg, xx, impl)
        (y.float() * w).sum().add(aux).backward()
        return y.detach(), [t.grad for t in leaves] + [xx.grad]

    backend.reset_launch_counts()
    yk, gk = run("cuda")
    assert backend.LAUNCHES["block_gather"] == 4
    assert backend.LAUNCHES["segment_sum"] == 2
    yt, gt = run("torch")
    assert backend.LAUNCHES["block_gather"] == 4
    torch.testing.assert_close(yk.float(), yt.float(), rtol=2 ** -7,
                               atol=1e-6 * float(yt.abs().max()))
    for a, b in zip(gk, gt):
        assert a.dtype == b.dtype and bool(torch.isfinite(a).all())
        assert float((a.float() - b.float()).abs().max()) \
            <= 2 ** -7 * float(b.float().abs().max())


def test_flash_attention_refuses_autograd_on_the_card(gen):
    """The flash kernels have no backward: a CUDA q that asks for a
    gradient raises before a launch; under no_grad the kernel runs."""
    from repro_torch import backend
    from repro_torch.kernels.flash_attention.ops import flash_attention
    q, k, v = (torch.randn((1, 4, 256, 128), generator=gen, device="cuda",
                           dtype=torch.bfloat16) for _ in range(3))
    q.requires_grad_()
    before = backend.LAUNCHES["flash_attention_wgmma"]
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, scale=128 ** -0.5)
    assert backend.LAUNCHES["flash_attention_wgmma"] == before
    with torch.no_grad():
        flash_attention(q, k, v, scale=128 ** -0.5)
    assert backend.LAUNCHES["flash_attention_wgmma"] == before + 1


# ---- MoE decoding on the paged path ----------------------------------------

def _moe_serve_problem(gen, B=8):
    """qwen3-moe's smoke config in bf16, its capacity cut to 1.25 so decode
    drops lanes (at B = 8, 16 lanes a step for 8 experts of 3 slots),
    weights and prompts of 20-70 tokens made on the card."""
    import dataclasses
    from repro_torch.configs.qwen3_moe_30b_a3b import smoke_config
    from repro_torch.models.transformer import model as M
    cfg = dataclasses.replace(smoke_config(), dtype=torch.bfloat16,
                              capacity_factor=1.25)
    params = M.init_params(cfg, 11, device="cuda")
    lens = torch.randint(20, 70, (B,), generator=gen, device="cuda")
    prompts = torch.randint(0, cfg.vocab, (B, int(lens.max())),
                            generator=gen, device="cuda")
    return cfg, params, prompts, lens


def test_moe_decode_step_on_the_card_makes_no_host_sync(gen):
    """One eager MoE decode step on the kernel route under sync debug mode
    "error": no read of the device from the host; per layer one paged, two
    block_gather and one segment_sum launch; each layer's MoE block on the
    step's own input bit for bit ``impl="torch"``'s."""
    from repro_torch import backend
    from repro_torch.launch.serve import fill_paged, pages_per_seq
    from repro_torch.models.transformer import layers as L
    from repro_torch.models.transformer import model as M
    cfg, params, prompts, lens = _moe_serve_problem(gen)
    B, S = prompts.shape
    logits, dense = M.prefill(params, cfg, prompts)
    caches = fill_paged(cfg, dense, lens, pages_per_seq(S, 4, 16), 16)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    M.serve_step_paged(params, cfg, caches, tok)      # a pure step first
    torch.cuda.synchronize()
    backend.reset_launch_counts()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out, _ = M.serve_step_paged(params, cfg, caches, tok, inplace=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(out).all())
    assert {k: backend.LAUNCHES[k] for k in
            ("paged_attention", "block_gather", "segment_sum")} == {
        "paged_attention": cfg.n_layers, "block_gather": 2 * cfg.n_layers,
        "segment_sum": cfg.n_layers}
    # the MoE block alone on each layer's input: both routes bit for bit
    x = torch.randn((B, 1, cfg.d_model), generator=gen, device="cuda",
                    dtype=cfg.dtype)
    for lp in params["layers"]:
        yk, _ = L.apply_moe(lp["moe"], cfg, x, "cuda")
        yt, _ = L.apply_moe(lp["moe"], cfg, x, "torch")
        assert torch.equal(yk, yt)
    _, eidx, _ = L.route(params["layers"][0]["moe"], cfg, x.reshape(B, -1)
                         .float())
    plan = L.token_plan(eidx, L.capacity(cfg, B), cfg.n_experts)
    assert L.capacity(cfg, B) == 3 and plan.T == B


def test_moe_serve_graph_matches_the_eager_loop(gen):
    """``serve`` of the bf16 MoE config on the card: the decode steps
    replayed from one CUDA graph give the eager loop's greedy tokens, with
    the same launches counted on both routes (prefill: a flash, two
    block_gather and a segment_sum a layer; each decode step: a paged, two
    block_gather and a segment_sum a layer)."""
    from repro_torch import backend
    from repro_torch.launch.serve import serve
    cfg, params, prompts, lens = _moe_serve_problem(gen)
    steps, L_ = 12, cfg.n_layers
    want = {"flash_attention_wgmma": L_, "paged_attention": L_ * steps,
            "block_gather": 2 * L_ * (steps + 1),
            "segment_sum": L_ * (steps + 1)}
    res = []
    for graph in (True, False):
        backend.reset_launch_counts()
        res.append(serve(cfg, params, prompts, lens, steps, page=16,
                         device="cuda", graph=graph))
        assert {k: backend.LAUNCHES[k] for k in want} == want, graph
    assert [r.graph for r in res] == [True, False]
    assert torch.equal(res[0].tokens, res[1].tokens)
    for c_graph, c_eager in zip(res[0].caches, res[1].caches):
        for name in ("block_table", "lengths", "free_top"):
            assert torch.equal(getattr(c_graph, name), getattr(c_eager, name))


def _canonical_stream(gen, nv, V, hub=7, hub_lanes=100_000):
    """A lanes stream sorted by (dst, src) of distinct keys, destination
    ``hub`` holding about ``hub_lanes`` of them: (keys, src, w, row_ptr)."""
    keys = torch.randint(0, nv * nv, (V,), generator=gen, device="cuda")
    keys[:hub_lanes] = hub * nv + torch.randint(
        0, nv, (hub_lanes,), generator=gen, device="cuda")
    keys = torch.unique(keys)
    w = torch.rand(keys.numel(), generator=gen, device="cuda")
    row_ptr = torch.searchsorted(keys, torch.arange(nv + 1, device="cuda")
                                 * nv, out_int32=True)
    return keys, (keys % nv).to(torch.int32), w, row_ptr


def test_plan_patch_kernels_match_their_plain_versions(gen):
    """2^24 lanes, 10^5 records (deletes and re-inserts of live keys, fresh
    inserts and deletes of absent keys, some on the hub): both kernels bit
    for bit their plain versions on the host, and the patched stream the
    stream sorted afresh."""
    from repro_torch import backend
    from repro_torch.kernels.plan_patch import (locate_lanes,
                                                locate_lanes_ref, merge_lanes,
                                                merge_lanes_ref)
    nv = 1 << 20
    keys, src, w, row_ptr = _canonical_stream(gen, nv, 1 << 24)
    V = keys.numel()
    live = keys[torch.randint(0, V, (50_000,), generator=gen, device="cuda")]
    fresh = torch.randint(0, nv * nv, (49_000,), generator=gen,
                          device="cuda")
    on_hub = 7 * nv + torch.randint(0, nv, (1_000,), generator=gen,
                                    device="cuda")
    rkey = torch.unique(torch.cat([live, fresh, on_hub]))
    ins = torch.rand(rkey.numel(), generator=gen, device="cuda") < 0.5
    rdst, rsrc = (rkey // nv).to(torch.int32), (rkey % nv).to(torch.int32)
    rw = torch.rand(rkey.numel(), generator=gen, device="cuda")
    before = dict(backend.LAUNCHES)
    pos, found = locate_lanes(src, row_ptr, rdst, rsrc)
    ref = locate_lanes_ref(*(x.cpu() for x in (src, row_ptr, rdst, rsrc)))
    assert torch.equal(pos.cpu(), ref[0]) and torch.equal(found.cpu(), ref[1])
    zero = torch.zeros(1, dtype=torch.int32, device="cuda")
    cum_found = torch.cat([zero, torch.cumsum(found, 0, dtype=torch.int32)])
    cum_ins = torch.cat([zero, torch.cumsum(ins, 0, dtype=torch.int32)])
    lanes = V - int(cum_found[-1]) + int(cum_ins[-1])
    args = (src, w, pos, cum_found, cum_ins, rsrc, rw)
    new_src, new_w = merge_lanes(*args, lanes)
    want_src, want_w = merge_lanes_ref(*(x.cpu() for x in args), lanes)
    assert torch.equal(new_src.cpu(), want_src)
    assert torch.equal(new_w.cpu(), want_w)
    assert backend.LAUNCHES["plan_patch_locate"] == \
        before["plan_patch_locate"] + 1
    assert backend.LAUNCHES["plan_patch_merge"] == \
        before["plan_patch_merge"] + 1
    kept = torch.ones(V, dtype=torch.bool, device="cuda")
    kept[pos[found].long()] = False
    fresh_key, order = torch.sort(torch.cat([keys[kept], rkey[ins]]))
    assert torch.equal(new_src, (fresh_key % nv).to(torch.int32))
    assert torch.equal(new_w, torch.cat([w[kept], rw[ins]])[order])
    torch.cuda.synchronize()


def _to_host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    return x


def test_plan_build_on_the_card_equals_the_host_build(gen):
    """The lanes build on the card (its block copies in owner order through
    the row-gather kernel, counted apart from the sweeps' gathers) is bit
    for bit the build of the same store on the host, with the blocks laid
    out in another order."""
    from repro_torch import backend
    from repro_torch.core import engine as E
    cbl = _card_graph()
    st = cbl.store
    perm = torch.randperm(st.owner.numel(), generator=gen, device="cuda")
    cbl = cbl._replace(store=st._replace(
        keys=st.keys[perm], vals=st.vals[perm], count=st.count[perm],
        owner=st.owner[perm]))
    before = dict(backend.LAUNCHES)
    plan = E.sweep_plan(cbl, pull=False)
    assert backend.LAUNCHES["plan_block_gather"] == \
        before["plan_block_gather"] + 2
    assert backend.LAUNCHES["block_gather"] == before["block_gather"]
    host = E.sweep_plan(_to_host(cbl), pull=False)
    for name in ("src", "w", "row_ptr"):
        assert torch.equal(getattr(plan, name).cpu().view(torch.int32),
                           getattr(host, name).view(torch.int32)), name


def test_kept_plan_on_the_card_equals_a_fresh_build(gen):
    """A GraphService on the card keeps its PageRank plan across flushes:
    one build, then patches bit for bit the plan a build gives."""
    from repro_torch import backend
    from repro_torch.core import engine as E
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.stream.service import GraphService
    nv, ne = 3_000, 40_000
    src, dst = rmat_edges(nv, ne, seed=4, device="cuda")
    svc = GraphService.from_coo(src, dst, torch.rand(ne, device="cuda"),
                                num_vertices=nv, block_width=8,
                                log_capacity=4096)
    backend.reset_launch_counts()
    for r in range(4):
        n = 1_000
        live = torch.randint(0, ne, (n,), generator=gen, device="cuda")
        us = torch.cat([torch.randint(0, nv, (n,), generator=gen,
                                      device="cuda", dtype=torch.int32),
                        src[live]])
        ud = torch.cat([torch.randint(0, nv, (n,), generator=gen,
                                      device="cuda", dtype=torch.int32),
                        dst[live]])
        op = torch.cat([torch.ones(n, dtype=torch.int32, device="cuda"),
                        torch.full((n,), -1, dtype=torch.int32,
                                   device="cuda")])
        svc.apply(us, ud, torch.rand(2 * n, generator=gen, device="cuda"), op)
        svc.flush()
        svc.analytics("pagerank")
    assert (backend.PLAN_BUILDS, backend.PLAN_PATCHES) == (1, 3)
    assert backend.LAUNCHES["plan_patch_merge"] == 3
    held = svc._held
    fresh = E.sweep_plan(svc.snapshot.cbl, pull=False)
    for name in ("src", "w", "row_ptr"):
        assert torch.equal(getattr(held, name).view(torch.int32),
                           getattr(fresh, name).view(torch.int32)), name
    assert torch.equal(held.partition("lanes", 1),
                       fresh.partition("lanes", 1))
