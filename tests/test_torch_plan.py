"""Port parity of the sweep-plan route: the engine's sum sweeps through a
``SweepPlan`` (``impl="cuda"``; on the CPU the kernels' plain versions)
against the JAX engine (``impl="xla"`` and ``"pallas_interpret"``), the
merge-path partition, the plain CSR sum, the plan's store check and the one
plan a ``run_program`` builds.  Real-valued sums within rtol 1e-5
(summation order), integer-valued sums bit for bit."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import repro.core.cblist as jcb  # noqa: E402
import repro.core.engine as jeng  # noqa: E402
import repro.graph.algorithms as jalg  # noqa: E402
from repro.core import batch_update  # noqa: E402
from repro_torch import backend, interop  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core.updates import batch_update_stats  # noqa: E402
from repro_torch.graph import algorithms as talg  # noqa: E402
from repro_torch.kernels.segment_matmul import (  # noqa: E402
    merge_path_partition, segment_sum_csr, segment_sum_csr_ref,
    sorted_layout)
from repro_torch.kernels.segment_matmul.ops import csr_items_per_cta  # noqa: E402

from torch_parity import (BW, NB, NV, assert_close, assert_exact, graph,  # noqa: E402
                          t)

JIMPLS = ["xla", "pallas_interpret"]
MESSAGES = {"default": (None, None),
            "pagerank": (lambda xs, w: xs, lambda xs, w: xs)}


@pytest.fixture(scope="module", params=["built", "fragmented"])
def pair(request):
    """The same CBList in JAX and in the port, and the port's plan."""
    src, dst, w = graph()
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           num_vertices=NV, num_blocks=NB, block_width=BW)
    if request.param == "fragmented":
        rng = np.random.default_rng(1)
        for _ in range(3):
            us = rng.integers(0, NV, 64).astype(np.int32)
            ud = rng.integers(0, NV, 64).astype(np.int32)
            j = batch_update(j, jnp.asarray(us), jnp.asarray(ud),
                             jnp.asarray(rng.random(64).astype(np.float32)))
    p = interop.cbl_from_arrays(j, device="cpu")
    return j, p, teng.sweep_plan(p)


def _x(seed, shape=(NV,)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _active(seed):
    return np.random.default_rng(seed).random(NV) < 0.4


def _kw(fn):
    return {} if fn is None else {"dense_f": fn}


@pytest.mark.parametrize("jimpl", JIMPLS)
@pytest.mark.parametrize("message", sorted(MESSAGES))
@pytest.mark.parametrize("with_active", [False, True])
def test_planned_push_matches_jax(pair, jimpl, message, with_active):
    j, p, plan = pair
    x = _x(0)
    act = _active(1) if with_active else None
    tf, jf = MESSAGES[message]
    before = dict(backend.LAUNCHES)
    got = teng.process_edge_push(p, t(x), None if act is None else t(act),
                                 impl="cuda", plan=plan, **_kw(tf))
    assert backend.LAUNCHES == before                   # CPU: no launch
    assert_close(got, jeng.process_edge_push(
        j, jnp.asarray(x), None if act is None else jnp.asarray(act),
        impl=jimpl, **_kw(jf)))


@pytest.mark.parametrize("jimpl", JIMPLS)
@pytest.mark.parametrize("with_active", [False, True])
def test_planned_pull_matches_jax(pair, jimpl, with_active):
    j, p, plan = pair
    x = _x(2)
    act = _active(3) if with_active else None
    assert_close(
        teng.process_edge_pull(p, t(x), None if act is None else t(act),
                               impl="cuda", plan=plan),
        jeng.process_edge_pull(j, jnp.asarray(x),
                               None if act is None else jnp.asarray(act),
                               impl=jimpl))


@pytest.mark.parametrize("jimpl", JIMPLS)
@pytest.mark.parametrize("with_active", [False, True])
def test_planned_push_feat_matches_jax(pair, jimpl, with_active):
    j, p, plan = pair
    x = _x(4, (NV, 4))
    act = _active(5) if with_active else None
    for weighted in (True, False):
        assert_close(
            teng.process_edge_push_feat(p, t(x),
                                        None if act is None else t(act),
                                        weighted=weighted, impl="cuda",
                                        plan=plan),
            jeng.process_edge_push_feat(
                j, jnp.asarray(x), None if act is None else jnp.asarray(act),
                weighted=weighted, impl=jimpl))


def test_planned_integer_valued_sums_are_bit_exact(pair):
    """In-degree counts through push and pull, and integer features through
    push_feat: the plan route equals the JAX oracle bit for bit."""
    j, p, plan = pair
    ones = np.ones(NV, np.float32)
    msg = lambda xs, w: xs          # noqa: E731 — integer-valued sums
    assert_exact(teng.process_edge_push(p, t(ones), dense_f=msg, impl="cuda",
                                        plan=plan),
                 jeng.process_edge_push(j, jnp.asarray(ones), dense_f=msg,
                                        impl="xla"))
    assert_exact(teng.process_edge_pull(p, t(ones), dense_f=msg, impl="cuda",
                                        plan=plan),
                 jeng.process_edge_pull(j, jnp.asarray(ones), dense_f=msg,
                                        impl="xla"))
    xi = np.random.default_rng(6).integers(0, 4, (NV, 3)).astype(np.float32)
    assert_exact(teng.process_edge_push_feat(p, t(xi), weighted=False,
                                             impl="cuda", plan=plan),
                 jeng.process_edge_push_feat(j, jnp.asarray(xi),
                                             weighted=False, impl="xla"))


def test_plan_lays_out_every_live_lane_in_destination_order(pair):
    _, p, plan = pair
    st = p.store
    mask = (torch.arange(BW)[None, :] < st.count[:, None]) \
        & (st.owner >= 0)[:, None]
    assert plan.src.dtype == plan.row_ptr.dtype == torch.int32
    assert plan.src.numel() == int(mask.sum()) == int(plan.row_ptr[-1])
    dst = torch.repeat_interleave(torch.arange(NV), plan.row_ptr.diff())
    pairs = sorted(zip(st.owner[:, None].expand_as(st.keys)[mask].tolist(),
                       st.keys[mask].tolist(), st.vals[mask].tolist()))
    assert sorted(zip(plan.src.tolist(), dst.tolist(),
                      plan.w.tolist())) == pairs
    owned = st.owner[plan.blocks.long()]
    assert bool((owned.diff() >= 0).all())
    assert plan.blocks.numel() == int((st.owner >= 0).sum())


def test_plan_refuses_the_store_after_an_update(pair):
    _, p, plan = pair
    x = t(_x(7))
    rng = np.random.default_rng(8)
    us, ud = (t(rng.integers(0, NV, 16).astype(np.int32)) for _ in range(2))
    after, _ = batch_update_stats(p, us, ud)
    for sweep in (teng.process_edge_push, teng.process_edge_pull):
        with pytest.raises(ValueError, match="another CBList store"):
            sweep(after, x, impl="cuda", plan=plan)
    with pytest.raises(ValueError, match="another CBList store"):
        teng.process_edge_push_feat(after, x[:, None], impl="cuda",
                                    plan=plan)
    # the plan still serves its own store, and the plain route ignores it
    teng.process_edge_push(p, x, impl="cuda", plan=plan)
    assert_close(teng.process_edge_push(after, x, impl="torch", plan=plan),
                 teng.process_edge_push(after, x, impl="torch"))


def test_plan_without_a_stream_refuses_its_sweep(pair):
    _, p, _ = pair
    x = t(_x(9))
    push_only = teng.sweep_plan(p, pull=False)
    with pytest.raises(ValueError, match="no blocks stream"):
        teng.process_edge_pull(p, x, impl="cuda", plan=push_only)
    pull_only = teng.sweep_plan(p, push=False)
    with pytest.raises(ValueError, match="no lanes stream"):
        teng.process_edge_push(p, x, impl="cuda", plan=pull_only)


def test_min_max_sweeps_ignore_the_plan(pair):
    j, p, plan = pair
    x = _x(10)
    for combine in ("min", "max"):
        assert_exact(teng.process_edge_push(p, t(x), combine=combine,
                                            impl="cuda", plan=plan),
                     jeng.process_edge_push(j, jnp.asarray(x),
                                            combine=combine, impl="xla"))


# ---------------------------------------------------------------------------
# merge-path partition and the plain CSR sum
# ---------------------------------------------------------------------------

def _row_ptr(lengths):
    return torch.tensor(np.concatenate([[0], np.cumsum(lengths)]),
                        dtype=torch.int32)


def _merge_walk(row_ptr):
    """(row, item) at every diagonal of the merged sequence, walked one
    step at a time: a row's end follows its last item."""
    rp = row_ptr.tolist()
    R, V = len(rp) - 1, rp[-1]
    row = item = 0
    path = [(0, 0)]
    while row < R or item < V:
        if row < R and item >= rp[row + 1]:
            row += 1
        else:
            item += 1
        path.append((row, item))
    return path


LENGTHS = {
    "hub": [3, 0, 1, 5000, 2, 0, 7],
    "empty_runs": [0] * 300 + [4] + [0] * 500 + [9, 9] + [0] * 40,
    "no_items": [0] * 123,
    "no_rows": [],
    "random": list(np.random.default_rng(11).integers(0, 12, 400)),
}


@pytest.mark.parametrize("name", sorted(LENGTHS))
@pytest.mark.parametrize("per_cta", [1, 7, 64, 2048])
def test_merge_path_covers_every_row_and_item_once(name, per_cta):
    row_ptr = _row_ptr(LENGTHS[name])
    parts = merge_path_partition(row_ptr, per_cta)
    path = _merge_walk(row_ptr)
    total = len(path) - 1
    assert parts.dtype == torch.int32 and parts.shape[1] == 2
    assert parts.shape[0] == -(-total // per_cta) + 1
    want = [path[min(c * per_cta, total)] for c in range(parts.shape[0])]
    assert [tuple(r) for r in parts.tolist()] == want
    # consecutive CTAs tile rows and items with no gap and no overlap
    steps = parts.diff(dim=0).sum(1)
    assert bool((parts.diff(dim=0) >= 0).all())
    assert bool((steps[:-1] == per_cta).all()) if steps.numel() > 1 else True
    assert tuple(parts[-1].tolist()) == (len(LENGTHS[name]),
                                         int(row_ptr[-1]))


def test_merge_path_splits_a_hub_row_across_ctas():
    row_ptr = _row_ptr(LENGTHS["hub"])
    parts = merge_path_partition(row_ptr, 64)
    hub_ctas = int((parts[:, 0] == 3).sum())
    assert hub_ctas >= 5000 // 64            # one row, many equal shares


@pytest.mark.parametrize("F", [1, 3])
def test_segment_sum_csr_ref_matches_a_float64_sum(F):
    rng = np.random.default_rng(12 + F)
    lengths = rng.integers(0, 30, 500)
    lengths[::7] = 0
    lengths[3] = 4000
    row_ptr = _row_ptr(lengths)
    data = rng.standard_normal((int(row_ptr[-1]), F)).astype(np.float32)
    rp = row_ptr.numpy()
    want = np.stack([data[rp[r]:rp[r + 1]].astype(np.float64).sum(0)
                     for r in range(len(lengths))])
    got = segment_sum_csr_ref(t(data), row_ptr)
    assert got.shape == (len(lengths), F) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    parts = merge_path_partition(row_ptr, csr_items_per_cta(F))
    assert torch.equal(segment_sum_csr(t(data), row_ptr, parts), got)


def test_segment_sum_csr_checks_its_inputs():
    row_ptr = _row_ptr([2, 0, 3])
    data = torch.ones(5, 1)
    parts = merge_path_partition(row_ptr, csr_items_per_cta(1))
    assert segment_sum_csr(data, row_ptr, parts)[:, 0].tolist() == [2, 0, 3]
    with pytest.raises(TypeError):
        segment_sum_csr(data.double(), row_ptr, parts)
    with pytest.raises(TypeError):
        segment_sum_csr(data, row_ptr.long(), parts)
    with pytest.raises(ValueError):
        segment_sum_csr(torch.ones(5), row_ptr, parts)
    long_ptr = _row_ptr([400, 0, 600])
    with pytest.raises(ValueError):          # F = 1's partition at F = 16
        segment_sum_csr(torch.ones(1000, 16), long_ptr,
                        merge_path_partition(long_ptr, csr_items_per_cta(1)))
    with pytest.raises(ValueError):          # not contiguous
        segment_sum_csr(torch.ones(2, 5).T, row_ptr, parts)


def test_sorted_layout_is_int32():
    seg = torch.tensor([3, -1, 0, 3, 9, 1, 0], dtype=torch.int32)
    order, row_ptr = sorted_layout(seg, 4)
    assert order.dtype == row_ptr.dtype == torch.int32


def test_csr_items_per_cta_follows_the_kernel_tiles():
    assert [csr_items_per_cta(F) for F in (1, 2, 3, 4, 16, 17, 32, 50)] \
        == [6144, 3072, 1536, 1536, 384, 192, 192, 192]


# ---------------------------------------------------------------------------
# run_program builds one plan
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built():
    src, dst, w = graph()
    j = jcb.build_from_coo(jnp.asarray(src), jnp.asarray(dst), jnp.asarray(w),
                           num_vertices=NV, num_blocks=NB, block_width=BW)
    return j, interop.cbl_from_arrays(j, device="cpu")


def test_run_program_builds_one_plan_for_pagerank(built):
    j, p = built
    backend.reset_launch_counts()
    got, iters = talg.pagerank(p, impl="cuda", max_iters=60,
                               return_stats=True)
    assert backend.PLAN_BUILDS == 1 and iters > 1
    assert_close(got, jalg.pagerank(j, max_iters=60))
    assert_close(got, talg.pagerank(p, impl="torch", max_iters=60))
    assert backend.PLAN_BUILDS == 1          # the plain route builds none


@pytest.mark.parametrize("name,kw,plans", [
    ("bfs", {"source": 0}, 0), ("sssp", {"source": 0}, 0),
    ("connected_components", {}, 0),
    ("triangle_count", {}, 1)])
def test_plan_builds_follow_the_sum_sweeps(built, name, kw, plans):
    _, p = built
    backend.reset_launch_counts()
    talg.__dict__[name](p, impl="cuda", **kw)
    assert backend.PLAN_BUILDS == plans
