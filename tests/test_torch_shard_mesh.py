"""The shard axis across ranks: ``repro_torch.distributed.graph`` on a
``("shard",)`` mesh over 4 gloo ranks on the CPU, S in {1, 2, 4, 8} (mesh
axes 1, 2, 4, 4: S = 1 and 2 leave ranks outside the mesh, S = 8 puts two
shards on each rank).

The ranks run ``tests/torch_shard_cases.py`` in one group, spawned once for
the module in a subprocess of their own (the group's timeout 60 s, the
subprocess's 240 s, so a hang fails the tests), and write each rank's
results.  They are held against each other (every rank the same answer)
and against the port's one-device stack (the same cases with no process
group: every result, the write path, maintenance, the spill batch, the
delete scopes and both services included), bit for bit, except the sums of
real values (push / pull / push_feat, PageRank) within rtol 1e-5, the
summation order differing.  ``tests/test_torch_sharded.py`` holds that
stack to the JAX package's at S = 2, 3, 4.  Here the JAX package, computed
in the test process, holds what depends on S at every S (the stack, its
global view, the placement statistics and the sweeps, through
``repro.distributed.graph`` on one JAX device) and what does not once, on
the unsharded graph (the programs, a batch's stats, the reads after it):
JAX's sharded writes and services compile anew for every S, some 100 s a
shard count on the CPU.  The sum sweeps run under each ``REDUCE_MODE``,
and the count of ``reduce_scatter_tensor`` calls shows which collective
each took."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import os
import pickle
import socket
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

import repro.core as jcore
import repro.core.engine as jeng
import repro.distributed.graph as jdist
import repro.graph.algorithms as jalg

import torch_shard_cases as C
from repro_torch.core.blockstore import BlockStore
from repro_torch.core.cblist import CBList

REPO = Path(__file__).resolve().parent.parent
WORLD = 4
RTOL, ATOL = 1e-5, 1e-7

RANKS = r'''
import datetime
import pickle
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_shard_cases as C

WORLD = 4


def run(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=60))
    res = {S: C.run(S) for S in C.SHARD_COUNTS}
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    # forked: the ranks start with everything above imported
    mp.start_processes(run, args=(int(sys.argv[1]), sys.argv[2]),
                       nprocs=WORLD, start_method="fork")
    print("MESH_OK")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _np(tree) -> dict:
    """A JAX CBList as nested dicts of arrays, as ``cbl_to_numpy`` gives
    the port's."""
    out = {f: np.asarray(getattr(tree, f)) for f in CBList._fields
           if f != "store"}
    out["store"] = {f: np.asarray(getattr(tree.store, f))
                    for f in BlockStore._fields}
    return out


def _jstack(out, name, g):
    if isinstance(g, jdist.ShardedCBList):
        C._put(out, name, {"shards": _np(g.shards),
                           "v_shard": np.asarray(g.v_shard)})
    else:
        C._put(out, name, _np(g))


def _jcbl(src, dst, w, nv=C.NV, nb=C.NB, bw=C.BW):
    return jcore.build_from_coo(jnp.asarray(src), jnp.asarray(dst),
                                None if w is None else jnp.asarray(w),
                                num_vertices=nv, num_blocks=nb,
                                block_width=bw)


def jax_layout(S: int) -> dict:
    """What depends on S, through ``repro.distributed.graph`` at S shards
    on one JAX device: the stack, its global view and placement
    statistics, and the sweeps (the sums under each mode's name)."""
    out = {}
    inp, si = C.graph_inputs(), C.sweep_inputs()
    js, _ = jdist.shard_cbl(_jcbl(inp["src"], inp["dst"], inp["w"]), S)
    _jstack(out, "stack", js)
    for k in ("n_vertices", "v_deg", "v_level", "num_edges"):
        out[f"view.{k}"] = np.asarray(getattr(js, k))
    for k in range(S):
        C._put(out, f"shard_at.{k}", _np(jdist.shard_at(js, k)))
    out["cut_fraction"] = np.asarray(jdist.cut_fraction(js))
    out["contiguity"] = np.asarray(jdist.shard_contiguity(js))
    out["halo"] = np.asarray(jdist.halo_masks(js))
    x, xf, act = (jnp.asarray(si[k]) for k in ("x", "xf", "act"))
    for combine in ("min", "max"):
        out[f"push_{combine}"] = np.asarray(
            jeng.process_edge_push(js, x, combine=combine))
        out[f"pull_{combine}"] = np.asarray(
            jeng.process_edge_pull(js, x, combine=combine))
    out["in_degrees"] = np.asarray(jeng.in_degrees(js))
    sums = {"push": jeng.process_edge_push(js, x),
            "push_active": jeng.process_edge_push(js, x, act),
            "pull": jeng.process_edge_pull(js, x, act),
            "push_feat": jeng.process_edge_push_feat(js, xf)}
    for mode in C.MODES:
        for k, v in sums.items():
            out[f"{mode}.{k}"] = np.asarray(v)
    return out


def jax_unsharded() -> dict:
    """What the shard count leaves unchanged (tests/test_sharded_multidevice
    .py holds the JAX package's mesh to it), through the JAX package on the
    unsharded graph once: the programs, a batch's stats and the reads
    after it."""
    out = {}
    inp, si = C.graph_inputs(), C.sweep_inputs()
    j = _jcbl(inp["src"], inp["dst"], inp["w"])
    pr = np.asarray(jalg.pagerank(j, max_iters=10))
    for mode in C.MODES:
        out[f"{mode}.pagerank"] = out[f"{mode}.pagerank_cuda"] = pr
    out["bfs"] = np.asarray(jalg.bfs(j, jnp.int32(0)))
    out["sssp"] = np.asarray(jalg.sssp(j, jnp.int32(1)))
    out["cc"] = np.asarray(jalg.connected_components(j))
    out["lp"] = np.asarray(jalg.label_propagation(
        j, si["seeds"], si["seed_mask"], num_classes=4))
    out["triangles"] = np.asarray(jalg.triangle_count(j))
    us, ud, uw, op = (jnp.asarray(inp[k]) for k in ("us", "ud", "uw", "op"))
    b, st = jcore.batch_update_stats(j, us, ud, uw, op)
    out["update.stats"] = np.array([int(v) for v in st], np.int32)
    f, wq = jcore.read_edges(b, jnp.asarray(inp["qs"]), jnp.asarray(inp["qd"]))
    out["read.found"], out["read.w"] = np.asarray(f), np.asarray(wq)
    return out


def _is_sum(key: str) -> bool:
    return key.rsplit(".", 1)[-1] in C.SUMS or key in ("contiguity",
                                                      "grown.push")


def _compare(got: dict, ref: dict, keys, what: str,
             dtypes: bool = True) -> None:
    for k in keys:
        g, r = got[k], ref[k]
        if _is_sum(k):
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{what}: {k}")
            continue
        if dtypes:
            assert g.dtype == r.dtype, (what, k, g.dtype, r.dtype)
        np.testing.assert_array_equal(g, r, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(per-rank results, one-device stack results, JAX results), each
    ``{S: {name: ndarray}}``.  The references are computed while the ranks
    run."""
    d = tmp_path_factory.mktemp("shard_mesh")
    script = d / "ranks.py"
    script.write_text(RANKS)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    proc = subprocess.Popen([sys.executable, str(script), str(_free_port()),
                             str(d)], env=env, cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        stack = {S: C.run(S) for S in C.SHARD_COUNTS}
        flat = jax_unsharded()
        ref = {S: {**flat, **jax_layout(S)} for S in C.SHARD_COUNTS}
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "MESH_OK" in out, \
        out[-3000:] + err[-3000:]
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, stack, ref


def _replicated(res: dict):
    return [k for k in res if not k.startswith("local.")]


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_every_rank_gets_the_same_answer(results, S):
    ranks, _, _ = results
    keys = _replicated(ranks[0][S])
    for r in range(1, WORLD):
        assert sorted(_replicated(ranks[r][S])) == sorted(keys)
        for k in keys:
            np.testing.assert_array_equal(ranks[r][S][k], ranks[0][S][k],
                                          err_msg=f"rank {r}: {k}")


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_each_rank_holds_its_block_of_the_stack(results, S):
    """Rank r on the mesh holds shards [r S/nd, (r+1) S/nd) of the one-device
    stack, bit for bit; a rank outside it one empty shard."""
    ranks, stack, _ = results
    nd = {1: 1, 2: 2, 4: 4, 8: 4}[S]
    for r, res in enumerate(ranks):
        res = res[S]
        assert int(res["mesh_size"]) == nd
        want = list(range(r * S // nd, (r + 1) * S // nd)) if r < nd else []
        assert res["local.ids"].tolist() == want
        assert int(res["local.n_views"]) == max(len(want), 1)
        for k, v in res.items():
            if not k.startswith("local.stack."):
                continue
            if want:
                whole = stack[S]["stack.shards." + k[len("local.stack."):]]
                np.testing.assert_array_equal(v, whole[want[0]:want[-1] + 1],
                                              err_msg=f"rank {r}: {k}")
            elif k.endswith(".v_deg"):
                assert v.shape[0] == 1 and not v.any()


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_the_mesh_matches_the_one_device_stack(results, S):
    ranks, stack, _ = results
    got, ref = ranks[0][S], stack[S]
    assert int(ref["mesh_size"]) == 0
    keys = [k for k in _replicated(got) if k != "mesh_size"]
    assert sorted(keys) == sorted(k for k in _replicated(ref)
                                  if k != "mesh_size")
    _compare(got, ref, keys, f"S={S} mesh vs stack")


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_the_mesh_matches_the_jax_package(results, S):
    ranks, _, ref = results
    got, ref = ranks[0][S], ref[S]
    keys = [k for k in ref if k in got]
    missing = [k for k in ref if k not in got]
    assert not missing, missing
    _compare(got, ref, keys, f"S={S} mesh vs JAX", dtypes=False)
    for r in range(1, WORLD):
        _compare(ranks[r][S], ref, keys, f"S={S} rank {r} vs JAX",
                 dtypes=False)


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_reduce_modes_take_their_collective(results, S):
    """"auto" and "reduce_scatter" reduce a sum by reduce_scatter +
    all_gather where the vertex capacity (48) tiles the mesh axis,
    "all_reduce" never; the grown capacity (50) does not tile an axis of
    4, so "auto" falls back to all_reduce there.  The three modes agree
    within rtol and each one's PageRank runs the same iterations."""
    ranks, _, _ = results
    nd = {1: 1, 2: 2, 4: 4, 8: 4}[S]
    for r, res in enumerate(ranks):
        res = res[S]
        on = r < nd and nd > 1
        calls = {k: int(res[f"local.reduce_scatters.{k}"])
                 for k in C.MODES + ("grown",)}
        assert (calls["auto"] > 0) == on and calls["all_reduce"] == 0
        assert (calls["reduce_scatter"] > 0) == on
        assert (calls["grown"] > 0) == (on and nd == 2)
        for mode in C.MODES[1:]:
            for k in ("push", "push_active", "pull", "push_feat",
                      "pagerank", "pagerank_cuda"):
                np.testing.assert_allclose(res[f"{mode}.{k}"],
                                           res[f"auto.{k}"], rtol=RTOL,
                                           atol=ATOL)
            assert int(res[f"{mode}.pagerank_iters"]) \
                == int(res["auto.pagerank_iters"])


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_spill_batch_and_delete_scopes(results, S):
    """The skewed spill batch drops the JAX package's (61, 35, 0)
    (tests/test_torch_sharded.py) at every S, spilling into further rounds
    from S = 4 on (below, one shard's lane cap takes the whole batch);
    each delete takes its scope (all only where a remote in-edge
    exists)."""
    ranks, _, _ = results
    for res in ranks:
        res = res[S]
        assert res["spill.stats"].tolist() == [61, 35, 0]
        assert (int(res["spill.rounds"]) >= 1) == (S >= 4)
        for scope in ("none", "owners") + (("all",) if S > 1 else ()):
            assert res[f"delete.{scope}.scope"].tolist() == \
                [f"delete.insweep{{scope={scope}}}"]


def test_without_a_group_nothing_changes():
    """No process group: ``shard_mesh`` is None, ``shard_cbl`` stacks every
    shard on the one device and the service keeps it so."""
    import torch.distributed as dist

    import repro_torch.distributed.graph as tdist
    from repro_torch.stream import GraphService
    assert not dist.is_initialized()
    assert tdist.shard_mesh(4) is None
    inp = C.graph_inputs()
    sc, _ = tdist.shard_cbl(C._cbl(inp["src"], inp["dst"], inp["w"]), 4)
    assert sc.mesh is None and sc.n_shards == 4 and len(sc.views) == 4
    assert sc.shard_ids == range(4)
    svc = GraphService.from_coo(inp["src"], inp["dst"], inp["w"],
                                num_vertices=C.NV, n_shards=4, device="cpu")
    assert svc.snapshot.cbl.mesh is None and svc.snapshot.cbl.n_shards == 4
