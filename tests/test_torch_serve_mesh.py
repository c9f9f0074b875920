"""``ServeFrontend`` over a ``GraphService(n_shards=S)`` whose shards lie on
``shard_mesh(S)`` across 4 gloo ranks on the CPU, S in {2, 4, 8} (mesh axes
2, 4, 4: S = 2 leaves two ranks outside the mesh, S = 8 puts two shards on
each rank).

The ranks run ``tests/torch_serve_mesh_cases.py`` in one group, spawned
once for the module in a subprocess of their own (the group's timeout 60
s, the subprocess's 240 s, so a hang fails the tests), and write each
rank's tickets.  Every rank replays the two-tenant trace of
``tests/test_torch_tiered.py`` on a clock of its own, and only rank 0's
governs: every rank's tickets equal each other's and the one-process
frontend's over the one-device stack at the same S (the same cases with
no group, as rank 0 sees them) -- reads, degrees, update receipts,
versions, arrival and completion times and k-hop draws bit for bit
(every rank draws from a generator in the same state, seeded by ticket
ids and request seeds), PageRank within rtol 1e-5 (the cross-rank sum
takes another order).  Skewed clocks change nothing; a rank whose flush
is late holds every rank's publish; a retune adopts rank 0's plan.  Once,
at S = 2, the ranks are held to the JAX package's frontend over its
sharded service on one JAX device, k-hop by shape (another generator).
"""
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
import torch

import repro.serve as jserve
from repro.stream import GraphService as JService

import torch_serve_mesh_cases as C

REPO = Path(__file__).resolve().parent.parent
RTOL, ATOL = 1e-5, 1e-7
KEYS = [(S, case) for S in C.SHARD_COUNTS for case in C.CASES]

RANKS = r'''
import datetime
import pickle
import sys

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import torch_serve_mesh_cases as C


def run(rank, port, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=C.WORLD,
                            timeout=datetime.timedelta(seconds=60))
    res = C.run_all(rank)
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    # forked: the ranks start with everything above imported
    mp.start_processes(run, args=(int(sys.argv[1]), sys.argv[2]),
                       nprocs=C.WORLD, start_method="fork")
    print("MESH_OK")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def jax_replay():
    """The trace through ``repro.serve.ServeFrontend`` over JAX's
    ``GraphService(n_shards=2)`` on one JAX device, on a ManualClock."""
    svc = JService.from_coo(jnp.asarray(C.SRC), jnp.asarray(C.DST), None,
                            num_vertices=C.NV, num_blocks=96, block_width=4,
                            log_capacity=128, n_shards=2)
    clock = jserve.ManualClock()
    front = jserve.ServeFrontend(svc, C.serve_plan(jserve), clock=clock,
                                 fanout=(3, 2))
    front.register_tenant("fraud", read_your_writes=True)
    front.register_tenant("dashboard")
    tickets = []
    for dt, k, fields, tenant, cls in C.trace():
        clock.advance(dt)
        tickets.append(front.submit(getattr(jserve, C.KINDS[k])(
            tenant=tenant, latency_class=cls, **fields)))
        front.step()
    front.drain(flush=True)
    return [(t.request.kind, t.done, t.shed, t.version,
             C._value(t.value) if t.request.kind != "analytics"
             else np.asarray(t.value), t.t_arrival, t.t_done)
            for t in tickets], front.report()["service"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(per-rank results, one-process results, JAX's tickets and service
    report at S = 2); the references are computed while the ranks run."""
    d = tmp_path_factory.mktemp("serve_mesh")
    script = d / "ranks.py"
    script.write_text(RANKS)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO / "src"),
                                           str(REPO / "tests")]))
    proc = subprocess.Popen([sys.executable, str(script), str(_free_port()),
                             str(d)], env=env, cwd=REPO, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        ref = C.run_all()
        jax_ref = jax_replay()
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0 and "MESH_OK" in out, \
        out[-3000:] + err[-3000:]
    ranks = []
    for r in range(C.WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return ranks, ref, jax_ref


def _same_tickets(got, ref, what: str, pagerank_exact: bool = False,
                  khop_exact: bool = True) -> None:
    """Ticket by ticket: kind, completion, version, arrival and completion
    times, the values bit for bit but PageRank (within RTOL unless
    ``pagerank_exact``) and k-hop (by shape unless ``khop_exact``)."""
    assert len(got) == len(ref) == len(C.trace()), what
    for i, (g, r) in enumerate(zip(got, ref)):
        tag = f"{what}: ticket {i} ({r[0]})"
        assert g[:4] == r[:4], (tag, g[:4], r[:4])
        assert g[1] and not g[2], tag
        assert g[5:] == r[5:], (tag, g[5:], r[5:])
        gv, rv = g[4], r[4]
        if r[0] == "analytics":
            if pagerank_exact:
                np.testing.assert_array_equal(gv, rv, err_msg=tag)
            else:
                np.testing.assert_allclose(gv, rv, rtol=RTOL, atol=ATOL,
                                           err_msg=tag)
        elif r[0] == "update":
            assert gv == rv, (tag, gv, rv)
        elif r[0] == "khop" and not khop_exact:
            assert sorted(gv) == sorted(rv), tag
            for k in gv:
                assert np.shape(gv[k]) == np.shape(rv[k]), (tag, k)
        else:
            assert sorted(gv) == sorted(rv), tag
            for k in gv:
                np.testing.assert_array_equal(gv[k], np.asarray(rv[k]),
                                              err_msg=f"{tag}: {k}")


def _counted(report: dict) -> dict:
    """The report without the agreements' seconds (each rank times its
    own)."""
    agr = {k: v for k, v in report["agreement"].items() if k != "seconds"}
    return {**report, "agreement": agr}


def test_the_trace_is_the_tiered_tests():
    from test_torch_tiered import DST, NV, SRC, _trace
    assert C.NV == NV
    np.testing.assert_array_equal(C.SRC, SRC)
    np.testing.assert_array_equal(C.DST, DST)
    for (dt, k, f, tenant, cls), (dt2, k2, f2, tenant2, cls2) in zip(
            C.trace(), _trace()):
        assert (dt, k, tenant, cls) == (dt2, k2, tenant2, cls2)
        assert f.keys() == f2.keys()
        for key in f:
            np.testing.assert_array_equal(f[key], f2[key])


@pytest.mark.parametrize("S,case", KEYS)
def test_every_rank_serves_the_same_tickets(results, S, case):
    """Bit for bit, PageRank included (its sums are reduced across the
    mesh, so every rank holds the same bits)."""
    ranks, _, _ = results
    first = ranks[0][S, case]
    for r in range(1, C.WORLD):
        res = ranks[r][S, case]
        _same_tickets(res["tickets"], first["tickets"],
                      f"S={S} {case} rank {r}", pagerank_exact=True)
        assert res["publishes"] == first["publishes"]
        assert _counted(res["report"]) == _counted(first["report"])
        assert res["plans"] == first["plans"]
        assert res["final_plan"] == first["final_plan"]


@pytest.mark.parametrize("S,case", KEYS)
def test_the_mesh_matches_the_one_process_frontend(results, S, case):
    """Every rank against the one-process frontend over the one-device
    stack at the same S, on rank 0's clock: the same tickets, publish
    steps, service report, plans and step count."""
    ranks, ref, _ = results
    want = ref[S, case]
    for r in range(C.WORLD):
        got = ranks[r][S, case]
        _same_tickets(got["tickets"], want["tickets"],
                      f"S={S} {case} rank {r} vs one process")
        assert got["publishes"] == want["publishes"]
        assert got["report"]["service"] == want["report"]["service"]
        assert got["report"]["completed"] == want["report"]["completed"]
        assert got["plans"] == want["plans"]
        assert got["final_plan"] == want["final_plan"]
        assert got["report"]["agreement"]["steps"] \
            == want["report"]["agreement"]["steps"]


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_skewed_clocks_change_nothing(results, S):
    """Rank r's clock runs r * 0.7 ms ahead and 1 + r / 10 times as fast;
    the tickets, their times included, are the same-clock run's bit for
    bit."""
    ranks, _, _ = results
    for r in range(C.WORLD):
        same, skewed = ranks[r][S, "same"], ranks[r][S, "skewed"]
        _same_tickets(skewed["tickets"], same["tickets"],
                      f"S={S} rank {r} skewed vs same", pagerank_exact=True)
        assert skewed["publishes"] == same["publishes"]


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_a_late_flush_holds_every_ranks_publish(results, S):
    """One rank's shadow flush reports unready for its first 3 polls:
    every rank publishes at the steps the one-process frontend with the
    same hold publishes at, later than without it, and versions move with
    them."""
    ranks, ref, _ = results
    held, free = ref[S, "unready"], ref[S, "same"]
    assert held["publishes"] != free["publishes"]
    assert held["publishes"][0] == free["publishes"][0] + C.UNREADY_POLLS
    assert any(a[3] != b[3] for a, b in zip(held["tickets"],
                                            free["tickets"]))
    for r in range(C.WORLD):
        assert ranks[r][S, "unready"]["publishes"] == held["publishes"]


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_a_retune_adopts_rank_zeros_plan(results, S):
    """Each rank's bus is fed rates of its own on a host that shows a card
    a rank: after every retune each rank holds the plan rank 0's signals
    give, which another rank's own would not, the read plane keeps one
    replica and no replica retune is counted."""
    ranks, ref, _ = results
    first = ranks[0][S, "retune"]
    assert len(first["plans"]) >= 3
    assert first["plans"] == first["local_plans"] == ref[S, "retune"]["plans"]
    for r in range(C.WORLD):
        res = ranks[r][S, "retune"]
        assert res["plans"] == first["plans"]
        if r:
            assert all(a != b for a, b in zip(res["local_plans"],
                                              first["plans"]))
        assert res["plane"] == [1] * len(res["plans"])
        assert res["report"]["read_plane"]["n_replicas"] == 1
        assert res["report"]["read_plane"]["retunes"] >= len(res["plans"])
        assert res["replica_retunes"] == 0


@pytest.mark.parametrize("S", C.SHARD_COUNTS)
def test_one_agreement_a_step_and_a_submit(results, S):
    """On the mesh every step and every submit makes exactly one agreement
    collective (a retune adds its plan's broadcast); the one-process
    frontend makes none."""
    ranks, ref, _ = results
    for case in C.CASES:
        for r in range(C.WORLD):
            rep = ranks[r][S, case]["report"]
            agr = rep["agreement"]
            assert agr["mesh"] and agr["seconds"] > 0
            assert agr["per_step"] == 1.0 and agr["per_submit"] == 1.0
            assert agr["collectives"]["now"] == 0
            assert agr["collectives"]["retune"] \
                == rep["read_plane"]["retunes"]
        one = ref[S, case]["report"]["agreement"]
        assert not one["mesh"] and one["seconds"] == 0.0
        assert set(one["collectives"].values()) == {0}


def test_the_ranks_match_the_jax_frontend(results):
    """At S = 2 the ranks' tickets equal ``repro.serve.ServeFrontend``'s
    over JAX's sharded service on one device: reads, degrees, receipts,
    versions and times bit for bit, PageRank within RTOL, k-hop by shape
    (JAX draws from its own generator)."""
    ranks, ref, (jt, jservice) = results
    for r in range(C.WORLD):
        res = ranks[r][2, "same"]
        _same_tickets(res["tickets"], jt, f"rank {r} vs JAX",
                      khop_exact=False)
        assert res["report"]["service"] == jservice
    _same_tickets(ref[2, "same"]["tickets"], jt, "one process vs JAX",
                  khop_exact=False)


def test_without_a_group_nothing_changes(monkeypatch):
    """No process group: the frontend finds no mesh, makes no collective
    (every one of them raises here) and serves the one-device stack as
    the JAX package does (held in the test above)."""
    import torch.distributed as dist

    assert not dist.is_initialized()

    def refuse(*a, **k):
        raise AssertionError("a collective without a group")

    for name in ("all_reduce", "broadcast", "broadcast_object_list",
                 "all_gather_into_tensor", "reduce_scatter_tensor"):
        monkeypatch.setattr(dist, name, refuse)
    res = C.run(2, "same")
    assert res["report"]["agreement"]["mesh"] is False
    assert set(res["report"]["agreement"]["collectives"].values()) == {0}
    assert res["publishes"]


def test_the_read_plane_holds_the_ranks_device_on_a_mesh():
    """On a mesh the read plane holds the rank's own device whatever is
    asked; without one it spans the devices it is given."""
    from repro_torch.serve.replica import read_replica_devices
    cards = [torch.device("cuda", i) for i in range(4)]
    assert read_replica_devices(4, cards[1], devices=cards) == cards
    assert read_replica_devices(4, cards[1], devices=cards,
                                mesh=object()) == [cards[1]]
    assert read_replica_devices(4, cards[1], mesh=object()) == [cards[1]]
