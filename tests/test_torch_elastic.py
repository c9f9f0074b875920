"""The port's elastic restart (``repro_torch.runtime.elastic``) against
``repro.runtime.elastic``: ``plan_elastic_restart`` equal to JAX's over a
grid of device counts, batches and model-parallel widths, the ValueError
cases included; tests/test_checkpoint_runtime.py's plan check on the port;
and, mirroring tests/test_sharding_dryrun.py's elastic test on a real
process group (the fake group's collectives do nothing, so values after
one prove nothing there): 4 gloo ranks on the CPU write a state sharded on
a (2, 2) mesh with the port's ``checkpoint.save``, restore it and
``reshard_state`` it onto the (1, 2) mesh of a 2-device plan, and each
leaf's ``full_tensor()`` equals the state bit for bit -- from the restored
tensors and straight from the live DTensors.  The ranks run in a
subprocess of their own with a 30 s timeout."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

from repro.runtime import elastic as J
from repro_torch.runtime import ElasticPlan, plan_elastic_restart

REPO = Path(__file__).resolve().parent.parent
BATCHES = (1, 3, 8, 12, 100, 256, 1000, 4096)
MODEL_PARALLEL = (1, 2, 8, 16)


def _plan(fn, *args):
    try:
        return fn(*args)
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("n_devices", [1, 2, 8, 16, 100, 256, 512])
def test_plan_matches_jax(n_devices):
    for batch in BATCHES:
        for mp in MODEL_PARALLEL:
            got = _plan(plan_elastic_restart, n_devices, batch, mp)
            ref = _plan(J.plan_elastic_restart, n_devices, batch, mp)
            if isinstance(ref, tuple):
                assert got == ref, (n_devices, batch, mp)
            else:
                assert isinstance(got, ElasticPlan)
                assert (got.mesh_shape, got.axis_names, got.per_host_batch) \
                    == (ref.mesh_shape, ref.axis_names, ref.per_host_batch), \
                    (n_devices, batch, mp)


def test_elastic_plan():
    p = plan_elastic_restart(512, 256, model_parallel=16)
    assert p.mesh_shape == (32, 16) and p.per_host_batch == 8
    p = plan_elastic_restart(256, 256, model_parallel=16)
    assert p.mesh_shape == (16, 16) and p.per_host_batch == 16
    with pytest.raises(ValueError):
        plan_elastic_restart(100, 256, model_parallel=16)


GLOO_RESHARD = r'''
import sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.distributed.tensor import distribute_tensor  # noqa: F401

from repro_torch import tree as T
from repro_torch.checkpoint import restore, save
from repro_torch.distributed.sharding import NamedSharding, P
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.runtime import (make_mesh_from_plan, plan_elastic_restart,
                                 reshard_state)

WORLD = 4


def run(rank, port, ckpt):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    gen = torch.Generator().manual_seed(0)
    state = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
             "emb": torch.randn(6, 10, generator=gen).to(torch.bfloat16),
             "m": {"b": torch.randn(5, generator=gen)},
             "step": torch.tensor(7, dtype=torch.int32)}

    def shardings(mesh):
        return {"w": NamedSharding(mesh, P("data", "model")),
                "emb": NamedSharding(mesh, P(None, "model")),
                "m": {"b": NamedSharding(mesh, P(("data", "model")))},
                "step": NamedSharding(mesh, P())}

    mesh1 = make_debug_mesh((2, 2), device_type="cpu")
    sharded = reshard_state(state, shardings(mesh1))
    assert tuple(sharded["w"].to_local().shape) == (4, 4)
    if rank == 0:                             # uneven: rank 0 has the most
        assert tuple(sharded["m"]["b"].to_local().shape) == (2,)
    save(ckpt, 1, sharded)                    # every rank; rank 0 writes
    dist.barrier()
    back = restore(ckpt, state, device="cpu")
    plan = plan_elastic_restart(2, 8, model_parallel=2)
    assert plan.mesh_shape == (1, 2) and plan.per_host_batch == 8
    mesh2 = make_mesh_from_plan(plan, device_type="cpu")
    sh2 = shardings(mesh2)
    for src in (back, sharded):               # restored; live DTensors
        moved = reshard_state(src, sh2)
        if mesh2.get_coordinate() is None:    # ranks 2, 3: not on the mesh
            continue
        for x, ref in zip(T.leaves(moved), T.leaves(state)):
            assert x.device_mesh == mesh2
            whole = x.full_tensor()
            assert whole.dtype == ref.dtype and torch.equal(whole, ref)
        assert tuple(moved["w"].to_local().shape) == (8, 4)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    # forked: the ranks start with everything above imported
    mp.start_processes(run, args=(int(sys.argv[1]), sys.argv[2]),
                       nprocs=WORLD, start_method="fork")
    print("RESHARD_OK")
'''


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_reshard_state_keeps_values_on_a_gloo_group(tmp_path):
    script = tmp_path / "reshard.py"
    script.write_text(GLOO_RESHARD)
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, str(script), str(_free_port()),
                          str(tmp_path / "ckpt")], env=env,
                         capture_output=True, text=True, timeout=30, cwd=REPO)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "RESHARD_OK" in res.stdout
