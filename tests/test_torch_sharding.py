"""The port's production meshes and sharding rules
(``repro_torch.launch.mesh``, ``repro_torch.distributed.sharding``) against
``repro.distributed.sharding``.

The meshes are built in this process under torch's fake process group (512
ranks, rank 0, collectives that do nothing), set up in a module fixture and
destroyed at its teardown, so no other test sees a process group.  It
holds layouts and local shapes, not values after a collective (those are
``tests/test_torch_elastic.py``'s, on a real gloo group).

JAX's side runs once a session in a subprocess with 512 forced host
devices (the flag must be set before JAX starts): every live registry cell
on both production meshes, and the ``opt`` variants of the GNN and SASRec
cells and of two LM cells, dumped as JSON -- each argument leaf's spec,
global shape and ``shard_shape``, each output leaf's spec.  Every port
cell's argument and output specs equal JAX's leaf for leaf; the LM layers
map through ``interop.lm_layer_groups`` (JAX's ``periods/l{i}`` leaf is
the port's layers ``groups[i]``, its spec without the stacked dim's leading
``None``; ``tail/{t}`` is the port's layer ``tail[t]``).  Rank 0's local
shape of every port argument leaf, from ``distribute_tensor`` of a meta
tensor on the fake mesh, equals JAX's shard shape (for a quantized moment,
stored per layer in the port and per stack in JAX, the spec's shard shape
of the port's own leaf).
"""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.distributed import sharding as S
from repro_torch.interop import lm_layer_groups
from repro_torch.launch import mesh as M

REPO = Path(__file__).resolve().parent.parent
LIVE = [(c.arch, c.shape) for c in registry.list_cells() if not c.skip_reason]
# opt variants: their GNN specs differ (features over "model"), the others'
# rules ignore ``opt``; two LM cells hold that, the rest would double the
# JAX side's time for the same rules
OPT_CELLS = [(a, s) for a, s in LIVE
             if registry._mod(a).FAMILY != "lm"] + [
    ("qwen3-moe-30b-a3b", "train_4k"), ("gemma3-27b", "decode_32k")]
MESHES = ("pod", "multipod")

JAX_SPECS = r'''
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax
from repro.configs import registry
from repro.distributed.sharding import (_key_path_str, out_shardings_for_cell,
                                        shardings_for_cell)
from repro.launch.mesh import make_production_mesh

cells = json.loads(sys.argv[2])
def entry(e):
    return list(e) if isinstance(e, tuple) else e
def flat(tree):
    return [(_key_path_str(p), x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]
meshes = {"pod": make_production_mesh(),
          "multipod": make_production_mesh(multi_pod=True)}
out = {}
for arch, shape, opt in cells:
    for name, mesh in meshes.items():
        cb = registry.build_cell(arch, shape, name if opt else "")
        ins = shardings_for_cell(mesh, cb)
        outs = out_shardings_for_cell(mesh, cb, ins)
        shapes = dict(flat(cb.arg_specs))
        out[f"{arch}|{shape}|{name}|{int(opt)}"] = {
            "in": {p: [[entry(e) for e in s.spec], list(shapes[p].shape),
                       list(s.shard_shape(shapes[p].shape))]
                   for p, s in flat(ins)},
            "out": {p: [entry(e) for e in s.spec] for p, s in flat(outs)}}
json.dump(out, open(sys.argv[1], "w"))
'''


@pytest.fixture(scope="session")
def jax_specs(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_specs") / "specs.json"
    cells = [(a, s, False) for a, s in LIVE] + [(a, s, True)
                                                 for a, s in OPT_CELLS]
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"),
               JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    res = subprocess.run([sys.executable, "-c", JAX_SPECS, str(path),
                          json.dumps(cells)], env=env, capture_output=True,
                         text=True, timeout=600, cwd=REPO)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    return json.loads(path.read_text())


@pytest.fixture(scope="module")
def meshes():
    pytest.importorskip("torch.testing._internal.distributed.fake_pg")
    from repro_torch.launch.dryrun import init_fake_group
    init_fake_group(512)
    try:
        yield {"pod": M.make_production_mesh(device_type="cpu"),
               "multipod": M.make_production_mesh(multi_pod=True,
                                                  device_type="cpu")}
    finally:
        dist.destroy_process_group()


def test_production_meshes_have_jax_names_and_shapes(meshes):
    pod, multi = meshes["pod"], meshes["multipod"]
    assert pod.mesh_dim_names == ("data", "model")
    assert tuple(pod.shape) == (16, 16) and pod.size() == 256
    assert multi.mesh_dim_names == ("pod", "data", "model")
    assert tuple(multi.shape) == (2, 16, 16) and multi.size() == 512
    assert M.batch_axes(pod) == ("data",)
    assert M.batch_axes(multi) == ("pod", "data")
    dbg = M.make_debug_mesh((2, 4), ("data", "model"), device_type="cpu")
    assert tuple(dbg.shape) == (2, 4) and M.batch_axes(dbg) == ("data",)
    with pytest.raises(RuntimeError, match="needs 1024 devices"):
        M.make_debug_mesh((32, 32), device_type="cpu")


def test_placements_follow_the_spec_in_mesh_order(meshes):
    from torch.distributed.tensor import Replicate, Shard
    multi = meshes["multipod"]
    assert S.placements(multi, S.P(("pod", "data"), "model")) == (
        Shard(0), Shard(0), Shard(1))
    assert S.placements(multi, S.P(None, ("data", "model"))) == (
        Replicate(), Shard(1), Shard(1))
    assert S.placements(multi, S.P()) == (Replicate(),) * 3
    assert S.P(("data",), None, ()) == ("data", None, None)
    with pytest.raises(ValueError, match="mesh order"):
        S.placements(multi, S.P(("data", "pod")))
    with pytest.raises(ValueError, match="not on the mesh"):
        S.placements(meshes["pod"], S.P("pod"))
    with pytest.raises(ValueError, match="used twice"):
        S.placements(multi, S.P("data", "data"))
    # a dim over two axes: DTensor's rank 0 holds the first of 2 x 16 rows
    sh = S.NamedSharding(multi, S.P(("pod", "data"), "model"))
    x = torch.empty(1024, 2048, device="meta")
    assert sh.local_shape(x) == sh.shard_shape(x.shape) == (32, 128)


def _jax_to_port(cb, jpath: str, spec, shard):
    """JAX's (path, spec, shard shape) as the port's leaves: one a layer of
    a period stack, else the same leaf (a tail layer renamed)."""
    if cb.family != "lm":
        return [(jpath, spec, shard)]
    groups, tail = lm_layer_groups(cb.cfg.n_layers, cb.cfg.period)
    m = re.match(r"^(\d+/(?:[mv]/)?)periods/l(\d+)/(.*)$", jpath)
    if m:
        pre, i, rest = m.group(1), int(m.group(2)), m.group(3)
        quantized = rest.endswith(("/qcodes", "/qscale"))
        if not quantized:            # the stacked dim's leading None
            assert not spec or spec[0] is None, (jpath, spec)
            spec, shard = spec[1:], shard and shard[1:]
        return [(f"{pre}layers/{li}/{rest}", spec,
                 None if quantized else shard) for li in groups[i]]
    m = re.match(r"^(\d+/(?:[mv]/)?)tail/(\d+)/(.*)$", jpath)
    if m:
        return [(f"{m.group(1)}layers/{tail[int(m.group(2))]}/{m.group(3)}",
                 spec, shard)]
    return [(jpath, spec, shard)]


def _spec_json(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def _check_cell(jax_specs, meshes, arch, shape, opt):
    for name in MESHES:
        mesh = meshes[name]
        cb = registry.build_cell(arch, shape, name if opt else "")
        ref = jax_specs[f"{arch}|{shape}|{name}|{int(opt)}"]
        want_in, want_shard = {}, {}
        for jp, (spec, _, shard) in ref["in"].items():
            for p, s, sh in _jax_to_port(cb, jp, spec, shard):
                want_in[p], want_shard[p] = s, sh
        want_out = {}
        for jp, spec in ref["out"].items():
            for p, s, _ in _jax_to_port(cb, jp, spec, None):
                want_out[p] = s
        in_sh = S.shardings_for_cell(mesh, cb)
        out_sh = S.out_shardings_for_cell(mesh, cb, in_sh)
        paths, shs = T.flatten_with_paths(in_sh)
        assert {p: _spec_json(s.spec) for p, s in zip(paths, shs)} \
            == want_in, (name, "arguments")
        paths_o, shs_o = T.flatten_with_paths(out_sh)
        assert {p: _spec_json(s.spec) for p, s in zip(paths_o, shs_o)} \
            == want_out, (name, "outputs")
        leaves = T.flatten_up_to(in_sh, cb.arg_specs)
        for p, s, x in zip(paths, shs, leaves):
            assert x.device.type == "meta"
            local = s.local_shape(x)
            want = want_shard[p]
            if want is None:         # a quantized moment, per layer here
                want = s.shard_shape(x.shape)
            assert list(local) == list(want), (name, p, local, want)


@pytest.mark.parametrize("arch,shape", LIVE)
def test_cell_specs_match_jax(jax_specs, meshes, arch, shape):
    _check_cell(jax_specs, meshes, arch, shape, opt=False)


@pytest.mark.parametrize("arch,shape", OPT_CELLS)
def test_opt_cell_specs_match_jax(jax_specs, meshes, arch, shape):
    _check_cell(jax_specs, meshes, arch, shape, opt=True)
