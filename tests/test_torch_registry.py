"""The port's cell registry against ``repro.configs.registry``: the same 40
cells with the same kinds and 3 skips, each LM arch's parameter count from
``device="meta"`` tensors equal to JAX's ``eval_shape`` count with no byte
allocated, every live cell built, and the SPMD variants: an LM's with
JAX's SPMD fields and a step that runs on DTensors under the production
mesh they name (and refuses without it), Equiformer-v2's with JAX's flags
and a step that runs on the CPU."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.models.transformer import model as M
from repro_torch.optim import AdamWConfig, init_opt_state

LM_ARCHS = ["qwen3-moe-30b-a3b", "kimi-k2-1t-a32b", "gemma2-27b",
            "qwen1.5-4b", "gemma3-27b"]


def test_cells_match_jax():
    cells = registry.list_cells()
    assert len(cells) == 40
    assert [tuple(c) for c in cells] == [tuple(c)
                                         for c in jregistry.list_cells()]
    assert {(c.arch, c.shape) for c in cells if c.skip_reason} == {
        ("qwen3-moe-30b-a3b", "long_500k"), ("kimi-k2-1t-a32b", "long_500k"),
        ("qwen1.5-4b", "long_500k")}
    assert registry.arch_ids() == jregistry.arch_ids()
    for arch in registry.arch_ids():
        assert registry.shapes_for(arch) == jregistry.shapes_for(arch)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_lm_param_counts_equal_jax(arch):
    """Parameters and AdamW state of the train_4k cell on the meta device:
    JAX's exact count, every leaf shape-only."""
    cb = registry.build_cell(arch, "train_4k")
    params, opt_state, batch = cb.arg_specs
    jparams = jregistry.build_cell(arch, "train_4k").arg_specs[0]
    assert M.param_count(params) == sum(int(np.prod(x.shape))
                                        for x in jax.tree.leaves(jparams))
    leaves = T.leaves(cb.arg_specs)
    assert all(x.device.type == "meta" for x in leaves)
    assert batch["tokens"].shape == (256, 4096)
    assert cb.quantized_opt == (arch == "kimi-k2-1t-a32b")
    if cb.quantized_opt:             # 8-bit moments: int8 codes
        assert opt_state["m"]["embed"].qcodes.dtype == torch.int8


def test_every_live_cell_builds():
    for c in registry.list_cells():
        if c.skip_reason:
            with pytest.raises(ValueError, match="skipped"):
                registry.build_cell(c.arch, c.shape)
            continue
        cb = registry.build_cell(c.arch, c.shape)
        assert callable(cb.step_fn) and cb.kind == c.kind
        leaves = T.leaves(cb.arg_specs)
        assert leaves and all(x.device.type == "meta" for x in leaves)
        assert len(cb.arg_specs) == (3 if c.kind == "train" else 2)


@pytest.fixture(scope="module")
def fake_group():
    """The fake process group of the production meshes (512 ranks, this
    process rank 0), destroyed at the module's end."""
    from repro_torch.launch import dryrun
    dryrun.init_fake_group(512)
    yield
    torch.distributed.destroy_process_group()


def _one_layer(cb):
    """The cell with its config cut to one layer: the same step, mesh and
    shardings, fewer ops to place on meta."""
    import types
    cfg = dataclasses.replace(cb.cfg, n_layers=1)
    m = types.SimpleNamespace(full_config=lambda: dataclasses.replace(
        cfg, act_shard_axes=None, data_axis_size=16, ep_shard_map=False))
    _, _, step, specs = registry._lm_cell(
        m, cb.shape, AdamWConfig(quantized_state=cb.quantized_opt), cb.opt)
    return cb._replace(cfg=cfg, step_fn=step, arg_specs=specs)


@pytest.mark.parametrize("arch,shape", [("qwen3-moe-30b-a3b", "train_4k"),
                                        ("equiformer-v2", "molecule")])
@pytest.mark.parametrize("opt", ["pod", "multipod"])
def test_spmd_variants_name_the_roadmap(arch, shape, opt, request):
    """The JAX registry's beyond-paper variants build.  An LM's step runs
    on DTensors under the production mesh its SPMD fields name (the cell
    at one layer, on meta tensors placed by its shardings on the fake
    group: FLOPs and collective bytes counted), and without that mesh
    refuses with ValueError before any layer runs.  Equiformer-v2's
    variant (truncated rotation, bf16 edges) runs here."""
    from repro_torch.launch import step_cost
    from repro_torch.launch.mesh import make_production_mesh
    cb = registry.build_cell(arch, shape, opt)
    assert cb.opt == opt
    if cb.family != "lm":
        assert cb.cfg.truncate_rotation and cb.cfg.edge_bf16
        return
    with pytest.raises(ValueError, match="none is ambient"):
        cb.step_fn(*cb.arg_specs)
    request.getfixturevalue("fake_group")
    mesh = make_production_mesh(multi_pod=(opt == "multipod"),
                                device_type="cpu")
    rec = step_cost.step_flops(_one_layer(cb), mesh)
    assert rec["flops_error"] is None and rec["flops"] > 0
    assert rec["collective_bytes"] and all(
        n > 0 for n in rec["collective_bytes"].values())


_SPMD_FIELDS = ("act_shard_axes", "model_axis_size", "data_axis_size",
                "ep_shard_map")


@pytest.mark.parametrize("arch,shape", [("qwen3-moe-30b-a3b", "train_4k"),
                                        ("qwen1.5-4b", "decode_32k"),
                                        ("kimi-k2-1t-a32b", "prefill_32k")])
@pytest.mark.parametrize("opt", ["", "pod", "multipod"])
def test_lm_opt_cells_carry_jax_spmd_fields(arch, shape, opt):
    """An LM cell's SPMD fields are JAX's for the same ``opt``: the mesh's
    batch axes, their size and the expert-parallel dispatch for an MoE."""
    cfg = registry.build_cell(arch, shape, opt).cfg
    jcfg = jregistry.build_cell(arch, shape, opt).cfg
    for f in _SPMD_FIELDS:
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert (cfg.act_shard_axes is None) == (opt == "")


def test_lm_step_refuses_spmd_fields_on_any_path():
    """A config with the SPMD fields and no ambient mesh is refused by
    every LM entry point before any layer runs (ValueError naming the
    missing mesh), the dense decode included; the paged route refuses it
    under a mesh too: it runs on one card, as the JAX package's paged
    decode does."""
    import dataclasses

    from repro_torch.configs import qwen3_moe_30b_a3b as qm
    from repro_torch.launch.mesh import use_mesh
    cfg = dataclasses.replace(qm.smoke_config(), act_shard_axes=("data",),
                              ep_shard_map=True)
    params = M.init_params(cfg, device="meta")
    tokens = torch.zeros((1, 4), dtype=torch.int32, device="meta")
    cache = M.init_cache(cfg, 1, 8, device="meta")
    for call in (lambda: M.loss_fn(params, cfg, tokens, tokens),
                 lambda: M.prefill(params, cfg, tokens),
                 lambda: M.serve_step(params, cfg, cache, tokens[:, :1])):
        with pytest.raises(ValueError, match="none is ambient"):
            call()
    with use_mesh(object()):
        with pytest.raises(ValueError, match="paged route runs on one card"):
            M.serve_step_paged(params, cfg, [], tokens[:, :1])


@pytest.mark.parametrize("opt", ["pod", "multipod"])
def test_equiformer_opt_cell_runs_a_step_on_the_cpu(opt):
    """Equiformer-v2's ``opt`` cell: JAX's config flags, and the cell's own
    step (its full config, 12 layers at l_max 6) on real CPU tensors over
    a small batch of the cell's fields: finite loss, norm and parameters,
    the embedding moved."""
    from repro_torch.models.gnn import equiformer_v2 as EQ
    cb = registry.build_cell("equiformer-v2", "molecule", opt)
    jcfg = jregistry.build_cell("equiformer-v2", "molecule", opt).cfg
    assert (cb.cfg.truncate_rotation, cb.cfg.edge_bf16) == (
        jcfg.truncate_rotation, jcfg.edge_bf16) == (True, True)
    gen = torch.Generator().manual_seed(0)
    params = EQ.init_params(cb.cfg, gen, device="cpu")
    n, e, graphs = 24, 48, 4
    src = torch.randint(0, n, (e,), generator=gen, dtype=torch.int32)
    dst = (src + 1 + torch.randint(0, n - 1, (e,), generator=gen,
                                   dtype=torch.int32)) % n
    batch = {k: None for k in cb.arg_specs[2]}
    batch.update(
        x=torch.randn((n, cb.cfg.d_in), generator=gen),
        pos=torch.randn((n, 3), generator=gen),
        edge_src=src, edge_dst=dst.to(torch.int32),
        edge_valid=torch.ones(e, dtype=torch.bool),
        node_valid=torch.ones(n, dtype=torch.bool),
        graph_id=torch.arange(n, dtype=torch.int32) // (n // graphs),
        labels=torch.randn((graphs,), generator=gen))
    assert set(batch) == set(cb.arg_specs[2])
    loss, gnorm, new_params, _ = cb.step_fn(
        params, init_opt_state(params, AdamWConfig()), batch)
    assert torch.isfinite(loss) and torch.isfinite(gnorm) and gnorm > 0
    new = T.leaves(new_params)
    assert all(torch.isfinite(b).all() for b in new)
    assert not torch.equal(params["embed"][0]["w"],
                           new_params["embed"][0]["w"])
