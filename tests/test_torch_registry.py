"""The port's cell registry against ``repro.configs.registry``: the same 40
cells with the same kinds and 3 skips, each LM arch's parameter count from
``device="meta"`` tensors equal to JAX's ``eval_shape`` count with no byte
allocated, every live cell built, and the SPMD variants refused."""
import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch import tree as T
from repro_torch.configs import registry
from repro_torch.models.transformer import model as M

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


@pytest.mark.parametrize("arch,shape", [("qwen3-moe-30b-a3b", "train_4k"),
                                        ("equiformer-v2", "molecule")])
@pytest.mark.parametrize("opt", ["pod", "multipod"])
def test_spmd_variants_name_the_roadmap(arch, shape, opt):
    """The JAX registry's beyond-paper variants shard across cards."""
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        registry.build_cell(arch, shape, opt)
