"""LM train-state checkpoints in the JAX package's tree: the port writes an
LM state (parameters and AdamW's ``m``, ``v``, ``step``) with its layers
stacked by period (``periods/l{i}`` [n_periods, ...] plus ``tail``,
``interop.lm_checkpoint_layout``) and restores such a checkpoint, whichever
package wrote it, into its layer list, bit for bit; at the qwen3-moe smoke
config (two layers, one period) and test_torch_lm.py's 5-layer ``tiny``
(two periods of two and a tail of one).  ``launch/train.py`` writes an LM's
checkpoints so and a GNN's as before."""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.configs import qwen3_moe_30b_a3b as j_qwen
from repro.models.transformer import model as JM
from repro.models.transformer.layers import LMConfig as JLMConfig
from repro.optim import (AdamWConfig as JAdamWConfig, adamw_update as jadamw,
                         init_opt_state as jinit)
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.launch import train
from repro_torch.models.transformer import model as M
from repro_torch.optim import AdamWConfig, init_opt_state

from torch_parity import lm_config


def _tiny():
    return JLMConfig(name="tiny", n_layers=5, d_model=64, n_heads=4,
                     n_kv_heads=2, d_ff=128, vocab=97, window_pattern=(8, 0),
                     attn_softcap=50.0, final_softcap=30.0, qkv_bias=True,
                     dtype=jnp.float32)


CONFIGS = {"qwen3-moe": j_qwen.smoke_config, "tiny": _tiny}


@functools.lru_cache(maxsize=None)
def jax_state(name):
    """JAX's config and train state after one AdamW update (parameters off
    their init, moments off 0, step 1), made in one jitted call."""
    jcfg = CONFIGS[name]()

    def make(key):
        params = JM.init_params(key, jcfg)
        grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), params)
        return jadamw(params, grads, jinit(params, JAdamWConfig()),
                      JAdamWConfig())

    return jcfg, jax.jit(make)(jax.random.PRNGKey(5))


def port_state(jstate):
    """The same state in the port's layout (``lm_params_from_jax`` of the
    parameters and of each moment tree)."""
    params, opt = jax.tree.map(np.asarray, jstate)
    return (interop.lm_params_from_jax(params, device="cpu"),
            {"m": interop.lm_params_from_jax(opt["m"], device="cpu"),
             "v": interop.lm_params_from_jax(opt["v"], device="cpu"),
             "step": torch.as_tensor(np.array(opt["step"]))})


def template(jcfg):
    """A port state of zeros, so a restore must fill every leaf."""
    params = T.tree_map(torch.zeros_like,
                        M.init_params(lm_config(jcfg), 0, device="cpu"))
    return params, init_opt_state(params, AdamWConfig())


def bits(x) -> torch.Tensor:
    x = torch.as_tensor(np.array(x)) if not isinstance(x, torch.Tensor) \
        else x
    return x.detach().contiguous().reshape(-1).view(torch.uint8)


def assert_same_bits(got, ref):
    assert len(got) == len(ref)
    for i, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == r.dtype and g.shape == r.shape, i
        assert torch.equal(bits(g), bits(r)), i


@pytest.mark.parametrize("name", list(CONFIGS))
def test_jax_checkpoint_restores_into_the_layer_list(tmp_path, name):
    jcfg, jstate = jax_state(name)
    jckpt.save(tmp_path, 3, jstate)
    layout = interop.lm_checkpoint_layout(jcfg.period)
    got = restore(tmp_path, template(jcfg), device="cpu", layout=layout)
    assert_same_bits(T.leaves(got), T.leaves(port_state(jstate)))
    assert len(got[0]["layers"]) == jcfg.n_layers


@pytest.mark.parametrize("name", list(CONFIGS))
def test_port_checkpoint_restores_in_jax(tmp_path, name):
    """The port writes (sync and async) in the layout: JAX's ``restore``
    with a JAX template gives JAX's state back bit for bit, and the
    manifests hold JAX's paths, shapes and dtypes."""
    jcfg, jstate = jax_state(name)
    jckpt.save(tmp_path / "jax", 3, jstate)
    state = port_state(jstate)
    layout = interop.lm_checkpoint_layout(jcfg.period)
    save(tmp_path / "port", 3, state, layout=layout)
    ck = AsyncCheckpointer(tmp_path / "async", layout=layout)
    ck.save_async(4, state)
    ck.wait()
    theirs = json.loads((tmp_path / "jax" / "step_000000003" /
                         "manifest.json").read_text())
    for where, step in (("port", 3), ("async", 4)):
        back = jckpt.restore(tmp_path / where, jstate, step=step)
        assert_same_bits(jax.tree.leaves(back), jax.tree.leaves(jstate))
        ours = json.loads((tmp_path / where / f"step_{step:09d}" /
                           "manifest.json").read_text())
        assert ours["leaves"] == theirs["leaves"]
    paths = [leaf["path"] for leaf in theirs["leaves"]]
    assert "0/periods/l0/attn/wq" in paths
    assert any(p.startswith("0/tail/0/") for p in paths) == (name == "tiny")


def test_bf16_state_round_trips_in_the_layout(tmp_path):
    """A bf16 state through the port's own save and restore in the layout:
    each stacked file holds its layers' bytes in order, and the restore
    gives every leaf back bit for bit."""
    cfg = dataclasses.replace(lm_config(_tiny()), dtype=torch.bfloat16)
    params = M.init_params(cfg, 7, device="cpu")
    state = (params, init_opt_state(params, AdamWConfig()))
    layout = interop.lm_checkpoint_layout(cfg.period)
    save(tmp_path, 1, state, layout=layout)
    got = restore(tmp_path, T.tree_map(torch.zeros_like, state),
                  device="cpu", layout=layout)
    assert_same_bits(T.leaves(got), T.leaves(state))
    manifest = json.loads((tmp_path / "step_000000001" /
                           "manifest.json").read_text())
    i = [leaf["path"] for leaf in manifest["leaves"]].index(
        "0/periods/l1/attn/wq")
    assert manifest["leaves"][i]["dtype"] == "bfloat16"
    stacked = np.load(tmp_path / "step_000000001" / f"{i}.npy")
    for p, li in enumerate((1, 3)):               # l1: layers 1 and 3
        assert bytes(stacked[p]) == bytes(bits(params["layers"][li]["attn"]
                                               ["wq"]).numpy())


def test_restore_refuses_the_other_layout(tmp_path):
    """A checkpoint of the layer list is not read as the stacked tree."""
    jcfg = _tiny()
    state = template(jcfg)
    save(tmp_path, 1, state)
    with pytest.raises(ValueError, match="leaves"):
        restore(tmp_path, state, device="cpu",
                layout=interop.lm_checkpoint_layout(jcfg.period))


def _manifest_paths(ckpt_dir):
    step = latest_step(ckpt_dir)
    manifest = json.loads((ckpt_dir / f"step_{step:09d}" /
                           "manifest.json").read_text())
    return [leaf["path"] for leaf in manifest["leaves"]]


def test_train_main_writes_lm_checkpoints_in_the_jax_tree(tmp_path, capsys):
    """``launch/train.py``'s LM branch checkpoints through the supervisor in
    JAX's tree (recovering one failure from it); the gin-tu branch keeps
    the tree as it is."""
    train.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--steps",
                "7", "--fail-at", "6", "--ckpt-every", "5", "--ckpt-dir",
                str(tmp_path / "lm")])
    assert "recovered=1 ckpts=1" in capsys.readouterr().out
    jcfg, jstate = jax_state("qwen3-moe")
    jckpt.save(tmp_path / "jax", 1, jstate)
    assert _manifest_paths(tmp_path / "lm") == \
        _manifest_paths(tmp_path / "jax")

    train.main(["--arch", "gin-tu", "--device", "cpu", "--steps", "5",
                "--ckpt-every", "5", "--ckpt-dir", str(tmp_path / "gnn")])
    _, params, _, _ = train.build_smoke_problem("gin-tu", 8, device="cpu")
    state = (params, init_opt_state(params, AdamWConfig()))
    assert _manifest_paths(tmp_path / "gnn") == \
        T.flatten_with_paths(state)[0]
