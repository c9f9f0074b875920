"""The port's dry run (``repro_torch.launch.dryrun``) and its step cost
(``repro_torch.launch.step_cost``, the counterpart of
``repro.launch.hlo_cost``).

``dryrun.main`` sets up the fake process group in this process, places the
cells on both production meshes and destroys the group: gin-tu
``molecule`` and sasrec ``serve_p99`` give FLOPs and argument bytes above 0
(tests/test_sharding_dryrun.py's cells), with collective bytes null and
the reason; an LM ``opt`` cell's step runs on meta DTensors under the
mesh, with rank 0's FLOPs and its collective bytes by kind; a step that
raises records ``null`` FLOPs with the error, never 0.  FLOPs a step grow linearly with depth: 8 layers of ``tanh(x @ w)``
count exactly ``2 * 128 * 256 * 256 * 8`` (tests/test_data_and_hlo.py's
calibration, where a Python loop needs no trip count), and a dense LM's
train step is affine in its layers.  On small dense LM train steps the
port's count equals ``parse_hlo`` of JAX's compiled step with no tolerance:
both count ``2 * M * N * K`` per product, JAX's dots (its ``dot`` and
``dot_general``) against the port's ``aten.mm`` (projections, MLP, head,
their gradients) and ``aten.bmm`` (attention's two products and their
gradients); nothing else has products on either side.
"""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import dataclasses
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import gemma2_27b as jgemma2
from repro.configs import qwen1_5_4b as jqwen
from repro.configs import registry as jregistry
from repro.launch.hlo_cost import parse_hlo
from repro.models.transformer import model as JM
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import init_opt_state as jinit_opt
from repro_torch.configs import registry
from repro_torch.launch import dryrun, step_cost
from repro_torch.models.transformer import model as M
from repro_torch.optim import AdamWConfig, init_opt_state
from torch_parity import lm_config

pytest.importorskip("torch.testing._internal.distributed.fake_pg")


@pytest.mark.parametrize("arch,shape", [("gin-tu", "molecule"),
                                        ("sasrec", "serve_p99")])
def test_dryrun_cell_both_meshes(arch, shape, tmp_path):
    dryrun.main(["--arch", arch, "--shape", shape, "--mesh", "both",
                 "--out", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    for mesh, n in (("pod", 256), ("multipod", 512)):
        rec = json.loads((tmp_path / f"{arch}__{shape}__{mesh}.json")
                         .read_text())
        assert rec["n_devices"] == n
        assert rec["flops_per_step"] > 0 and rec["flops_error"] is None
        assert rec["argument_bytes_per_device"] > 0
        assert rec["output_bytes_per_device"] > 0
        assert rec["argument_bytes_fit_h100_80gb"] is True
        # unknown is null with its reason, never 0: a step on plain
        # tensors issues no collective to count
        assert rec["collective_bytes"] is None and rec["temp_bytes"] is None
        assert rec["not_counted"] == step_cost.NOT_COUNTED


def test_dryrun_records_a_refused_step_as_null(tmp_path, monkeypatch):
    """A step that raises on meta leaves FLOPs and output bytes null with
    the exception's text, never 0; the argument bytes are still placed."""
    cb = registry.build_cell("gin-tu", "molecule")

    def refuses(*args):
        raise ValueError("this step does not run on meta")

    monkeypatch.setattr(registry, "build_cell",
                        lambda *a, **k: cb._replace(step_fn=refuses))
    dryrun.main(["--arch", "gin-tu", "--shape", "molecule", "--mesh", "pod",
                 "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "gin-tu__molecule__pod.json").read_text())
    assert rec["flops_per_step"] is None
    assert rec["output_bytes_per_device"] is None
    assert rec["flops_error"] == "ValueError: this step does not run on meta"
    assert rec["collective_bytes"] is None
    assert rec["argument_bytes_per_device"] > 0


def test_dryrun_lm_opt_record_counts_flops_and_collectives(tmp_path):
    """An LM ``opt`` cell's step runs on meta DTensors under the pod mesh
    of the fake group: rank 0's FLOPs above 0 and below the whole step's
    (the baseline cell's), no ``flops_error``, and its collective bytes by
    kind, each above 0."""
    dryrun.main(["--arch", "qwen3-moe-30b-a3b", "--shape", "train_4k",
                 "--mesh", "pod", "--opt", "--out", str(tmp_path)])
    assert not torch.distributed.is_initialized()
    rec = json.loads((tmp_path / "qwen3-moe-30b-a3b__train_4k__pod__opt.json")
                     .read_text())
    assert rec["opt"] and rec["flops_error"] is None
    whole = step_cost.step_flops(registry.build_cell("qwen3-moe-30b-a3b",
                                                     "train_4k"))["flops"]
    assert 0 < rec["flops_per_step"] < whole
    assert set(rec["collective_bytes"]) >= {"all_gather_into_tensor",
                                            "all_reduce",
                                            "reduce_scatter_tensor"}
    assert all(n > 0 for n in rec["collective_bytes"].values())
    assert rec["output_bytes_per_device"] > 0
    assert rec["not_counted"] == step_cost.NOT_COUNTED_TEMP


class _Cell:
    """A stand-in CellBuild: a step and its meta arguments."""

    def __init__(self, step_fn, *arg_specs):
        self.step_fn, self.arg_specs = step_fn, arg_specs


def test_flops_exact_on_a_layer_loop():
    def stack(x, ws):
        for w in ws:
            x = torch.tanh(x @ w)
        return x

    meta = dict(device="meta", dtype=torch.float32)
    cell = _Cell(stack, torch.empty(128, 256, **meta),
                 [torch.empty(256, 256, **meta) for _ in range(8)])
    rec = step_cost.step_flops(cell)
    assert rec["flops"] == 2 * 128 * 256 * 256 * 8
    assert rec["outputs"].shape == (128, 256)


def _lm_train_cell(cfg, B=2, S=32):
    step = registry._train_step(
        lambda p, b: M.loss_fn(p, cfg, b["tokens"], b["labels"]),
        AdamWConfig())
    params = M.init_params(cfg, device="meta")
    ids = torch.empty((B, S), dtype=torch.int32, device="meta")
    return _Cell(step, params, init_opt_state(params, AdamWConfig()),
                 {"tokens": ids, "labels": ids})


def test_lm_step_flops_affine_in_depth():
    base = lm_config(jqwen.smoke_config())
    f = [step_cost.step_flops(_lm_train_cell(
        dataclasses.replace(base, n_layers=n)))["flops"] for n in (1, 2, 4)]
    assert f[0] > 0
    assert f[2] - f[1] == 2 * (f[1] - f[0])


@pytest.mark.parametrize("jmod", [jqwen, jgemma2],
                         ids=["qwen1.5-smoke", "gemma2-smoke"])
def test_flops_equal_parse_hlo_of_jax_step(jmod):
    B, S = 2, 32
    jcfg = jmod.smoke_config()
    jopt = JAdamWConfig()
    p = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))
    batch = {k: jax.ShapeDtypeStruct((B, S), jnp.int32)
             for k in ("tokens", "labels")}
    compiled = jax.jit(jregistry._lm_train_step(jcfg, jopt)).lower(
        p, jax.eval_shape(lambda q: jinit_opt(q, jopt), p), batch).compile()
    ref = parse_hlo(compiled.as_text())["flops"]
    rec = step_cost.step_flops(_lm_train_cell(lm_config(jcfg), B, S))
    assert set(rec["flops_by_op"]) == {"aten.mm", "aten.bmm"}
    assert rec["flops"] == ref, (rec["flops_by_op"], ref)
