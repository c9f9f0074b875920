"""The port's training stack against the JAX package's: checkpoints written
by one package and restored by the other bit for bit, the supervisor's
report for the same injected failures, and ``launch/train.py``'s step on
the gin-tu smoke problem (JAX's params and batch) against the JAX driver's
``step_fn`` over 10 steps."""
import torch_parity  # noqa: F401,E402  (first: one torch thread a worker)
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpoint as jckpt
from repro.launch import train as jtrain
from repro.optim import (AdamWConfig as JAdamWConfig, adamw_update as jadamw,
                         clip_by_global_norm as jclip,
                         init_opt_state as jinit, warmup_cosine as jwarmup)
from repro.runtime import (FailureInjector as JInjector,
                           TrainSupervisor as JSupervisor)
from repro_torch import interop
from repro_torch import tree as T
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step, restore,
                                    save)
from repro_torch.launch import train
from repro_torch.models.gnn import gin
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.runtime import FailureInjector, TrainSupervisor

SMOKE_STEPS, LOSS_RTOL = 10, 1e-4


def jax_state(quantized):
    """The gin-tu smoke params and their AdamW state, as JAX trees."""
    cfg, params, _, _ = jtrain.build_smoke_problem("gin-tu", 8)
    return cfg, (params, jinit(params, JAdamWConfig(
        quantized_state=quantized)))


def torch_template(jtree):
    """A port tree of the same structure (params and opt state) holding
    zeros, so a restore must fill every leaf."""
    params, opt = jtree

    def zeros(t):
        return jax.tree.map(lambda v: np.zeros_like(np.asarray(v)), t)

    tp = interop.gnn_params_from_jax(zeros(params), device="cpu")
    return (tp, init_opt_state(tp, AdamWConfig(
        quantized_state=isinstance(opt["m"]["head"][0]["w"], tuple))))


def assert_bits(got_tree, ref_tree):
    got, ref = T.leaves(got_tree), jax.tree.leaves(ref_tree)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        g, r = interop.to_numpy(g), np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.reshape(-1).view(np.uint8),
                                      r.reshape(-1).view(np.uint8))


@pytest.mark.parametrize("quantized", [False, True])
def test_checkpoint_cross_read(tmp_path, quantized):
    """JAX writes, the port restores; the port writes (sync and async), JAX
    restores; every leaf bit for bit, manifests with the same paths."""
    _, jtree = jax_state(quantized)
    # a step that moved the params off their init and the moments off 0
    params, opt = jtree
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.25), params)
    jtree = jadamw(params, grads, opt, JAdamWConfig(quantized_state=quantized))
    jckpt.save(tmp_path / "jax", 7, jtree)
    got = restore(tmp_path / "jax", torch_template(jtree), device="cpu")
    assert_bits(got, jtree)

    save(tmp_path / "port", 7, got)
    ck = AsyncCheckpointer(tmp_path / "async")
    ck.save_async(9, got)
    ck.wait()
    assert latest_step(tmp_path / "async") == 9
    for where, step in (("port", 7), ("async", 9)):
        back = jckpt.restore(tmp_path / where, jtree, step=step)
        assert_bits(got, back)
        ours = json.loads((tmp_path / where / f"step_{step:09d}" /
                           "manifest.json").read_text())
        theirs = json.loads((tmp_path / "jax" / "step_000000007" /
                             "manifest.json").read_text())
        assert ours["leaves"] == theirs["leaves"]


def test_restore_refuses_another_tree(tmp_path):
    _, jtree = jax_state(False)
    jckpt.save(tmp_path, 1, jtree[0])
    with pytest.raises(ValueError, match="leaves"):
        restore(tmp_path, torch_template(jtree), device="cpu")


SCHEDULES = [dict(fail_at=[7, 13], ckpt_every=5, n=20),
             dict(fail_at=[2], ckpt_every=5, n=12),
             dict(fail_at=[13], ckpt_every=10, n=20),
             dict(fail_at=[], ckpt_every=4, n=9)]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_supervisor_report_matches_jax(tmp_path, sched):
    """The same failure schedule through both supervisors: steps run,
    failures recovered, checkpoints written and the final state; then a
    second run resumes from the last checkpoint in both."""
    def jstep(state, batch):
        return {"w": state["w"] + batch}, {}

    def tstep(state, batch):
        return {"w": state["w"] + batch}, {}

    def batches(s):
        return float(s + 1)

    jsup = JSupervisor(str(tmp_path / "jax"), ckpt_every=sched["ckpt_every"],
                       injector=JInjector(sched["fail_at"]))
    jout = jsup.run({"w": jnp.zeros(3)}, batches, sched["n"], jstep)
    tsup = TrainSupervisor(str(tmp_path / "port"),
                           ckpt_every=sched["ckpt_every"],
                           injector=FailureInjector(sched["fail_at"]),
                           device="cpu")
    tout = tsup.run({"w": torch.zeros(3)}, batches, sched["n"], tstep)
    for key in ("steps_run", "failures_recovered", "checkpoints_written"):
        assert getattr(tsup.report, key) == getattr(jsup.report, key), key
    np.testing.assert_array_equal(tout["w"].numpy(), np.asarray(jout["w"]))
    # resume: both restore their newest checkpoint and run to 2n
    jsup2 = JSupervisor(str(tmp_path / "jax"), ckpt_every=sched["ckpt_every"])
    tsup2 = TrainSupervisor(str(tmp_path / "port"),
                            ckpt_every=sched["ckpt_every"], device="cpu")
    jout = jsup2.run({"w": jnp.zeros(3)}, batches, 2 * sched["n"], jstep)
    tout = tsup2.run({"w": torch.zeros(3)}, batches, 2 * sched["n"], tstep)
    assert tsup2.report.steps_run == jsup2.report.steps_run
    np.testing.assert_array_equal(tout["w"].numpy(), np.asarray(jout["w"]))


def test_supervisor_reraises_past_max_restarts(tmp_path):
    def failing(state, batch):
        raise RuntimeError("a device fault, not an injected failure")

    sup = TrainSupervisor(str(tmp_path), max_restarts=2, device="cpu")
    with pytest.raises(RuntimeError, match="device fault"):
        sup.run({"w": torch.zeros(1)}, lambda s: 0, 5, failing)
    assert sup.report.failures_recovered == 3


@functools.lru_cache(maxsize=None)
def jax_smoke_losses():
    """10 losses of the JAX driver's step_fn on the gin-tu smoke problem,
    with its params and batch as numpy."""
    cfg, params, loss_fn, batches = jtrain.build_smoke_problem("gin-tu", 8)
    opt_cfg = JAdamWConfig(lr=1e-3)

    @jax.jit
    def step_fn(state, batch):
        params, opt_state = state
        lval, grads = jax.value_and_grad(loss_fn)(params, batch)
        grads, gnorm = jclip(grads, 1.0)
        lr_scale = jwarmup(opt_state["step"], warmup_steps=10,
                           total_steps=SMOKE_STEPS)
        params, opt_state = jadamw(params, grads, opt_state, opt_cfg,
                                   lr_scale)
        return (params, opt_state), lval

    state, losses = (params, jinit(params, opt_cfg)), []
    for s in range(SMOKE_STEPS):
        state, lval = step_fn(state, batches(s))
        losses.append(float(lval))
    g = batches(0)
    arrays = {k: np.asarray(v) for k, v in g._asdict().items()
              if v is not None}
    return cfg, jax.tree.map(np.asarray, params), arrays, losses


@pytest.mark.parametrize("impl", ["torch", "cuda"])
def test_smoke_losses_match_jax_step_fn(impl):
    """launch/train.py's step (loss, grads, clip, warmup-cosine, AdamW) on
    the JAX smoke problem's params and batch: 10 losses within rtol 1e-4
    of the JAX step_fn's, and falling."""
    jcfg, jparams, arrays, ref = jax_smoke_losses()
    cfg = gin.GINConfig(**{k: getattr(jcfg, k)
                           for k in jcfg.__dataclass_fields__})
    params = interop.gnn_params_from_jax(jparams, device="cpu")
    g = GraphBatch(**{k: torch.tensor(v) for k, v in arrays.items()}) \
        .with_plan()
    opt_cfg = AdamWConfig(lr=1e-3)
    step_fn = train.make_step(lambda p, b: gin.loss_fn(p, cfg, b, impl),
                              opt_cfg, SMOKE_STEPS)
    state, losses = (params, init_opt_state(params, opt_cfg)), []
    for _ in range(SMOKE_STEPS):
        state, metrics = step_fn(state, g)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses, ref, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]


def test_build_smoke_problem_families():
    """Every arch of the registry (the LM archs, the GNN archs with
    Equiformer-v2, SASRec) builds and takes a step on the host; SASRec's
    and the LMs' batches cycle through 32 cached ones, SASRec's each with
    its lookup plan; an unknown arch is refused."""
    for arch in train.ARCH_MODULES:
        cfg, params, loss_fn, batches = train.build_smoke_problem(
            arch, 8, device="cpu")
        assert np.isfinite(float(loss_fn(params, batches(0))))
    _, _, _, batches = train.build_smoke_problem("sasrec", 8, device="cpu")
    assert batches(33) is batches(1) and batches(0) is not batches(1)
    assert batches(0).plan.built_from == tuple(batches(0)[:3])
    assert batches(0).seq.shape == (8, 10)
    _, _, _, batches = train.build_smoke_problem("qwen3-moe-30b-a3b", 8,
                                                 device="cpu")
    assert batches(33) is batches(1) and batches(0) is not batches(1)
    assert batches(0)[0].shape == batches(0)[1].shape == (8, 64)
    with pytest.raises(ValueError, match="unknown arch"):
        train.build_smoke_problem("gpt-2", 8, device="cpu")


def test_main_recovers_and_trains(tmp_path, capsys):
    train.main(["--arch", "gin-tu", "--device", "cpu", "--steps", "12",
                "--fail-at", "7", "--ckpt-every", "5", "--ckpt-dir",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert "steps=14" in out and "recovered=1 ckpts=2" in out


# SASRec's smoke batches cycle through 32 cached ones: at 33 steps the last
# step reads the first one's batch again, so ``main`` compares the loss of
# one batch before and after training
@pytest.mark.parametrize("arch,steps", [("equiformer-v2", 12), ("sasrec", 33)])
def test_main_trains_the_new_archs(tmp_path, capsys, arch, steps):
    """CPU steps of each arch this slice adds, one failure recovered;
    ``main`` raises unless the loss falls."""
    train.main(["--arch", arch, "--device", "cpu", "--steps", str(steps),
                "--fail-at", "7", "--ckpt-every", "5", "--ckpt-dir",
                str(tmp_path)])
    out = capsys.readouterr().out
    assert f"arch={arch}" in out
    assert f"recovered=1 ckpts={steps // 5}" in out
