"""End-to-end training driver, as ``repro.launch.train``: the LM family
(``qwen3-moe-30b-a3b``, the default as in JAX's driver, ``kimi-k2-1t-a32b``,
``gemma2-27b``, ``qwen1.5-4b``, ``gemma3-27b``), the GNN family
(``gin-tu``, ``pna``, ``egnn``, ``equiformer-v2``) and SASRec on one
device.

Composes: arch config -> model loss -> AdamW (+clip) -> TrainSupervisor
(async checkpointing, failure injection, straggler policy) -> batches.
An LM's checkpoints are written in the JAX package's tree (its layers
stacked by period, ``interop.lm_checkpoint_layout``), so either package
resumes the other's run.
:func:`make_step` is the JAX ``step_fn`` (loss and gradients, clip to a
global norm of 1, ``warmup_cosine`` over 10 warmup steps, AdamW), eager
under autograd.  On the card the MoE's dispatch and combine, the GNNs'
gathers and sums by destination and SASRec's item-table gradient run on
the ``block_gather`` and ``segment_sum`` kernels, forward and backward,
and SASRec's history lookup on ``embedding_bag``; LM attention trains
through the plain version (the flash kernels have no backward).

    PYTHONPATH=src python -m repro_torch.launch.train --steps 100
    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu \\
        --steps 50 --fail-at 23 --ckpt-every 10
    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec \\
        --device cpu --steps 30
"""
from __future__ import annotations

import argparse
import importlib
import tempfile
import time

import torch

from repro_torch import tree as T
from repro_torch.backend import resolve_device
from repro_torch.configs.registry import ARCH_MODULES, GNN_MODEL_MODULES
from repro_torch.data.synthetic import rmat_edges, sasrec_batches, token_stream
from repro_torch.interop import lm_checkpoint_layout
from repro_torch.models.gnn.common import GraphBatch
from repro_torch.optim import (AdamWConfig, adamw_update, clip_by_global_norm,
                               init_opt_state, warmup_cosine)
from repro_torch.runtime import (FailureInjector, StragglerPolicy,
                                 TrainSupervisor)

WARMUP_STEPS, MAX_GRAD_NORM = 10, 1.0
SMOKE_NODES, SMOKE_EDGES = 256, 1024
SMOKE_CACHED_BATCHES = 32          # the LM and recsys smoke batches
SMOKE_LM_SEQ = 64


def arch_module(arch: str):
    """The config module of ``arch``."""
    if arch not in ARCH_MODULES:
        raise ValueError(f"unknown arch {arch!r}; the port trains "
                         f"{sorted(ARCH_MODULES)}")
    return importlib.import_module(ARCH_MODULES[arch])


def build_smoke_problem(arch: str, batch: int, seed: int = 0, device=None):
    """Returns (cfg, params, loss_fn(params, batch), batches(step)->batch),
    made on ``device`` from ``seed`` at the arch's smoke config.  An LM:
    ``batch`` sequences of 64 ``token_stream`` tokens a batch, 32 cached,
    ``batches(s)`` the cache's ``s % 32`` as ``(tokens, labels)``.  A GNN:
    an RMAT graph of 256 nodes and 1,024 edges with random features,
    positions and labels, the one batch carrying its edge plan.  SASRec:
    ``batch`` users a batch, 32 cached ``sasrec_batches``, each carrying
    its lookup plan."""
    m = arch_module(arch)
    dev = resolve_device(device)
    cfg = m.smoke_config()
    if m.FAMILY == "lm":
        from repro_torch.models.transformer import model as M
        params = M.init_params(cfg, seed, device=dev)
        stream = token_stream(cfg.vocab, batch, SMOKE_LM_SEQ, seed=seed,
                              device=dev)
        cache = [next(stream) for _ in range(SMOKE_CACHED_BATCHES)]

        def lm_loss(p, b):
            return M.loss_fn(p, cfg, b[0], b[1])

        return cfg, params, lm_loss, lambda s: cache[s % len(cache)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    if m.FAMILY == "recsys":
        from repro_torch.models.recsys import sasrec as S
        params = S.init_params(cfg, gen, device=dev)
        stream = sasrec_batches(cfg.n_items, batch, cfg.seq_len, seed=seed,
                                device=dev)
        cache = [S.TrainBatch(*b, plan=S.lookup_plan(*b, cfg.n_items + 1))
                 for b in (next(stream) for _ in range(SMOKE_CACHED_BATCHES))]

        def sasrec_loss(p, b):
            return S.loss_fn(p, cfg, b.seq, b.pos, b.neg, plan=b.plan)

        return cfg, params, sasrec_loss, lambda s: cache[s % len(cache)]

    mod = importlib.import_module(GNN_MODEL_MODULES[m.MODULE])
    params = mod.init_params(cfg, gen, device=dev)
    N = SMOKE_NODES
    src, dst = rmat_edges(N, SMOKE_EDGES, seed=seed, device=dev)
    E = src.numel()
    g = GraphBatch(
        x=torch.randn((N, cfg.d_in), generator=gen, device=dev),
        edge_src=src, edge_dst=dst,
        edge_valid=torch.ones((E,), dtype=torch.bool, device=dev),
        node_valid=torch.ones((N,), dtype=torch.bool, device=dev),
        graph_id=torch.zeros((N,), dtype=torch.int32, device=dev),
        pos=torch.randn((N, 3), generator=gen, device=dev),
        labels=(torch.randn((1,), generator=gen, device=dev)
                if cfg.graph_level else
                torch.randint(0, cfg.n_classes, (N,), generator=gen,
                              device=dev, dtype=torch.int32))).with_plan()

    def loss(p, b):
        return mod.loss_fn(p, cfg, b)

    return cfg, params, loss, lambda s: g


def value_and_grad(loss_fn):
    """``jax.value_and_grad`` over a parameter tree: (loss, grads), the
    loss detached and the grads a tree of ``params``' structure (zeros for
    a leaf the loss does not reach)."""
    def fn(params, *args):
        live = [p.detach().requires_grad_() for p in T.leaves(params)]
        loss = loss_fn(T.unflatten(params, live), *args)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if gr is None else gr
                 for p, gr in zip(live, grads)]
        return loss.detach(), T.unflatten(params, grads)
    return fn


def make_step(loss_fn, opt_cfg: AdamWConfig, total_steps: int):
    """``step_fn((params, opt_state), batch) -> ((params, opt_state),
    {"loss", "gnorm"})``, the JAX driver's step."""
    grad_fn = value_and_grad(loss_fn)

    def step_fn(state, batch):
        params, opt_state = state
        lval, grads = grad_fn(params, batch)
        grads, gnorm = clip_by_global_norm(grads, MAX_GRAD_NORM)
        lr_scale = warmup_cosine(opt_state["step"], warmup_steps=WARMUP_STEPS,
                                 total_steps=total_steps)
        params, opt_state = adamw_update(params, grads, opt_state, opt_cfg,
                                         lr_scale)
        return (params, opt_state), {"loss": lval, "gnorm": gnorm}

    return step_fn


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen3-moe-30b-a3b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, params, loss_fn, batches = build_smoke_problem(args.arch,
                                                        args.batch,
                                                        device=dev)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt_state = init_opt_state(params, opt_cfg)
    step_fn = make_step(loss_fn, opt_cfg, args.steps)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    layout = (lm_checkpoint_layout(cfg.period)
              if arch_module(args.arch).FAMILY == "lm" else None)
    sup = TrainSupervisor(ckpt_dir, ckpt_every=args.ckpt_every,
                          injector=FailureInjector(args.fail_at),
                          straggler=StragglerPolicy(), device=dev,
                          layout=layout)

    losses = []

    def wrapped(state, batch):
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        return state, metrics

    t0 = time.time()
    state = sup.run((params, opt_state), batches, args.steps, wrapped)
    dt = time.time() - t0
    r = sup.report
    print(f"arch={args.arch} device={dev} steps={r.steps_run} "
          f"time={dt:.1f}s loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(recovered={r.failures_recovered} ckpts={r.checkpoints_written} "
          f"stragglers={r.stragglers_flagged})")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not improve")
    return state


if __name__ == "__main__":
    main()
