"""Batched LM serving over the paged KV cache.

Requests arrive with different prompt lengths and are padded to the
longest.  ``serve`` prefills them (flash attention), fills each layer's page
chains to each sequence's own prompt length (``kvcache.append_many``, the
CBList tail insert), then decodes greedily through ``serve_step_paged``:
every step appends the new token's K/V to its chain and attends over the
chain with the paged kernel.  Finished sequences keep their pages, as in
the JAX driver.  Every LM config of ``configs/`` serves through it: an MoE
config (qwen3-moe-30b-a3b, kimi-k2-1t-a32b) routes each step's tokens in
every layer and runs the dispatch and combine on the graph kernels, in
the eager step and in the captured one alike.

On the card the decode step runs as one CUDA graph (:class:`DecodeGraph`):
the first step runs eagerly, then ``serve_step_paged`` is captured over
the caches, whose tensors an in-place step never moves, and every later
step is one replay, in place of some 20 launches a layer from the host
(some 30 in an MoE layer).
This is the port's counterpart of the JAX decoder compiled under ``jit``.
``graph=False`` keeps the eager loop on the card.

Where the JAX driver (``repro.launch.serve``) differs: it decodes through
the dense cache and only fills the pool, and it appends the padded prompt
length to every chain, pad KV included.  Here decode runs on the pool and a
chain holds its own prompt only, so paged decode gives the dense
``serve_step``'s logits.

    PYTHONPATH=src python -m repro_torch.launch.serve --requests 8 --decode 16
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import torch

from repro_torch import backend
from repro_torch.backend import resolve_device
from repro_torch.configs.gemma2_27b import smoke_config
from repro_torch.models.transformer import kvcache
from repro_torch.models.transformer import model as M
from repro_torch.models.transformer.layers import LMConfig, Params


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor             # i32[B, decode_steps + 1], greedy
    prefill_logits: torch.Tensor     # f32[B, vocab]
    caches: List[kvcache.PagedKVCache]
    prefill_s: float                 # prompt in, first token's logits out
    fill_s: float                    # page chains filled from the prefill
    decode_s: List[float]            # one entry per decode step (the
                                     # first one holds the graph's capture)
    pages_used: int                  # of each layer's pool
    graph: bool                      # decoded by replaying a CUDA graph
    capture_s: float                 # the graph's capture (0 without one)


def pages_per_seq(prompt_len: int, decode_steps: int, page: int) -> int:
    """Pages per sequence: the padded prompt and every decode step, plus
    one spare."""
    return -(-(prompt_len + decode_steps) // page) + 1


def fill_paged(cfg: LMConfig, dense: dict, prompt_lens: torch.Tensor,
               npmax: int, page: int) -> List[kvcache.PagedKVCache]:
    """One paged cache per layer, each chain holding its own prompt's K/V
    (positions ``< prompt_lens[b]``) from the dense prefill cache."""
    _, B, KVH, _, D = dense["k"].shape
    caches = []
    for li in range(cfg.n_layers):
        cache = kvcache.init_paged_cache(
            B, KVH, D, B * npmax, page, npmax,
            dtype=dense["k"].dtype, device=dense["k"].device)
        caches.append(kvcache.append_many(cache, dense["k"][li],
                                          dense["v"][li], prompt_lens,
                                          inplace=True))
    return caches


class DecodeGraph:
    """The paged decode step, ``serve_step_paged(..., inplace=True)``, as
    one CUDA graph over fixed caches and static ``tok`` / ``logits``
    buffers.

    Construction runs one real step eagerly on a side stream (it builds the
    kernels and sets their attributes; its logits are ``first_logits``),
    then captures the step.  In-place steps update the caches' tensors where
    they lie, so each later step is :meth:`step`: the token copied into
    ``tok``, one replay.  A replay launches the kernels without their
    wrappers, so the launches the capture counted are taken out of
    ``backend.LAUNCHES`` (the capture ran nothing) and added back on each
    replay.  A failed capture raises.
    """

    def __init__(self, params: Params, cfg: LMConfig,
                 caches: List[kvcache.PagedKVCache], tok: torch.Tensor):
        side = torch.cuda.Stream(device=tok.device)
        side.wait_stream(torch.cuda.current_stream(tok.device))
        with torch.cuda.stream(side):
            self.first_logits, caches = M.serve_step_paged(
                params, cfg, caches, tok, inplace=True)
        torch.cuda.current_stream(tok.device).wait_stream(side)
        self.tok = tok.clone()
        before = dict(backend.LAUNCHES)
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(self.graph):
            self.logits, self.caches = M.serve_step_paged(
                params, cfg, caches, self.tok, inplace=True)
        self.capture_s = time.perf_counter() - t0
        self.launches = {k: n - before[k] for k, n in backend.LAUNCHES.items()
                         if n != before[k]}
        backend.LAUNCHES.update(before)

    def step(self, tok: torch.Tensor) -> torch.Tensor:
        """One decode step from ``tok`` [B, 1]: the static logits buffer."""
        self.tok.copy_(tok)
        self.graph.replay()
        for name, n in self.launches.items():
            backend.LAUNCHES[name] += n
        return self.logits


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def serve(cfg: LMConfig, params: Params, prompts: torch.Tensor,
          prompt_lens: torch.Tensor, decode_steps: int, page: int = 0,
          device=None, graph=None) -> ServeResult:
    """Prefill ``prompts`` [B, S] (row b live below ``prompt_lens[b]``),
    then ``decode_steps`` greedy steps over the paged caches.

    ``graph``: decode by replaying a CUDA graph (:class:`DecodeGraph`);
    ``None`` means a graph on a CUDA device and the eager loop elsewhere.
    """
    dev = resolve_device(device)
    if graph is None:
        graph = dev.type == "cuda"
    if graph and dev.type != "cuda":
        raise ValueError(f"serve: a CUDA graph needs a CUDA device, got "
                         f"{dev}")
    page = page or cfg.kv_page_size
    prompts, prompt_lens = prompts.to(dev), prompt_lens.to(dev)
    B, S = prompts.shape
    live = torch.arange(S, device=dev)[None, :] < prompt_lens[:, None]
    toks = torch.where(live, prompts, 0)

    t0 = _clock(dev)
    logits, dense = M.prefill(params, cfg, toks)
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    t1 = _clock(dev)
    caches = fill_paged(cfg, dense, prompt_lens,
                        pages_per_seq(S, decode_steps, page), page)
    del dense
    t2 = _clock(dev)

    generated, step_s, replay = [tok], [], None
    for _ in range(decode_steps):
        ts = _clock(dev)
        if replay is not None:
            step_logits = replay.step(tok)
        elif graph:          # the first step runs eagerly, then the capture
            replay = DecodeGraph(params, cfg, caches, tok)
            step_logits, caches = replay.first_logits, replay.caches
        else:
            step_logits, caches = M.serve_step_paged(params, cfg, caches,
                                                     tok, inplace=True)
        tok = step_logits.argmax(-1, keepdim=True).to(torch.int32)
        generated.append(tok)
        step_s.append(_clock(dev) - ts)
    c0 = caches[0]
    return ServeResult(tokens=torch.cat(generated, 1), prefill_logits=logits,
                       caches=caches, prefill_s=t1 - t0, fill_s=t2 - t1,
                       decode_s=step_s,
                       pages_used=int(c0.free_stack.numel() - c0.free_top),
                       graph=bool(graph),
                       capture_s=replay.capture_s if replay else 0.0)


def main(argv=None) -> ServeResult:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--decode", type=int, default=16)
    ap.add_argument("--page", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    cfg = smoke_config()
    dev = resolve_device(args.device)
    params = M.init_params(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    B = args.requests
    prompt_lens = torch.randint(4, 12, (B,), generator=gen, device=dev)
    prompts = torch.randint(0, cfg.vocab, (B, int(prompt_lens.max())),
                            generator=gen, device=dev)
    res = serve(cfg, params, prompts, prompt_lens, args.decode, args.page,
                device=dev)
    n = B * args.decode
    dt = sum(res.decode_s)
    print(f"served {B} seqs x {args.decode} tokens on {dev} in {dt:.3f}s "
          f"({n / max(dt, 1e-9):.1f} tok/s, "
          f"{'CUDA graph' if res.graph else 'eager'} decode); paged pool: "
          f"{res.pages_used} pages per layer in {cfg.n_layers}-layer chains")
    print("sample output ids:", res.tokens[0, :10].tolist())
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise RuntimeError("prefill logits are not finite")
    return res


if __name__ == "__main__":
    main()
