"""Batched LM serving over the paged KV cache.

Requests arrive with different prompt lengths and are padded to the
longest.  ``serve`` prefills them (flash attention), fills each layer's page
chains to each sequence's own prompt length (``kvcache.append_many``, the
CBList tail insert), then decodes greedily through ``serve_step_paged``:
every step appends the new token's K/V to its chain and attends over the
chain with the paged kernel.  Finished sequences keep their pages, as in
the JAX driver.

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
    decode_s: List[float]            # one entry per decode step
    pages_used: int                  # of each layer's pool


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


def _clock(device: torch.device) -> float:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def serve(cfg: LMConfig, params: Params, prompts: torch.Tensor,
          prompt_lens: torch.Tensor, decode_steps: int, page: int = 0,
          device=None) -> ServeResult:
    """Prefill ``prompts`` [B, S] (row b live below ``prompt_lens[b]``),
    then ``decode_steps`` greedy steps over the paged caches."""
    dev = resolve_device(device)
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

    generated, step_s = [tok], []
    for _ in range(decode_steps):
        ts = _clock(dev)
        step_logits, caches = M.serve_step_paged(params, cfg, caches, tok,
                                                 inplace=True)
        tok = step_logits.argmax(-1, keepdim=True).to(torch.int32)
        generated.append(tok)
        step_s.append(_clock(dev) - ts)
    c0 = caches[0]
    return ServeResult(tokens=torch.cat(generated, 1), prefill_logits=logits,
                       caches=caches, prefill_s=t1 - t0, fill_s=t2 - t1,
                       decode_s=step_s,
                       pages_used=int(c0.free_stack.numel() - c0.free_top))


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
          f"({n / max(dt, 1e-9):.1f} tok/s); paged pool: {res.pages_used} "
          f"pages per layer in {cfg.n_layers}-layer chains")
    print("sample output ids:", res.tokens[0, :10].tolist())
    if not bool(torch.isfinite(res.prefill_logits).all()):
        raise RuntimeError("prefill logits are not finite")
    return res


if __name__ == "__main__":
    main()
