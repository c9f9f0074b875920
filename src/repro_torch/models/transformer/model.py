"""Decoder-only LM: init, forward, loss, prefill and decode, as in
``repro.models.transformer.model``.

Parameters are a dict: ``embed`` [vocab, d], ``lm_head`` [d, vocab],
``ln_f``, and ``layers``, a list in depth order.  The JAX package stacks the
layers by period (``periods/l{i}`` [n_periods, ...] plus ``tail``); layer
``p * period + i`` here is period p's sub-layer i there, and the tail comes
after (``interop.lm_params_from_jax``).

Decoding comes in two forms over the same layers:

* :func:`serve_step` — the dense KV cache [L, B, KVH, S, D] and plain
  attention, the JAX package's decoder and the port's reference;
* :func:`serve_step_paged` — one :class:`PagedKVCache` per layer: the token's
  K/V are appended to its sequence's page chain and attention reads the
  chain through the paged kernel; an MoE layer routes the step's B tokens
  and runs its dispatch and combine on the graph kernels.  Same logits as
  :func:`serve_step`.

An MoE layer decodes as the JAX ``_decode_layer`` does: one MoE call over
the B tokens of the step at ``capacity(cfg, B)`` slots an expert, overflow
dropped (the residual passes through), the aux loss discarded.  Capacity
couples the rows: which lanes keep a slot depends on every row's routing.

Prefill (and forward) run attention through the flash kernel on the card
(``impl="cuda"``), where the JAX ``prefill`` hard-codes its XLA path.
:func:`loss_fn` runs attention through the plain version always (the flash
kernels have no backward; JAX's ``loss_fn`` takes ``impl="xla"``), and its
``impl`` picks the MoE route.  :func:`serve_step` runs the MoE on its
plain route (``"torch"``); :func:`serve_step_paged` on the step's
``impl``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.backend import resolve_device
from repro_torch.models.transformer import kvcache
from repro_torch.models.transformer.layers import (LMConfig, Params, _ffn,
                                                   apply_layer,
                                                   check_single_card,
                                                   init_attention, init_mlp,
                                                   init_moe, init_rmsnorm,
                                                   qkv_proj, rmsnorm, rope)

NEG_INF = -1e30


def _init_layer(gen, cfg: LMConfig, dev) -> Params:
    p = {"ln1": init_rmsnorm(cfg.d_model, dev),
         "ln2": init_rmsnorm(cfg.d_model, dev),
         "attn": init_attention(gen, cfg, dev)}
    if cfg.moe:
        p["moe"] = init_moe(gen, cfg, dev)
    else:
        p["mlp"] = init_mlp(gen, cfg, dev)
    return p


def init_params(cfg: LMConfig, seed: int = 0, device=None) -> Params:
    """Random weights from ``seed``, made on ``device`` (the card by default)
    in the config's type, never as float32 first.  On ``"meta"`` the
    tensors have shapes and no bytes (the registry's specs); their
    generator then lives on the host."""
    dev = resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
    gen.manual_seed(seed)
    layers = [_init_layer(gen, cfg, dev) for _ in range(cfg.n_layers)]
    return {
        "embed": torch.randn((cfg.vocab, cfg.d_model), generator=gen,
                             dtype=cfg.dtype, device=dev).mul_(0.02),
        "lm_head": torch.randn((cfg.d_model, cfg.vocab), generator=gen,
                               dtype=cfg.dtype,
                               device=dev).mul_(cfg.d_model ** -0.5),
        "ln_f": init_rmsnorm(cfg.d_model, dev),
        "layers": layers,
    }


def param_count(params: Params) -> int:
    def count(x):
        if isinstance(x, dict):
            return sum(count(v) for v in x.values())
        if isinstance(x, list):
            return sum(count(v) for v in x)
        return x.numel()
    return count(params)


def embed(params: Params, cfg: LMConfig, tokens: torch.Tensor):
    # the scale is rounded to the model's type before the multiply, as in
    # the reference (sqrt(4608) = 67.88 is 68.0 in bf16).  A Python number
    # holding that value gives the same product with no copy to the device,
    # which a CUDA graph's capture forbids.  ``F.embedding``'s gradient sums
    # a token's rows in float32 and rounds once (an index's adds in the
    # table's type, one rounding per occurrence)
    scale = torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype).item()
    return F.embedding(tokens.long(), params["embed"]) * scale


def _head(params: Params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    logits = (rmsnorm(params["ln_f"], x, cfg.norm_eps)
              @ params["lm_head"]).float()
    if cfg.final_softcap > 0:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


def _positions(tokens: torch.Tensor) -> torch.Tensor:
    B, S = tokens.shape
    return torch.arange(S, dtype=torch.int32,
                        device=tokens.device)[None].expand(B, S)


def forward(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            impl: str = "cuda", attn_impl: Optional[str] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] -> (logits [B, S, vocab] float32, the layers' summed
    MoE aux loss, 0 for a dense model).  Attention takes ``attn_impl``
    (``impl`` when None), the MoE ``impl``."""
    positions = _positions(tokens)
    x = embed(params, cfg, tokens)
    aux = torch.zeros((), device=tokens.device)
    for lp, window in zip(params["layers"], cfg.layer_windows):
        x, _, _, a = apply_layer(lp, cfg, x, positions, window, impl,
                                 attn_impl)
        aux = aux + a
    return _head(params, cfg, x), aux


def loss_fn(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            labels: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
    """Mean next-token cross-entropy over the labels >= 0 (logsumexp of
    the float32 logits) plus 0.01 x the aux loss.  Attention is the plain
    version; ``impl`` picks the MoE route."""
    logits, aux = forward(params, cfg, tokens, impl=impl, attn_impl="torch")
    logz = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    ll = logits.gather(-1, labels.long().clamp(min=0)[..., None])[..., 0]
    nll = torch.where(mask, logz - ll, 0.0).sum() \
        / mask.sum().clamp(min=1)
    return nll + 0.01 * aux


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> Dict[str, torch.Tensor]:
    """A zeroed dense KV cache [L, B, KVH, max_seq, D] with lengths 0."""
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype or cfg.dtype, device=dev),
            "lengths": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def prefill(params: Params, cfg: LMConfig, tokens: torch.Tensor,
            impl: str = "cuda"):
    """Run the prompt [B, S]: (logits at position S - 1 [B, vocab], dense
    cache {k, v [L, B, KVH, S, D], lengths = S})."""
    B, S = tokens.shape
    positions = _positions(tokens)
    x = embed(params, cfg, tokens)
    shape = (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim)
    k_cache = torch.empty(shape, dtype=x.dtype, device=x.device)
    v_cache = torch.empty(shape, dtype=x.dtype, device=x.device)
    for li, (lp, window) in enumerate(zip(params["layers"],
                                          cfg.layer_windows)):
        x, k_cache[li], v_cache[li], _ = apply_layer(lp, cfg, x, positions,
                                                     window, impl)
    # the last position for every row, as in the reference: for a shorter,
    # padded prompt that is a pad position
    logits = _head(params, cfg, x[:, -1])
    return logits, {"k": k_cache, "v": v_cache,
                    "lengths": torch.full((B,), S, dtype=torch.int32,
                                          device=x.device)}


# ---------------------------------------------------------------------------
# decode: one token per sequence
# ---------------------------------------------------------------------------

def _decode_qkv(p: Params, cfg: LMConfig, x: torch.Tensor,
                pos: torch.Tensor):
    """x [B, 1, d] at positions pos [B] -> q [B, H, D], k, v [B, KVH, D]."""
    q, k, v = qkv_proj(p["attn"], cfg, rmsnorm(p["ln1"], x, cfg.norm_eps))
    pos = pos[:, None, None]
    return (rope(q, pos, cfg.rope_theta)[:, :, 0],
            rope(k, pos, cfg.rope_theta)[:, :, 0], v[:, :, 0])


def _decode_out(p: Params, cfg: LMConfig, x: torch.Tensor,
                o: torch.Tensor, impl: str) -> torch.Tensor:
    """The layer's attention output o [B, H, D] projected and added to x
    [B, 1, d], then the feed-forward (an MoE on route ``impl``; its aux
    loss discarded)."""
    x = x + o.reshape(x.shape[0], 1, -1) @ p["attn"]["wo"]
    return x + _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps), impl)[0]


def _dense_decode_attention(cfg: LMConfig, q, k_cache, v_cache, lengths,
                            window: int) -> torch.Tensor:
    """q [B, H, D] over k/v_cache [B, KVH, S, D]: keys up to and including
    position ``lengths`` (the new token), in float32."""
    B, H, D = q.shape
    KVH = k_cache.shape[1]
    qg = q.float().reshape(B, KVH, H // KVH, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, k_cache.float()) \
        * cfg.head_dim ** -0.5
    if cfg.attn_softcap > 0:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    ki = torch.arange(k_cache.shape[2], device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = ki < lens + 1
    if window > 0:
        mask &= ki > lens - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    o = torch.einsum("bhgs,bhsd->bhgd", torch.softmax(s, dim=-1),
                     v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def serve_step(params: Params, cfg: LMConfig, cache: Dict[str, torch.Tensor],
               tokens: torch.Tensor):
    """One decode step over the dense cache (plain torch, the reference):
    tokens [B, 1] -> (logits [B, vocab], new cache).  The cache passed in is
    not modified."""
    check_single_card(cfg)
    lengths = cache["lengths"]
    k_all, v_all = cache["k"].clone(), cache["v"].clone()
    b_idx = torch.arange(tokens.shape[0], device=tokens.device)
    pos = lengths.long()
    x = embed(params, cfg, tokens)
    for li, (lp, window) in enumerate(zip(params["layers"],
                                          cfg.layer_windows)):
        q, k, v = _decode_qkv(lp, cfg, x, lengths)
        k_all[li, b_idx, :, pos] = k
        v_all[li, b_idx, :, pos] = v
        o = _dense_decode_attention(cfg, q, k_all[li], v_all[li], lengths,
                                    window)
        x = _decode_out(lp, cfg, x, o, "torch")
    return _head(params, cfg, x[:, 0]), {"k": k_all, "v": v_all,
                                         "lengths": lengths + 1}


def serve_step_paged(params: Params, cfg: LMConfig,
                     caches: List[kvcache.PagedKVCache], tokens: torch.Tensor,
                     *, impl: str = "cuda", inplace: bool = False):
    """One decode step over the paged caches (one per layer): tokens [B, 1]
    -> (logits [B, vocab], new caches).  Each layer appends the token's K/V
    to its chains (``kvcache.append``) and attends over them
    (``kvcache.attend``, the paged kernel with ``impl="cuda"``); an MoE
    layer's dispatch and combine take the same ``impl``.  With ``inplace``
    the caches' pools are written in place.  On the kernel route the step
    reads nothing back from the device, so it can be captured in a CUDA
    graph."""
    check_single_card(cfg)
    x = embed(params, cfg, tokens)
    out = []
    for lp, window, cache in zip(params["layers"], cfg.layer_windows,
                                 caches):
        q, k, v = _decode_qkv(lp, cfg, x, cache.lengths)
        cache = kvcache.append(cache, k, v, inplace=inplace)
        o = kvcache.attend(cache, q, scale=cfg.head_dim ** -0.5,
                           window=window, softcap=cfg.attn_softcap,
                           impl=impl)
        x = _decode_out(lp, cfg, x, o, impl)
        out.append(cache)
    return _head(params, cfg, x[:, 0]), out
