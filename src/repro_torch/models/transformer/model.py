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
from repro_torch.launch.mesh import spmd_mesh
from repro_torch.models.transformer import kvcache
from repro_torch.models.transformer.layers import (LMConfig, Params,
                                                   _batch_axes, _ffn,
                                                   _partial_over,
                                                   _placements, _wsc,
                                                   apply_layer,
                                                   fsdp_gathered,
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
    x = F.embedding(tokens.long(), params["embed"])
    if spmd_mesh(cfg) is not None:
        # the table's columns lie over "model": the rows come out in blocks
        # of d, gathered here so the residual stream is whole on "model"
        x = _wsc(x, (_batch_axes(cfg, x.shape[0]), None, None))
    return x * scale


def _head(params: Params, cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    head = params["lm_head"]
    if spmd_mesh(cfg) is not None:
        head = fsdp_gathered(head, cfg)
    logits = (rmsnorm(params["ln_f"], x, cfg.norm_eps) @ head).float()
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
    mesh = spmd_mesh(cfg)
    if mesh is not None:
        # the rows over the batch axes, the vocabulary over "model"
        logits = _wsc(logits, (_batch_axes(cfg, logits.shape[0]), None,
                               "model"))
    logz = torch.logsumexp(logits, dim=-1)
    mask = labels >= 0
    ll = (_label_logits(logits, labels, cfg, mesh) if mesh is not None
          else logits.gather(-1, labels.long().clamp(min=0)[..., None])
          [..., 0])
    nll = torch.where(mask, logz - ll, 0.0).sum() \
        / mask.sum().clamp(min=1)
    return nll + 0.01 * aux


def _label_logits(logits, labels, cfg: LMConfig, mesh):
    """Each position's logit at its label (a negative label reads column
    0) from vocabulary-parallel DTensor logits: every rank picks the
    labels inside its block of columns in ``local_map`` and the picks add
    over ``"model"``."""
    from torch.distributed.tensor.experimental import local_map

    def pick(lg, lab):
        width = lg.shape[-1]
        i = lab.long().clamp(min=0) - mesh.get_local_rank("model") * width
        inside = (i >= 0) & (i < width)
        got = lg.gather(-1, i.clamp(0, width - 1)[..., None])[..., 0]
        return torch.where(inside, got, 0.0)

    ba = _batch_axes(cfg, logits.shape[0])
    rows = _placements(mesh, (ba, None))
    ll = local_map(pick, out_placements=list(_partial_over(
                       mesh, (ba, None), ("model",))),
                   in_placements=(logits.placements, rows),
                   in_grad_placements=(logits.placements, rows),
                   device_mesh=mesh)(logits, labels.redistribute(mesh, rows))
    return ll.redistribute(mesh, rows)


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
    mesh = spmd_mesh(cfg)
    positions = _positions(tokens)
    x = embed(params, cfg, tokens)
    lengths = torch.full((B,), S, dtype=torch.int32, device=x.device)
    if mesh is not None:
        # DTensor entries, stacked at the end; no activation constraint,
        # as in the JAX package's prefill
        ks, vs = [], []
        for lp, window in zip(params["layers"], cfg.layer_windows):
            x, k, v, _ = apply_layer(lp, cfg, x, positions, window, impl,
                                     constrain=False)
            ks.append(k)
            vs.append(v)
        return _head(params, cfg, x[:, -1]), {
            "k": torch.stack(ks), "v": torch.stack(vs),
            "lengths": _replicated(lengths, mesh)}
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
    return logits, {"k": k_cache, "v": v_cache, "lengths": lengths}


def _replicated(x: torch.Tensor, mesh):
    """A DTensor replica of ``x``, which every rank holds alike."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


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
    not modified.  Under a mesh the cache and the tokens are DTensors (the
    registry's decode cells place the cache's batch over the batch axes
    and its positions over ``"model"``): :func:`_decode_attention_spmd`."""
    mesh = spmd_mesh(cfg)
    if mesh is not None:
        return _serve_step_spmd(params, cfg, cache, tokens, mesh)
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


def _decode_attention_spmd(cfg: LMConfig, q, k, v, k_all, v_all,
                           li: int, lengths, window: int, mesh):
    """Layer ``li`` of a decode step over the DTensor cache k/v_all [L, B,
    KVH, S, D], in place on each rank's block: the token's k, v [B, 1,
    heads * D] written at position ``lengths``, then attention over the
    block's keys.  Where the cache's positions lie over mesh axes, each
    rank's softmax statistics are merged across them (a max, then sums of
    the weights and the weighted values: the LSE merge).  Returns o [B,
    H, D] as a DTensor with the cache's batch placement."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    cache_pl = k_all.placements
    rows = [Shard(0) if p == Shard(1) else Replicate() for p in cache_pl]
    seq_dims = [i for i, p in enumerate(cache_pl) if p == Shard(3)]
    _, off = compute_local_shape_and_global_offset(k_all.shape, mesh,
                                                   cache_pl)
    s_off = off[3]

    def local(t):
        return t.redistribute(mesh, rows).to_local()

    B = lengths.shape[0]
    H, KVH, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lens = local(lengths).long()
    Bl = lens.shape[0]
    pos = lens[:, None, None]
    q = rope(local(q).view(Bl, 1, H, D).transpose(1, 2), pos,
             cfg.rope_theta)[:, :, 0]
    k = rope(local(k).view(Bl, 1, KVH, D).transpose(1, 2), pos,
             cfg.rope_theta)[:, :, 0]
    v = local(v).view(Bl, KVH, D)
    kl, vl = k_all.to_local()[li], v_all.to_local()[li]
    S_loc = kl.shape[2]
    at = (lens - s_off).clamp(0, S_loc - 1)
    hit = ((lens >= s_off) & (lens < s_off + S_loc))[:, None, None]
    b = torch.arange(Bl, device=lens.device)
    kl[b, :, at] = torch.where(hit, k, kl[b, :, at])
    vl[b, :, at] = torch.where(hit, v, vl[b, :, at])
    qg = q.float().reshape(Bl, KVH, H // KVH, D)
    s = torch.einsum("bhgd,bhsd->bhgs", qg, kl.float()) \
        * cfg.head_dim ** -0.5
    if cfg.attn_softcap > 0:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    ki = torch.arange(S_loc, device=lens.device)[None, :] + s_off
    mask = ki < lens[:, None] + 1
    if window > 0:
        mask &= ki > lens[:, None] - window
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    top = s.amax(dim=-1, keepdim=True)
    for i in seq_dims:
        top = funcol.all_reduce(top, "max", (mesh, i))
    w = torch.exp(s - top)
    den = w.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhgs,bhsd->bhgd", w, vl.float())
    for i in seq_dims:
        den = funcol.all_reduce(den, "sum", (mesh, i))
        o = funcol.all_reduce(o, "sum", (mesh, i))
    o = (o / den).reshape(Bl, H, D).to(kl.dtype)
    return DTensor.from_local(o, mesh, rows, run_check=False,
                              shape=(B, H, D),
                              stride=(H * D, D, 1))


def _serve_step_spmd(params: Params, cfg: LMConfig, cache, tokens, mesh):
    """:func:`serve_step` on DTensors: the projections, the MoE and the
    head in DTensor land, each layer's cache write and attention on the
    ranks' blocks (:func:`_decode_attention_spmd`); no activation
    constraint, as in the JAX package's decode."""
    lengths = cache["lengths"]
    k_all, v_all = cache["k"].clone(), cache["v"].clone()
    x = embed(params, cfg, tokens)
    for li, (lp, window) in enumerate(zip(params["layers"],
                                          cfg.layer_windows)):
        lp = fsdp_gathered(lp, cfg)
        o = _decode_layer_attention_spmd(lp, cfg, x, k_all, v_all, li,
                                         lengths, window, mesh)
        x = _decode_out(lp, cfg, x, o, "torch")
    return _head(params, cfg, x[:, 0]), {"k": k_all, "v": v_all,
                                         "lengths": lengths + 1}


def _decode_layer_attention_spmd(lp: Params, cfg: LMConfig, x, k_all, v_all,
                                 li: int, lengths, window: int, mesh):
    """Layer ``li``'s attention of a decode step on DTensors, before its
    output projection: the normed x [B, 1, d] projected, then
    :func:`_decode_attention_spmd` (the cache written in place).  ``lp``
    is the layer's parameters with their FSDP dims gathered."""
    z = rmsnorm(lp["ln1"], x, cfg.norm_eps)
    p = lp["attn"]
    q, k, v = z @ p["wq"], z @ p["wk"], z @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return _decode_attention_spmd(cfg, q, k, v, k_all, v_all, li, lengths,
                                  window, mesh)


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
    graph.  It runs on one card: the JAX package decodes over pages on one
    device only, so a config with SPMD fields is refused."""
    if cfg.act_shard_axes is not None or cfg.ep_shard_map:
        raise ValueError(
            f"{cfg.name}: the paged route runs on one card (the JAX "
            f"package has no paged decode under a mesh); act_shard_axes="
            f"{cfg.act_shard_axes!r} / ep_shard_map={cfg.ep_shard_map} ask "
            f"for one: decode it with serve_step over the dense cache")
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
