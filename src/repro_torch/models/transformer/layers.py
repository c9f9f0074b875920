"""Transformer building blocks: RMSNorm, RoPE, GQA attention (local /
global, softcap, bias) and the SwiGLU MLP, as in
``repro.models.transformer.layers``.

Parameters are nested dicts of tensors and every ``apply_*`` is a plain
function of them, so the JAX package's parameter trees carry over one to one
(``interop.lm_params_from_jax``).  ``RMSNorm``, ``Attention``, ``MLP`` and
``DecoderLayer`` are ``nn.Module`` views of the same dicts.  The attention
``impl`` is the port's switch: ``"cuda"`` goes through the flash kernel
(its plain version for CPU tensors), ``"torch"`` through the plain version.

Not in this slice: MoE (``init_moe`` / ``apply_moe`` / ``apply_moe_ep``) and
the ``act_shard_axes`` sharding constraints.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.flash_attention import attention as flash_attention

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0                      # 0 -> d_model // n_heads
    qkv_bias: bool = False
    window_pattern: Tuple[int, ...] = (0,)   # per-layer window, 0 = global,
    # repeated cyclically over the layers (Gemma-2: (4096, 0))
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    kv_page_size: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def layer_windows(self) -> Tuple[int, ...]:
        p = self.window_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def period(self) -> int:
        return len(self.window_pattern)


# ---------------------------------------------------------------------------
# init: bf16 (or the config's type) straight from a torch.Generator
# ---------------------------------------------------------------------------

def _dense(gen, shape, dtype, device, scale=None) -> torch.Tensor:
    scale = scale if scale is not None else shape[0] ** -0.5
    return torch.randn(shape, generator=gen, dtype=dtype,
                       device=device).mul_(scale)


def init_rmsnorm(d: int, device) -> Params:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def init_attention(gen, cfg: LMConfig, device) -> Params:
    d, h, kvh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _dense(gen, (d, h * dh), cfg.dtype, device),
         "wk": _dense(gen, (d, kvh * dh), cfg.dtype, device),
         "wv": _dense(gen, (d, kvh * dh), cfg.dtype, device),
         "wo": _dense(gen, (h * dh, d), cfg.dtype, device)}
    if cfg.qkv_bias:
        for name, width in (("bq", h * dh), ("bk", kvh * dh),
                            ("bv", kvh * dh)):
            p[name] = torch.zeros((width,), dtype=cfg.dtype, device=device)
    return p


def init_mlp(gen, cfg: LMConfig, device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {"wi": _dense(gen, (d, f), cfg.dtype, device),
            "wg": _dense(gen, (d, f), cfg.dtype, device),
            "wo": _dense(gen, (f, d), cfg.dtype, device)}


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def rmsnorm(p: Params, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [..., S, D]; positions broadcastable to [..., S]; in float32, then
    cast back to x's type."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions[..., None].float() * freqs
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos],
                     dim=-1).to(x.dtype)


def qkv_proj(p: Params, cfg: LMConfig, x: torch.Tensor):
    """x [B, S, d] -> q [B, H, S, D], k, v [B, KVH, S, D] (views of the
    [B, S, heads, D] products, not copies)."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    dh = cfg.head_dim
    return (q.view(B, S, cfg.n_heads, dh).transpose(1, 2),
            k.view(B, S, cfg.n_kv_heads, dh).transpose(1, 2),
            v.view(B, S, cfg.n_kv_heads, dh).transpose(1, 2))


def attention_inputs(p: Params, cfg: LMConfig, x: torch.Tensor,
                     positions: torch.Tensor):
    """q [B, H, S, D], k, v [B, KVH, S, D] of x [B, S, d], q and k after
    RoPE at ``positions`` [B, S]."""
    q, k, v = qkv_proj(p, cfg, x)
    pos = positions[:, None, :]
    return rope(q, pos, cfg.rope_theta), rope(k, pos, cfg.rope_theta), v


def attention_with_kv(p: Params, cfg: LMConfig, x: torch.Tensor,
                      positions: torch.Tensor, window: int,
                      impl: str = "cuda"):
    """Causal self-attention over [B, S, d]: (out [B, S, d], k, v) with k
    after RoPE — the prefill cache entries [B, KVH, S, D]."""
    B, S, _ = x.shape
    q, k, v = attention_inputs(p, cfg, x, positions)
    o = flash_attention(q, k, v, scale=cfg.head_dim ** -0.5, causal=True,
                        window=window, softcap=cfg.attn_softcap, impl=impl)
    return o.transpose(1, 2).reshape(B, S, -1) @ p["wo"], k, v


def apply_attention(p: Params, cfg: LMConfig, x: torch.Tensor,
                    positions: torch.Tensor, window: int,
                    impl: str = "cuda") -> torch.Tensor:
    """Causal self-attention over [B, S, d] (train / prefill path)."""
    return attention_with_kv(p, cfg, x, positions, window, impl)[0]


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; the [.., d_ff] intermediates are updated in place (they are
    this function's own), which halves their peak memory at prefill."""
    h = F.silu(x @ p["wg"], inplace=True)
    return h.mul_(x @ p["wi"]) @ p["wo"]


def apply_layer(p: Params, cfg: LMConfig, x: torch.Tensor,
                positions: torch.Tensor, window: int, impl: str = "cuda"):
    """One pre-norm decoder layer over [B, S, d]: (x', k, v)."""
    h, k, v = attention_with_kv(p["attn"], cfg,
                                rmsnorm(p["ln1"], x, cfg.norm_eps),
                                positions, window, impl)
    x = x + h
    return x + apply_mlp(p["mlp"], rmsnorm(p["ln2"], x, cfg.norm_eps)), k, v


# ---------------------------------------------------------------------------
# nn.Module views of the parameter dicts
# ---------------------------------------------------------------------------

class ParamTree(nn.Module):
    """A parameter dict held as frozen ``nn.Parameter``s (nested dicts as
    submodules); :meth:`tree` gives the dict back, sharing storage."""

    def __init__(self, params: Params):
        super().__init__()
        for name, value in params.items():
            if isinstance(value, dict):
                self.add_module(name, ParamTree(value))
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def tree(self) -> Params:
        out: Params = dict(self.named_parameters(recurse=False))
        out.update((n, m.tree()) for n, m in self.named_children())
        return out


class RMSNorm(ParamTree):
    def __init__(self, params: Params, eps: float):
        super().__init__(params)
        self.eps = eps

    def forward(self, x):
        return rmsnorm(self.tree(), x, self.eps)


class Attention(ParamTree):
    def __init__(self, cfg: LMConfig, params: Params):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, positions, window: int, impl: str = "cuda"):
        return apply_attention(self.tree(), self.cfg, x, positions, window,
                               impl)


class MLP(ParamTree):
    def forward(self, x):
        return apply_mlp(self.tree(), x)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LMConfig, params: Params, window: int):
        super().__init__()
        self.ln1 = RMSNorm(params["ln1"], cfg.norm_eps)
        self.attn = Attention(cfg, params["attn"])
        self.ln2 = RMSNorm(params["ln2"], cfg.norm_eps)
        self.mlp = MLP(params["mlp"])
        self.window = window

    def forward(self, x, positions, impl: str = "cuda"):
        x = x + self.attn(self.ln1(x), positions, self.window, impl)
        return x + self.mlp(self.ln2(x))
