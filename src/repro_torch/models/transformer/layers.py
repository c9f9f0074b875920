"""Transformer building blocks: RMSNorm, RoPE, GQA attention (local /
global, softcap, bias), the SwiGLU MLP and the capacity-bucket MoE with
top-k routing, as in ``repro.models.transformer.layers``.

Parameters are nested dicts of tensors and every ``apply_*`` is a plain
function of them, so the JAX package's parameter trees carry over one to one
(``interop.lm_params_from_jax``).  ``RMSNorm``, ``Attention``, ``MLP``,
``MoE`` and ``DecoderLayer`` are ``nn.Module`` views of the same dicts.  The
``impl`` is the port's switch: ``"cuda"`` goes through the kernels (their
plain versions for CPU tensors), ``"torch"`` through the plain versions.

The MoE's token -> expert dispatch is a gather of token rows at ids the
routing decides, and its combine a sum by token: on the kernel route both
run on ``block_gather`` and ``segment_sum`` over a :class:`TokenPlan` built
once a layer call, as the GNNs' edges run over ``models/plan.py``.

The config carries the JAX package's SPMD fields (``act_shard_axes``,
``model_axis_size``, ``data_axis_size``, ``ep_shard_map``), which the
registry's ``opt`` cells set.  Their activation constraints and
``apply_moe_ep`` need the shard axis across cards (ROADMAP.md, queue 1
item 8.4), so every entry point refuses a config that sets them
(:func:`check_single_card`) rather than run the one-card path in their
place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.backend import resolve_impl
from repro_torch.kernels.block_gather.ops import gather_rows
from repro_torch.kernels.flash_attention import attention as flash_attention
from repro_torch.kernels.segment_matmul.ops import (csr_items_per_cta,
                                                    segment_sum_csr)

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
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    qkv_bias: bool = False
    window_pattern: Tuple[int, ...] = (0,)   # per-layer window, 0 = global,
    # repeated cyclically over the layers (Gemma-2: (4096, 0))
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    kv_page_size: int = 128
    # the JAX package's beyond-paper SPMD fields: the mesh's batch axes
    # (("data",) or ("pod", "data")) that pin activation shardings, the
    # axis sizes, and the shard_map MoE dispatch
    act_shard_axes: Any = None
    model_axis_size: int = 16
    data_axis_size: int = 16          # product of act_shard_axes sizes
    ep_shard_map: bool = False

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


def init_mlp(gen, cfg: LMConfig, device, d_ff: Optional[int] = None
             ) -> Params:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {"wi": _dense(gen, (d, f), cfg.dtype, device),
            "wg": _dense(gen, (d, f), cfg.dtype, device),
            "wo": _dense(gen, (f, d), cfg.dtype, device)}


def init_moe(gen, cfg: LMConfig, device) -> Params:
    """A float32 router [d, E], experts ``wi`` / ``wg`` [E, d, f] and
    ``wo`` [E, f, d] (scaled by E^-1/2 as the JAX package's ``_dense``
    scales by the first axis), and the shared expert when asked for."""
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": _dense(gen, (d, e), torch.float32, device),
         "wi": _dense(gen, (e, d, f), cfg.dtype, device),
         "wg": _dense(gen, (e, d, f), cfg.dtype, device),
         "wo": _dense(gen, (e, f, d), cfg.dtype, device)}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device,
                               cfg.d_ff * cfg.n_shared_experts)
    return p


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


# ---------------------------------------------------------------------------
# MoE: top-k routing into capacity buckets
# ---------------------------------------------------------------------------

def check_single_card(cfg: LMConfig) -> None:
    """Refuse a config whose SPMD fields ask for activation constraints or
    the expert-parallel dispatch: the port runs neither yet."""
    if cfg.act_shard_axes is not None or cfg.ep_shard_map:
        raise NotImplementedError(
            f"{cfg.name}: act_shard_axes={cfg.act_shard_axes!r} / "
            f"ep_shard_map={cfg.ep_shard_map} shard activations and the MoE "
            f"dispatch across cards (apply_moe_ep), which the port does not "
            f"run yet; see ROADMAP.md, queue 1 item 8.4")


def capacity(cfg: LMConfig, T: int) -> int:
    """Slots an expert per call of T tokens (GShard: overflow drops, the
    residual passes through); ``capacity_factor >= E / K`` is dropless."""
    return min(T, int(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
               + 1)


def route(p: Params, cfg: LMConfig, xf: torch.Tensor):
    """Float32 routing of the tokens xf [T, d]: (gate [T, K] renormalised
    over the top K, expert ids [T, K], the Switch aux loss
    E * sum_e f_e * P_e)."""
    T, E, K = xf.shape[0], cfg.n_experts, cfg.top_k
    probs = torch.softmax(xf @ p["router"], dim=-1)
    gate, eidx = torch.topk(probs, K, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    # the lanes an expert takes, counted in float32 (exact below 2^24
    # lanes) with no read of the device from the host, which ``bincount``
    # makes on the card and a CUDA graph's capture forbids
    ce = xf.new_zeros(E).index_add_(0, eidx.reshape(-1),
                                    xf.new_ones(T * K)) / (T * K)
    return gate, eidx, E * torch.sum(probs.mean(dim=0) * ce)


@dataclasses.dataclass(eq=False)
class TokenPlan:
    """One MoE call's routing laid out for the kernels.

    A lane is one (token, choice) pair, lane ``t * K + k`` in token-major
    order.  Sorted by expert (stable, so by token within an expert, as
    ``jnp.argsort`` sorts), a lane's rank within its expert decides whether
    it keeps a slot of its expert's ``C``: ``order`` is the sort's
    permutation, ``keep`` and ``slot`` (``E * C`` when dropped) are in that
    order.  For the kernels: ``slot_of_lane`` (token-major; ``E * C``, the
    zero row, when dropped), ``tok_of_slot`` (``T``, the zero row, for an
    empty slot) and ``row_ptr`` (token ``t``'s lanes, ``K`` a token).  All
    int32 but ``order`` and ``keep``.  Building a plan and summing over it
    read nothing back from the device, so a decode step that routes its
    tokens can be captured in a CUDA graph.
    """
    T: int
    K: int
    E: int
    C: int
    order: torch.Tensor               # i64[T * K]
    keep: torch.Tensor                # bool[T * K], expert order
    slot: torch.Tensor                # i32[T * K], expert order
    slot_of_lane: torch.Tensor        # i32[T * K], token-major
    tok_of_slot: torch.Tensor         # i32[E * C]
    row_ptr: torch.Tensor             # i32[T + 1]
    _parts: Dict = dataclasses.field(default_factory=dict)

    def partition(self, F: int) -> torch.Tensor:
        """The merge-path partition of the lanes by token at width F:
        ``merge_path_partition(row_ptr, csr_items_per_cta(F))``, made from
        the host ints (T, K) alone.  Row r's end on the merge path is
        ``row_ptr[r + 1] + r + 1 = (r + 1)(K + 1)``, so diagonal d splits
        after ``min(d // (K + 1), T)`` rows."""
        key = csr_items_per_cta(F)
        if key not in self._parts:
            total = self.T * (self.K + 1)
            diag = (torch.arange(-(-total // key) + 1, dtype=torch.int64,
                                 device=self.row_ptr.device)
                    * key).clamp_(max=total)
            rows = torch.div(diag, self.K + 1,
                             rounding_mode="floor").clamp_(max=self.T)
            self._parts[key] = torch.stack([rows, diag - rows],
                                           dim=1).to(torch.int32)
        return self._parts[key]

    def sum_by_token(self, lanes: torch.Tensor) -> torch.Tensor:
        """f32[T, F]: the token-major lanes [T * K, F] (float32) summed by
        token on ``segment_sum``."""
        return segment_sum_csr(lanes, self.row_ptr,
                               self.partition(lanes.shape[1]))


def token_plan(eidx: torch.Tensor, C: int, E: int) -> TokenPlan:
    """The plan of the expert ids eidx [T, K] at capacity C."""
    T, K = eidx.shape
    dev = eidx.device
    se, order = torch.sort(eidx.reshape(-1), stable=True)
    # where each expert's lanes start in the sorted ids (no host read)
    estart = torch.searchsorted(se, torch.arange(E, dtype=se.dtype,
                                                 device=dev))
    rank = torch.arange(T * K, device=dev) - estart[se]
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)
    slot_of_lane = torch.empty_like(slot)
    slot_of_lane[order] = slot
    tok_of_slot = torch.full((E * C + 1,), T, dtype=torch.int64, device=dev)
    tok_of_slot[slot] = order // K          # dropped lanes write row E * C
    i32 = torch.int32
    return TokenPlan(T=T, K=K, E=E, C=C, order=order, keep=keep,
                     slot=slot.to(i32), slot_of_lane=slot_of_lane.to(i32),
                     tok_of_slot=tok_of_slot[:E * C].to(i32).contiguous(),
                     row_ptr=torch.arange(T + 1, dtype=i32, device=dev) * K)


def _rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` on ``block_gather`` with the zero row ``table[R]``
    appended: a row is bytes, so a bf16 table is gathered as float32 pairs,
    exactly."""
    table = torch.cat([table, table.new_zeros((1, table.shape[1]))])
    if table.dtype == torch.float32:
        return gather_rows(table, ids, rows_per_step=1)
    if table.element_size() != 2 or table.shape[1] % 2:
        raise TypeError(f"the MoE gathers take float32, or 2-byte rows of "
                        f"even width, got {table.dtype} [.., "
                        f"{table.shape[1]}]")
    return gather_rows(table.view(torch.float32), ids,
                       rows_per_step=1).view(table.dtype)


class _Dispatch(torch.autograd.Function):
    """Bucket slot s holds token ``tok_of_slot[s]``'s row (an empty slot the
    zero row).  Backward: the slots' gradients gathered in token-major lane
    order and summed by token in float32, rounded once."""

    @staticmethod
    def forward(ctx, xt, plan):
        ctx.plan = plan
        return _rows(xt, plan.tok_of_slot)

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        lanes = _rows(grad, plan.slot_of_lane).float()
        return plan.sum_by_token(lanes).to(grad.dtype), None


class _Combine(torch.autograd.Function):
    """f32 y[t] = sum_k gate[t, k] * yb[slot(t, k)] (a dropped lane reads
    the zero row): the rows gathered in token-major lane order, scaled in
    float32 and summed by token (in float64 on the card, rounded once).
    Backward: the token gradients gathered into the slots
    (``tok_of_slot``) and scaled by each slot's gate; the gate's gradient a
    dot product of each lane's row with its token's gradient."""

    @staticmethod
    def forward(ctx, yb, gate, plan):
        lanes = _rows(yb, plan.slot_of_lane)
        ctx.plan = plan
        ctx.save_for_backward(lanes, gate)
        return plan.sum_by_token(lanes.float() * gate[:, None])

    @staticmethod
    def backward(ctx, grad):
        plan = ctx.plan
        lanes, gate = ctx.saved_tensors
        grad = grad.contiguous()
        d_yb = d_gate = None
        if ctx.needs_input_grad[0]:
            gate_of_slot = gate.new_zeros(plan.E * plan.C + 1)
            gate_of_slot[plan.slot_of_lane.long()] = gate
            d_yb = (_rows(grad, plan.tok_of_slot)
                    * gate_of_slot[:-1, None]).to(lanes.dtype)
        if ctx.needs_input_grad[1]:
            d_gate = (lanes.view(plan.T, plan.K, -1).float()
                      * grad[:, None]).sum(-1).reshape(-1)
        return d_yb, d_gate, None


def _experts(p: Params, xb: torch.Tensor) -> torch.Tensor:
    """SwiGLU of every expert over its bucket: xb [E, C, d] -> [E, C, d]."""
    return (F.silu(torch.bmm(xb, p["wg"])) * torch.bmm(xb, p["wi"])) \
        @ p["wo"]


def apply_moe(p: Params, cfg: LMConfig, x: torch.Tensor,
              impl: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux loss).  Float32 routing and the
    sorted capacity-bucket dispatch of the reference.  The combine scales
    each kept row by its gate in float32, sums by token in float64 (the
    ``segment_sum`` kernel's accumulator) and rounds once, to float32 and
    then the model's type, where the JAX package adds in the model's type.
    ``impl="torch"``: plain indexing and ``index_add``; ``"cuda"``: the
    dispatch and combine on the graph kernels over one
    :class:`TokenPlan`."""
    check_single_card(cfg)
    B, S, d = x.shape
    E, T = cfg.n_experts, B * S
    C = capacity(cfg, T)
    xt = x.reshape(T, d)
    gate, eidx, aux = route(p, cfg, xt.float())
    plan = token_plan(eidx, C, E)
    if resolve_impl(impl) == "torch":
        # on meta tensors (the dry run) a mask holds no count: every lane
        # is taken, the padded capacity the JAX package compiles
        keep = slice(None) if x.device.type == "meta" else plan.keep
        st = plan.order[keep] // cfg.top_k
        slots = plan.slot[keep].long()
        # a token's bucket gradients sum in float32 and round once, as the
        # kernel route's do, before they meet the router's
        xb = x.new_zeros((E * C, d))
        xb[slots] = xt.float()[st].to(x.dtype)
        yb = _experts(p, xb.view(E, C, d)).reshape(E * C, d)
        contrib = yb[slots].float() * gate.reshape(-1)[plan.order[keep],
                                                       None]
        y = torch.zeros((T, d), dtype=torch.float64, device=x.device) \
            .index_add(0, st, contrib.double()).float()
    else:
        xb = _Dispatch.apply(xt.contiguous(), plan)
        yb = _experts(p, xb.view(E, C, d)).reshape(E * C, d)
        y = _Combine.apply(yb, gate.reshape(-1).contiguous(), plan)
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + apply_mlp(p["shared"], xt)
    return y.view(B, S, d), aux


def _ffn(p: Params, cfg: LMConfig, z: torch.Tensor, impl: str = "cuda"):
    """The layer's feed-forward: (y, aux), the MoE or the dense MLP (aux
    0)."""
    if cfg.moe:
        return apply_moe(p["moe"], cfg, z, impl)
    return apply_mlp(p["mlp"], z), torch.zeros((), device=z.device)


def apply_layer(p: Params, cfg: LMConfig, x: torch.Tensor,
                positions: torch.Tensor, window: int, impl: str = "cuda",
                attn_impl: Optional[str] = None):
    """One pre-norm decoder layer over [B, S, d]: (x', k, v, aux).
    Attention takes ``attn_impl`` (``impl`` when None), the MoE ``impl``."""
    check_single_card(cfg)
    h, k, v = attention_with_kv(p["attn"], cfg,
                                rmsnorm(p["ln1"], x, cfg.norm_eps),
                                positions, window, attn_impl or impl)
    x = x + h
    y, aux = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps), impl)
    return x + y, k, v, aux


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


class MoE(ParamTree):
    def __init__(self, cfg: LMConfig, params: Params):
        super().__init__(params)
        self.cfg = cfg

    def forward(self, x, impl: str = "cuda"):
        """(y, aux loss)."""
        return apply_moe(self.tree(), self.cfg, x, impl)


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LMConfig, params: Params, window: int):
        super().__init__()
        self.ln1 = RMSNorm(params["ln1"], cfg.norm_eps)
        self.attn = Attention(cfg, params["attn"])
        self.ln2 = RMSNorm(params["ln2"], cfg.norm_eps)
        if cfg.moe:
            self.moe = MoE(cfg, params["moe"])
        else:
            self.mlp = MLP(params["mlp"])
        self.window = window

    def forward(self, x, positions, impl: str = "cuda"):
        x = x + self.attn(self.ln1(x), positions, self.window, impl)
        z = self.ln2(x)
        return x + (self.moe(z, impl)[0] if hasattr(self, "moe")
                    else self.mlp(z))
