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
registry's ``opt`` cells set.  A config that sets them runs on DTensors
under the ambient mesh of ``launch.mesh.use_mesh``, which must name those
axes at those sizes (``launch.mesh.spmd_mesh`` raises ValueError
otherwise): DTensor plays GSPMD's part.  :func:`_wsc` is
``with_sharding_constraint`` (a redistribute to the spec's placements) at
the JAX package's points, head-parallel or context-parallel attention on
the training path; every kernel call and every op that needs its rank's
block (RoPE's positions, the KV heads of a rank's q heads) runs inside
``local_map``.  :func:`apply_moe_ep` is the expert-parallel MoE: each data
shard routes its own tokens into its own buckets, the experts' products
run with the experts over ``"model"``, and each (data, model) rank's
combine leaves a partial sum over ``"model"`` that a redistribute adds.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.backend import resolve_impl
from repro_torch.kernels.block_gather.ops import gather_rows
from repro_torch.kernels.flash_attention import attention as flash_attention
from repro_torch.kernels.flash_attention import attention_ref
from repro_torch.kernels.segment_matmul.ops import (csr_items_per_cta,
                                                    segment_sum_csr)
from repro_torch.launch.mesh import spmd_mesh

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
                      impl: str = "cuda", constrain: bool = False):
    """Causal self-attention over [B, S, d]: (out [B, S, d], k, v) with k
    after RoPE — the prefill cache entries [B, KVH, S, D].  Under a mesh
    (:func:`_attention_spmd`) ``constrain`` pins the activations as the
    JAX package's ``apply_attention`` does; its prefill pins none."""
    mesh = spmd_mesh(cfg)
    if mesh is not None:
        return _attention_spmd(p, cfg, x, window, impl, mesh, constrain)
    B, S, _ = x.shape
    q, k, v = attention_inputs(p, cfg, x, positions)
    o = flash_attention(q, k, v, scale=cfg.head_dim ** -0.5, causal=True,
                        window=window, softcap=cfg.attn_softcap, impl=impl)
    return o.transpose(1, 2).reshape(B, S, -1) @ p["wo"], k, v


def apply_attention(p: Params, cfg: LMConfig, x: torch.Tensor,
                    positions: torch.Tensor, window: int,
                    impl: str = "cuda") -> torch.Tensor:
    """Causal self-attention over [B, S, d] (train / prefill path)."""
    return attention_with_kv(p, cfg, x, positions, window, impl,
                             constrain=True)[0]


# ---------------------------------------------------------------------------
# SPMD: DTensors under the ambient mesh, the activation constraints
# ---------------------------------------------------------------------------

def _placements(mesh, spec) -> tuple:
    from repro_torch.distributed.sharding import placements
    return placements(mesh, spec)


def _partial_over(mesh, spec, axes) -> tuple:
    """``spec``'s placements with ``Partial()`` on the mesh dims of
    ``axes``: the gradient placements of a ``local_map`` input whose local
    gradient holds only its rank's share (summed over those axes)."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if name in axes else pl for name, pl in
                 zip(mesh.mesh_dim_names, _placements(mesh, spec)))


def _wsc(x, spec):
    """``with_sharding_constraint``: the DTensor ``x`` redistributed to
    ``spec``'s placements on its mesh."""
    return x.redistribute(x.device_mesh, _placements(x.device_mesh, spec))


def fsdp_gathered(tree, cfg: LMConfig):
    """The DTensor weights of ``tree`` with their FSDP dims gathered
    (replicas over the batch axes, their ``"model"`` blocks kept), as FSDP
    runs a layer: its products then split by the activations' rows, and
    the gradients reduce-scatter back.  GSPMD gathers the same way."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch import tree as T
    batch = set(cfg.act_shard_axes)

    def one(w):
        if not isinstance(w, DTensor):
            return w
        names = w.device_mesh.mesh_dim_names
        return w.redistribute(w.device_mesh, [
            Replicate() if n in batch else p
            for n, p in zip(names, w.placements)])
    return T.tree_map(one, tree)


def _batch_axes(cfg: LMConfig, rows: int):
    """The axes ``rows`` batch rows lie over: the config's batch axes, or
    none when the rows do not split over them (one long-context row)."""
    if rows % cfg.data_axis_size:
        return None
    return tuple(cfg.act_shard_axes)


def _heads(y, n: int, dh: int, spec):
    """y [B, S, n * dh] redistributed to ``spec`` (each rank's columns
    whole heads, or every column) and split into heads: [B, n, S, dh]."""
    B, S, _ = y.shape
    return _wsc(y, spec).view(B, S, n, dh).transpose(1, 2)


def _kv_heads_of(cfg: LMConfig, h0: int, n: int):
    """The KV heads q heads ``h0 .. h0 + n - 1`` read: a slice when the
    grouping maps them onto it (each of its heads serving ``n / width``
    consecutive q heads), else one KV head id per q head."""
    G = cfg.n_heads // cfg.n_kv_heads
    ids = [(h0 + i) // G for i in range(n)]
    lo, width = ids[0], ids[-1] + 1 - ids[0]
    if n % width == 0 and ids == [lo + i // (n // width) for i in range(n)]:
        return slice(lo, lo + width)
    return ids


def _attend_local(q, k, v, *, cfg: LMConfig, window: int, impl: str, mesh):
    """One rank's causal attention.  q [B, Hl, Sq, D] is a block of the
    heads, or of the positions (context-parallel), or all of q; k, v [B,
    KVH, S, D] hold every head and position.  RoPE at the block's
    positions, then the KV heads the block's q heads read.  A block of
    positions runs the plain version (the flash kernels take whole
    sequences).  Returns (o, k after RoPE, v)."""
    m = mesh.get_local_rank("model")
    B, Hl, Sq, D = q.shape
    S = k.shape[2]
    q_start = m * Sq if Sq < S else 0
    h0 = m * Hl if Hl < cfg.n_heads else 0
    pos = torch.arange(S, dtype=torch.int32, device=q.device)[None, None]
    q = rope(q, pos[..., q_start:q_start + Sq], cfg.rope_theta)
    kr = rope(k, pos, cfg.rope_theta)
    heads = _kv_heads_of(cfg, h0, Hl)
    kw = dict(scale=cfg.head_dim ** -0.5, window=window,
              softcap=cfg.attn_softcap)
    if Sq < S:
        if resolve_impl(impl) != "torch":
            raise ValueError(
                f"{cfg.name}: context-parallel attention ({cfg.n_heads} "
                f"heads over model_axis_size={cfg.model_axis_size}) runs "
                f"the plain version; the flash kernels take whole "
                f"sequences: pass impl='torch'")
        o = attention_ref(q, kr[:, heads], v[:, heads], q_start=q_start,
                          **kw)
    else:
        o = flash_attention(q, kr[:, heads], v[:, heads], causal=True,
                            impl=impl, **kw)
    return o, kr, v


def _attention_spmd(p: Params, cfg: LMConfig, x, window: int, impl: str,
                    mesh, constrain: bool):
    """Attention over DTensors: (out [B, S, d], k, v) with k after RoPE.
    q's heads lie over ``"model"`` when they split evenly, else every
    rank holds them all; k and v are whole on every rank.  With
    ``constrain`` (the training path, the JAX package's ``apply_attention``)
    q and o are pinned head-parallel, or context-parallel (q's positions
    over ``"model"``) when the heads do not split, and the output to the
    batch axes.  The attention itself runs in ``local_map``: a rank's
    gradient of k and v is its share, summed over ``"model"``."""
    B, S, _ = x.shape
    q, k, v = x @ p["wq"], x @ p["wk"], x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    o, k, v = _attend_spmd(q, k, v, cfg, window, impl, mesh, constrain)
    ba = _batch_axes(cfg, B)
    wo = p["wo"]
    if cfg.n_heads % cfg.model_axis_size:
        # wo's rows are q's heads, which do not split over "model": the
        # product takes o and wo whole, and o's gradient comes back whole
        # per head (a context-parallel o is gathered along its positions)
        o, wo = _wsc(o, (ba, None, None, None)), _wsc(wo, (None, None))
    out = o.transpose(1, 2).reshape(B, S, -1) @ wo
    if constrain:
        out = _wsc(out, (ba, None, None))
    return out, k, v


def _attend_spmd(q, k, v, cfg: LMConfig, window: int, impl: str, mesh,
                 constrain: bool):
    """The projections q [B, S, H * D], k, v [B, S, KVH * D] (DTensors)
    split into heads and attended: (o [B, H, S, D], k after RoPE, v [B,
    KVH, S, D]), placed as :func:`_attention_spmd` says."""
    from torch.distributed.tensor.experimental import local_map
    B = q.shape[0]
    ba = _batch_axes(cfg, B)
    hp = cfg.n_heads % cfg.model_axis_size == 0
    dh = cfg.head_dim
    q = _heads(q, cfg.n_heads, dh, (ba, None, "model" if hp else None))
    k = _heads(k, cfg.n_kv_heads, dh, (ba, None, None))
    v = _heads(v, cfg.n_kv_heads, dh, (ba, None, None))
    if constrain:
        q = _wsc(q, (ba, "model", None, None) if hp
                 else (ba, None, "model", None))
    kv = _placements(mesh, (ba, None, None, None))
    kv_grad = _partial_over(mesh, (ba, None, None, None), ("model",))
    o, k, v = local_map(
        functools.partial(_attend_local, cfg=cfg, window=window, impl=impl,
                          mesh=mesh),
        out_placements=(q.placements, kv, kv),
        in_placements=(q.placements, kv, kv),
        in_grad_placements=(q.placements, kv_grad, kv_grad),
        device_mesh=mesh)(q, k, v)
    return o, k, v


def apply_mlp(p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU; the [.., d_ff] intermediates are updated in place (they are
    this function's own), which halves their peak memory at prefill.  A
    DTensor's placement may change from op to op (a sum left partial over
    ``"model"``), which an in-place op cannot follow: DTensors take the
    out-of-place ops."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        return (F.silu(x @ p["wg"]) * (x @ p["wi"])) @ p["wo"]
    h = F.silu(x @ p["wg"], inplace=True)
    return h.mul_(x @ p["wi"]) @ p["wo"]


# ---------------------------------------------------------------------------
# MoE: top-k routing into capacity buckets
# ---------------------------------------------------------------------------

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

    def experts(self, e0: int, n: int) -> "TokenPlan":
        """The plan as a rank holding experts ``e0 .. e0 + n - 1`` sees it:
        their slots numbered from 0, every other lane dropped (it reads
        the zero row ``n * C``).  The whole plan when that is all of
        them."""
        if e0 == 0 and n == self.E:
            return self
        lo, hi, C = e0 * self.C, (e0 + n) * self.C, self.C
        sol = self.slot_of_lane
        keep = self.keep & (self.slot >= lo) & (self.slot < hi)
        return TokenPlan(
            T=self.T, K=self.K, E=n, C=C, order=self.order, keep=keep,
            slot=torch.where(keep, self.slot - lo, n * C),
            slot_of_lane=torch.where((sol >= lo) & (sol < hi), sol - lo,
                                     n * C),
            tok_of_slot=self.tok_of_slot[lo:hi].contiguous(),
            row_ptr=self.row_ptr)


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


def _dispatch_plain(xt: torch.Tensor, plan: TokenPlan) -> torch.Tensor:
    """The plain version of :class:`_Dispatch`: the buckets [E * C, d]
    gathered from a float32 copy of the tokens (so a token's gradients sum
    in float32 and round once) and rounded to the tokens' type."""
    rows = torch.cat([xt.float(), xt.new_zeros((1, xt.shape[1]),
                                               dtype=torch.float32)])
    return rows[plan.tok_of_slot.long()].to(xt.dtype)


def _combine_plain(yb: torch.Tensor, gate: torch.Tensor,
                   plan: TokenPlan) -> torch.Tensor:
    """The plain version of :class:`_Combine`: f32 [T, d], each lane's
    row scaled by its gate in float32, summed by token in float64 with
    ``index_add``, rounded once."""
    rows = torch.cat([yb, yb.new_zeros((1, yb.shape[1]))])
    contrib = rows[plan.slot_of_lane.long()].float() * gate[:, None]
    tok = torch.arange(plan.T, device=yb.device).repeat_interleave(plan.K)
    return torch.zeros((plan.T, yb.shape[1]), dtype=torch.float64,
                       device=yb.device).index_add(
        0, tok, contrib.double()).float()


def _moe(p: Params, cfg: LMConfig, x, impl: str, mesh=None,
         ep: bool = False, probe: Optional[Dict] = None):
    """The MoE, on one card (``mesh`` None) or over DTensors: route, plan,
    fill the buckets, the experts' SwiGLU, combine, the shared expert.
    Under a mesh with ``ep`` (:func:`apply_moe_ep`) each data shard routes
    its own T / D tokens at ``capacity(cfg, T / D)``; without (the JAX
    package's gather-based dispatch under ``act_shard_axes``) every rank
    routes all T tokens at ``capacity(cfg, T)`` and the aux loss is kept.
    Routing, the plan and the bucket fill run in ``local_map`` over the
    routed tokens; the buckets [E, C, d] are pinned experts over
    ``"model"`` for the experts' products (DTensor gathers the stacks'
    FSDP dim); each rank's combine sums its E / M experts' lanes by token
    into a float32 partial that leaves as ``Partial()`` on ``"model"`` and
    is redistributed to a replica.  On one card the same bodies run on
    the plain tensors, every expert this rank's.  ``probe``, when given,
    gets this rank's expert ids, plan and expert rows (``eidx``,
    ``plan``, ``yb`` [E / M * C, d])."""
    B, S, d = x.shape
    E, T = cfg.n_experts, B * S
    MP, tok, T_loc, out_tok = 1, None, T, None
    if mesh is not None:
        MP = cfg.model_axis_size
        if E % MP:
            raise ValueError(f"{cfg.name}: {E} experts do not split over "
                             f"model_axis_size={MP}")
    if mesh is not None and ep:
        D = cfg.data_axis_size
        if T % D:
            raise ValueError(
                f"{cfg.name}: {T} tokens do not split over the {D} data "
                f"shards of {tuple(cfg.act_shard_axes)}; the expert-parallel"
                f" dispatch routes each shard's own tokens (the JAX "
                f"package's shard_map refuses the same)")
        tok, T_loc = tuple(cfg.act_shard_axes), T // D
        out_tok = tok if B % D == 0 else None
    E_per, C = E // MP, capacity(cfg, T_loc)
    plain = resolve_impl(impl) == "torch"
    mine: List[TokenPlan] = []

    def dispatch(xt, router):
        gate, eidx, aux = route({"router": router}, cfg, xt.float())
        plan = token_plan(eidx, C, E)
        mine.append(plan)
        if probe is not None:
            probe.update(eidx=eidx, plan=plan)
        xb = (_dispatch_plain(xt, plan) if plain
              else _Dispatch.apply(xt.contiguous(), plan))
        return xb.view(E, C, d), gate.reshape(-1).contiguous(), aux

    def combine(yb, gate):
        e0 = 0 if mesh is None else mesh.get_local_rank("model") * E_per
        plan = mine[-1].experts(e0, E_per)
        yb = yb.reshape(E_per * C, d)
        if probe is not None:
            probe["yb"] = yb
        return (_combine_plain(yb, gate, plan) if plain
                else _Combine.apply(yb.contiguous(), gate, plan))

    xt = x.reshape(T, d)
    if mesh is None:
        xb, gate, aux = dispatch(xt, p["router"])
        y = combine(_experts(p, xb), gate)
    else:
        from torch.distributed.tensor.experimental import local_map
        pl = functools.partial(_placements, mesh)
        xt = _wsc(xt, (tok, None))
        xb, gate, aux = local_map(
            dispatch,
            out_placements=(pl((None, tok, None)), pl((tok,)), pl(())),
            in_placements=(pl((tok, None)), pl((None, None))),
            in_grad_placements=(pl((tok, None)),
                                _partial_over(mesh, (None, None), tok or ())),
            device_mesh=mesh)(xt, _wsc(p["router"], (None, None)))
        xb = _wsc(xb, ("model", tok, None))
        yb = _wsc(_experts(p, xb), ("model", tok, None))
        y = local_map(
            combine,
            out_placements=list(_partial_over(mesh, (tok, None), ("model",))),
            in_placements=(pl(("model", tok, None)), pl((tok,))),
            in_grad_placements=(pl(("model", tok, None)),
                                _partial_over(mesh, (tok,), ("model",))),
            device_mesh=mesh)(yb, gate)
        y = _wsc(y, (out_tok, None))
    y = y.to(x.dtype)
    if cfg.n_shared_experts:
        y = y + apply_mlp(p["shared"], xt)
    return y.view(B, S, d), (torch.zeros((), device=x.device)
                             if mesh is not None and ep else aux)


def apply_moe_ep(p: Params, cfg: LMConfig, x, impl: str = "cuda",
                 probe: Optional[Dict] = None):
    """Expert-parallel MoE over DTensors, as the JAX package's
    ``apply_moe_ep``: x [B, S, d] -> (y, aux loss 0).  The data shards of
    ``act_shard_axes`` each route their own T / D tokens in float32 into
    their own buckets at ``C = capacity(cfg, T / D)`` (the plan and the
    bucket fill on ``block_gather`` with ``impl="cuda"``); the buckets
    [E, D C, d] go experts over ``"model"`` for the SwiGLU products; each
    (data, model) rank gathers its E / M experts' rows in token-major lane
    order and sums them by token (``block_gather``, ``segment_sum`` in
    float64), and the float32 partials add over ``"model"``, then the
    shared expert.  Per data shard this is :func:`apply_moe` on its
    tokens, less the aux loss.  Needs the ambient mesh of the config's
    SPMD fields; T must split over the data shards (ValueError).
    ``probe``: as :func:`_moe`'s."""
    mesh = spmd_mesh(cfg)
    if mesh is None or not cfg.ep_shard_map:
        raise ValueError(f"{cfg.name}: apply_moe_ep runs with ep_shard_map "
                         f"and act_shard_axes set")
    return _moe(p, cfg, x, impl, mesh, True, probe)


def apply_moe(p: Params, cfg: LMConfig, x: torch.Tensor,
              impl: str = "cuda", probe: Optional[Dict] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B, S, d] -> (y [B, S, d], aux loss).  Float32 routing and the
    sorted capacity-bucket dispatch of the reference.  The combine scales
    each kept row by its gate in float32, sums by token in float64 (the
    ``segment_sum`` kernel's accumulator) and rounds once, to float32 and
    then the model's type, where the JAX package adds in the model's type.
    ``impl="torch"``: plain indexing and ``index_add``; ``"cuda"``: the
    dispatch and combine on the graph kernels over one
    :class:`TokenPlan`.  Under a mesh (the config's SPMD fields) the
    expert-parallel :func:`apply_moe_ep` when ``ep_shard_map`` is set, as
    in the JAX package, else the same dispatch over every token with the
    buckets pinned experts over ``"model"``.  ``probe``: as
    :func:`_moe`'s."""
    mesh = spmd_mesh(cfg)
    return _moe(p, cfg, x, impl, mesh, mesh is not None and cfg.ep_shard_map,
                probe)


def _ffn(p: Params, cfg: LMConfig, z: torch.Tensor, impl: str = "cuda"):
    """The layer's feed-forward: (y, aux), the MoE or the dense MLP (aux
    0)."""
    if cfg.moe:
        return apply_moe(p["moe"], cfg, z, impl)
    return apply_mlp(p["mlp"], z), torch.zeros((), device=z.device)


def apply_layer(p: Params, cfg: LMConfig, x: torch.Tensor,
                positions: torch.Tensor, window: int, impl: str = "cuda",
                attn_impl: Optional[str] = None, constrain: bool = True):
    """One pre-norm decoder layer over [B, S, d]: (x', k, v, aux).
    Attention takes ``attn_impl`` (``impl`` when None), the MoE ``impl``;
    under a mesh ``constrain`` pins attention's activations (the JAX
    package's forward does, its prefill does not)."""
    if spmd_mesh(cfg) is not None:
        p = fsdp_gathered(p, cfg)
    h, k, v = attention_with_kv(p["attn"], cfg,
                                rmsnorm(p["ln1"], x, cfg.norm_eps),
                                positions, window, attn_impl or impl,
                                constrain)
    x = x + h
    y, aux = _ffn(p, cfg, rmsnorm(p["ln2"], x, cfg.norm_eps), impl)
    x = x + y
    if constrain and spmd_mesh(cfg) is not None:
        # the residual stream whole over "model", as GSPMD propagates it
        # from the attention output's constraint; DTensor would keep the
        # row-parallel product's sum partial and, in the backward, split
        # the tokens over "model" as well
        x = _wsc(x, (_batch_axes(cfg, x.shape[0]), None, None))
    return x, k, v, aux


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
