"""Equiformer-v2 — equivariant graph attention through eSCN SO(2)
convolutions (arXiv:2306.12059), as ``repro.models.gnn.equiformer_v2``.
Config equiformer-v2: 12 layers, d_hidden 128, l_max 6, m_max 2, 8 heads.

Each edge's source features are rotated into the edge-aligned frame
(a Wigner-D block per degree l, ``so3.py``), where the SO(3) tensor
product is a block-diagonal SO(2) linear map per m (only |m| <= m_max
kept: the eSCN truncation), then rotated back and summed by destination.
Features are real-SH irrep stacks [N, (l_max+1)^2, C].  Attention weights
come from the invariant (l = 0) message channel through a per-destination
softmax over all heads at once; the FFN acts on l = 0 and gates the higher
degrees.

On the kernel route (``impl="cuda"``) the gathers ``z[src]`` (z viewed as
[N, K·C]) and the positions at both ends, and the sum of the messages by
destination, run on ``block_gather`` and ``segment_sum`` over the batch's
edge plan, forward and backward (``models/gnn/common.py``).

Where the layout differs from the JAX package's (the same arithmetic up to
the order of float32 sums): the edge frame keeps its components m-major
(:func:`_edge_layout`), so the SO(2) map reads the pieces of one ``split``
and writes one ``cat`` where JAX gathers and ``.at[].set``s by index; the
Wigner blocks depend on the edges alone, so they are built once a forward
as block-diagonal matrices with the m-major permutation folded in, and
each rotation is one batched product (``truncate_rotation`` keeps only
the |m| <= m_max rows, as JAX's reduced layout does).  Per-degree and
l = 0 updates are index sums and ``where``s, not slices: autograd turns
every slice's gradient into a full-size zero tensor and adds them up.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List

import torch

from repro_torch.backend import resolve_device
from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (GraphBatch, batch_plan, gather,
                                           graph_pool, mlp_apply, mlp_params,
                                           node_loss, scatter_sum,
                                           segment_softmax)


@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 32
    d_in: int = 128                  # invariant input feature dim
    n_classes: int = 1
    graph_level: bool = True
    rbf_cutoff: float = 5.0
    # rotate only the |m| <= m_max rows of the edge frame (exact: the SO(2)
    # conv zeroes higher m anyway); per-edge rotated tensors shrink from
    # (l_max+1)^2 to sum_l (2 min(l, m_max) + 1) components
    truncate_rotation: bool = False
    # the per-edge rotate / conv pipeline in bf16 (node state and the
    # aggregation stay float32)
    edge_bf16: bool = False

    @property
    def n_comps(self) -> int:
        return (self.l_max + 1) ** 2

    @property
    def n_comps_reduced(self) -> int:
        return sum(2 * min(l, self.m_max) + 1 for l in range(self.l_max + 1))


def _l_slices(l_max: int) -> List[slice]:
    out, off = [], 0
    for l in range(l_max + 1):
        out.append(slice(off, off + 2 * l + 1))
        off += 2 * l + 1
    return out


def _m_index(l_max: int, m: int):
    """Flat indices of the +m (and -m) components across degrees l >= m."""
    plus, minus = [], []
    off = 0
    for l in range(l_max + 1):
        if l >= m:
            plus.append(off + l + m)
            minus.append(off + l - m)
        off += 2 * l + 1
    return plus, minus


@functools.lru_cache(maxsize=None)
def _edge_layout(l_max: int, m_max: int, reduced: bool,
                 device: torch.device):
    """The edge frame's component order in the port: m-major.

    Per m = 0..m_max, the +m components of the degrees l >= m, then (m > 0)
    their -m components, each block a contiguous run, so the SO(2) map's
    inputs are pieces of one ``split`` and its outputs one ``cat`` (no
    index writes, no slices whose gradients autograd adds up); then, unless
    ``reduced``, the |m| > m_max components the map zeroes.  Returns (the
    standard component index of each position, a long tensor; the run
    sizes; the number of SO(2)-mapped positions)."""
    order, sizes = [], []
    for m in range(m_max + 1):
        plus, minus = _m_index(l_max, m)
        for run in (plus,) if m == 0 else (plus, minus):
            order += run
            sizes.append(len(run))
    n_mapped = len(order)
    if not reduced:
        rest = sorted(set(range((l_max + 1) ** 2)) - set(order))
        order += rest
        sizes.append(len(rest))
    return (torch.tensor(order, dtype=torch.long, device=device),
            tuple(sizes), n_mapped)


def init_so2_conv(generator: torch.Generator, cfg: EquiformerV2Config,
                  c_in: int, c_out: int, device):
    """Per-m SO(2)-equivariant linear maps."""
    p = {}
    for m in range(cfg.m_max + 1):
        nl = cfg.l_max + 1 - m
        scale = (nl * c_in) ** -0.5
        for part in ("r", "i") if m > 0 else ("r",):
            p[f"w{m}_{part}"] = torch.randn(
                (nl * c_in, nl * c_out), generator=generator,
                dtype=torch.float32, device=device) * scale
    return p


def apply_so2_conv(p, cfg: EquiformerV2Config, x_edge: torch.Tensor,
                   c_out: int, reduced: bool = False) -> torch.Tensor:
    """x_edge [E, K, c_in] in the edge-aligned frame, components in the
    m-major order of :func:`_edge_layout` -> [E, K, c_out] in the same
    order.

    m = 0: a plain linear map over (l, channel); m > 0: the complex-
    structured SO(2) map on the (+m, -m) pair; |m| > m_max truncated (zero
    rows).  ``reduced``: the input holds only the mapped components (the
    same weights on the same (l, m) pairs).
    """
    E = x_edge.shape[0]
    dt = x_edge.dtype
    _, sizes, n_mapped = _edge_layout(cfg.l_max, cfg.m_max, reduced,
                                      x_edge.device)
    runs = iter(torch.split(x_edge, sizes, dim=1))
    out = [next(runs).reshape(E, -1) @ p["w0_r"].to(dt)]
    for m in range(1, cfg.m_max + 1):
        xp, xm = (next(runs).reshape(E, -1) for _ in "pm")
        wr, wi = p[f"w{m}_r"].to(dt), p[f"w{m}_i"].to(dt)
        out += [xp @ wr - xm @ wi, xp @ wi + xm @ wr]
    if not reduced:                      # the truncated |m| > m_max rows
        out.append(x_edge.new_zeros((E, (x_edge.shape[1] - n_mapped)
                                     * c_out)))
    return torch.cat(out, dim=1).reshape(E, -1, c_out)


def wigner_blocks(cfg: EquiformerV2Config, alpha: torch.Tensor,
                  beta: torch.Tensor, dtype=torch.float32):
    """The edges' rotations as two block-diagonal matrices, built once a
    forward: to the edge frame, D(0, -beta, -alpha) per degree, rows in the
    m-major edge layout ([E, K, K], or [E, K_red, K] with
    ``truncate_rotation``: only the |m| <= m_max rows); and back,
    D(alpha, beta, 0) per degree, columns in that layout ([E, K, K] or
    [E, K, K_red]).  A rotation is then one batched product; the zero
    blocks add exact zeros."""
    E, K = alpha.shape[0], cfg.n_comps
    zero = torch.zeros_like(alpha)
    to_edge = alpha.new_zeros((E, K, K))
    from_edge = alpha.new_zeros((E, K, K))
    for l, sl in enumerate(_l_slices(cfg.l_max)):
        to_edge[:, sl, sl] = so3.wigner_D(l, zero, -beta, -alpha)
        from_edge[:, sl, sl] = so3.wigner_D(l, alpha, beta, zero)
    order, _, _ = _edge_layout(cfg.l_max, cfg.m_max, cfg.truncate_rotation,
                               alpha.device)
    return (to_edge.index_select(1, order).to(dtype),
            from_edge.index_select(2, order).to(dtype))


@functools.lru_cache(maxsize=None)
def _degrees(l_max: int, device: torch.device) -> torch.Tensor:
    """The degree l of each standard component."""
    return torch.tensor([l for l in range(l_max + 1)
                         for _ in range(2 * l + 1)], dtype=torch.long,
                        device=device)


def equiv_layernorm(p, cfg: EquiformerV2Config,
                    x: torch.Tensor) -> torch.Tensor:
    """Per-degree RMS norm with learned per-(l, channel) scales: each
    degree's sum over m of x^2 (one ``index_add`` over the components),
    meaned over channels."""
    deg = _degrees(cfg.l_max, x.device)
    ss = x.new_zeros((x.shape[0], cfg.l_max + 1, x.shape[2])).index_add(
        1, deg, x * x)
    rms = torch.sqrt(torch.mean(ss, dim=-1, keepdim=True) + 1e-6)
    return x / rms.index_select(1, deg) * p["scale"].index_select(0, deg)


def init_layer(generator: torch.Generator, cfg: EquiformerV2Config, device):
    C = cfg.d_hidden
    ones = lambda: torch.ones((cfg.l_max + 1, C),  # noqa: E731
                              dtype=torch.float32, device=device)
    return {
        "ln1": {"scale": ones()},
        "ln2": {"scale": ones()},
        "so2": init_so2_conv(generator, cfg, C, C, device),
        "alpha": mlp_params(generator, (C, C, cfg.n_heads), device),
        "rbf_gate": mlp_params(generator, (cfg.n_rbf, C, C), device),
        # initialised and never applied, as in the JAX package (its
        # gradient is 0): kept so the two trees hold the same leaves
        "out_proj": mlp_params(generator, (C, C), device),
        "ffn_inv": mlp_params(generator, (C, 2 * C, C), device),
        "ffn_gate": mlp_params(generator, (C, C), device),
    }


def init_params(cfg: EquiformerV2Config, generator: torch.Generator,
                device=None) -> Dict[str, Any]:
    """Random weights from ``generator``, which must live on ``device`` (the
    card by default)."""
    dev = resolve_device(device)
    return {
        "embed": mlp_params(generator, (cfg.d_in, cfg.d_hidden), dev),
        "layers": [init_layer(generator, cfg, dev)
                   for _ in range(cfg.n_layers)],
        "head": mlp_params(generator,
                           (cfg.d_hidden, cfg.d_hidden, cfg.n_classes), dev),
    }


def _rbf(cfg: EquiformerV2Config, dist: torch.Tensor) -> torch.Tensor:
    mu = torch.linspace(0.0, cfg.rbf_cutoff, cfg.n_rbf, device=dist.device)
    gamma = cfg.n_rbf / cfg.rbf_cutoff
    return torch.exp(-gamma * (dist[:, None] - mu[None, :]) ** 2)


def forward(params, cfg: EquiformerV2Config, g: GraphBatch,
            impl: str = "cuda") -> torch.Tensor:
    plan = batch_plan(g, impl)
    N = g.num_nodes
    E = g.edge_src.shape[0]
    C = cfg.d_hidden
    K = cfg.n_comps
    H = cfg.n_heads
    trunc = cfg.truncate_rotation
    Kr = cfg.n_comps_reduced if trunc else K
    edge_dt = torch.bfloat16 if cfg.edge_bf16 else torch.float32
    l0 = (torch.arange(K, device=g.device) == 0)[None, :, None]
    # embed the invariant inputs into the l = 0 slot
    emb = mlp_apply(params["embed"], g.x, final_act=True)
    x = torch.cat([emb[:, None, :], emb.new_zeros((N, K - 1, C))], dim=1)

    vec = gather(g.pos, g, "dst", impl, plan) \
        - gather(g.pos, g, "src", impl, plan)
    dist = torch.sqrt(torch.sum(vec * vec, dim=-1) + 1e-12)
    to_edge, from_edge = wigner_blocks(cfg, *so3.edge_align_angles(vec),
                                       dtype=edge_dt)
    rbf = _rbf(cfg, dist)

    for lp in params["layers"]:
        z = equiv_layernorm(lp["ln1"], cfg, x)
        src_f = gather(z.reshape(N, K * C), g, "src", impl, plan) \
            .reshape(E, K, C).to(edge_dt)
        edge_f = to_edge @ src_f                     # [E, Kr, C], m-major
        msg = apply_so2_conv(lp["so2"], cfg, edge_f, C, reduced=trunc)
        gate = mlp_apply(lp["rbf_gate"], rbf)                   # [E, C]
        msg = msg * torch.sigmoid(gate)[:, None, :].to(edge_dt)
        # attention from the invariant channel (position 0 in both
        # layouts); a bf16 channel meets the float32 MLP as JAX promotes it
        att_logit = mlp_apply(lp["alpha"], msg[:, 0, :].float())  # [E, H]
        att = segment_softmax(att_logit, g.edge_dst, g.edge_valid, N)
        msg = (msg.reshape(E, Kr, H, C // H)
               * att[:, None, :, None].to(edge_dt)).reshape(E, Kr, C)
        msg = (from_edge @ msg).float()              # lab frame, f32 sum
        agg = scatter_sum(msg.reshape(E, K * C), g.edge_dst, g.edge_valid,
                          N, impl, plan).reshape(N, K, C)
        x = equiv_layernorm(lp["ln2"], cfg, x + agg)
        x0 = x[:, 0, :]
        inv = mlp_apply(lp["ffn_inv"], x0)
        g8 = torch.sigmoid(mlp_apply(lp["ffn_gate"], x0))
        x = torch.where(l0, x + inv[:, None, :], x * g8[:, None, :])
        x = torch.where(g.node_valid[:, None, None], x, 0.0)

    inv_out = x[:, 0, :]
    if cfg.graph_level:
        ng = g.labels.shape[0] if g.labels is not None else 1
        pooled = graph_pool(inv_out, g.graph_id, g.node_valid, ng)
        return mlp_apply(params["head"], pooled)
    return mlp_apply(params["head"], inv_out)


def loss_fn(params, cfg: EquiformerV2Config, g: GraphBatch,
            impl: str = "cuda") -> torch.Tensor:
    return node_loss(forward(params, cfg, g, impl), g, cfg.graph_level)
