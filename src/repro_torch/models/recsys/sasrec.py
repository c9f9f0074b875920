"""SASRec — self-attentive sequential recommendation (arXiv:1808.09781), as
``repro.models.recsys.sasrec``: serving only (``loss_fn`` and training wait
for the training slice).

Parameters are a dict of tensors (``blocks`` a list of dicts), so the JAX
package's tree carries over one to one (``interop.sasrec_params_from_jax``);
:class:`SASRec` is an ``nn.Module`` view of the same dict.  ``impl`` is the
port's switch: ``"cuda"`` runs the item lookup of :func:`encode` through the
EmbeddingBag kernel and the candidate gather of :func:`score_candidates`
through the block-gather kernel (their plain versions for CPU tensors);
``"torch"`` runs both plain.  Attention, LayerNorm and the products are
plain torch, as the JAX package leaves them to XLA.

Semantics kept from the reference for parity: :func:`user_repr` takes the
hidden state at position S - 1, which is a zeroed pad for a right-padded
history shorter than S (such a user scores every item ``ln_f.b . item``);
:func:`serve_step_topk` materialises the whole [B, V] score matrix, so a
caller at bulk scale scores in user chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.backend import resolve_device, resolve_impl
from repro_torch.kernels.block_gather import block_gather_ref, gather_rows
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
from repro_torch.models.transformer.layers import ParamTree

Params = Dict[str, Any]
NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SASRecConfig:
    name: str = "sasrec"
    n_items: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dropout: float = 0.0              # inference-grade default
    dtype: torch.dtype = torch.float32


def init_params(cfg: SASRecConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random weights from ``generator``, which must live on ``device`` (the
    card by default); row 0 of ``item_emb`` is the padding item."""
    dev = resolve_device(device)
    d = cfg.embed_dim

    def normal(shape, scale):
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=dev).mul_(scale).to(cfg.dtype)

    def ln():
        return {"g": torch.ones((d,), dtype=cfg.dtype, device=dev),
                "b": torch.zeros((d,), dtype=cfg.dtype, device=dev)}

    p = {"item_emb": normal((cfg.n_items + 1, d), 0.02),
         "pos_emb": normal((cfg.seq_len, d), 0.02),
         "blocks": [], "ln_f": ln()}
    for _ in range(cfg.n_blocks):
        blk = {"ln1": ln()}
        blk.update({k: normal((d, d), d ** -0.5) for k in ("wq", "wk", "wv",
                                                           "wo")})
        blk["ln2"] = ln()
        blk.update({k: normal((d, d), d ** -0.5) for k in ("w1", "w2")})
        p["blocks"].append(blk)
    return p


def _ln(p: Params, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * p["g"] + p["b"]


def embed(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
          impl: str = "cuda") -> torch.Tensor:
    """``item_emb[seq] * sqrt(d) + pos_emb``, zero at the pads: [B, S, d].

    The lookup is an EmbeddingBag of one slot per position, weight sqrt(d)
    rounded to float32 (as JAX rounds ``d ** 0.5``; the wrapper takes the
    number as it is, with no [B*S, 1] weight tensor), id -1 at the pads.
    """
    B, S = seq.shape
    d = cfg.embed_dim
    table = params["item_emb"]
    pad = seq == 0
    ids = torch.where(pad, -1, seq).reshape(B * S, 1)
    w = d ** 0.5
    lookup = embedding_bag if resolve_impl(impl) == "cuda" \
        else embedding_bag_ref
    h = lookup(table, ids, w).reshape(B, S, d) + params["pos_emb"][None, :S]
    return torch.where(pad[..., None], 0.0, h)


def encode(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
           impl: str = "cuda") -> torch.Tensor:
    """seq int32 [B, S] item ids (0 = padding) -> hidden states [B, S, d]."""
    B, S = seq.shape
    d, H = cfg.embed_dim, cfg.n_heads
    dh = d // H
    pad = seq == 0
    h = embed(params, cfg, seq, impl)
    causal = torch.ones((S, S), dtype=torch.bool, device=seq.device).tril()
    mask = causal[None, None] & (~pad)[:, None, None, :]
    for blk in params["blocks"]:
        z = _ln(blk["ln1"], h)
        q, k, v = ((z @ blk[w]).reshape(B, S, H, dh).transpose(1, 2)
                   for w in ("wq", "wk", "wv"))
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) * (dh ** -0.5)
        s = torch.where(mask, s, NEG_INF)
        a = torch.softmax(s.float(), dim=-1).to(h.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", a, v)
        h = h + o.transpose(1, 2).reshape(B, S, d) @ blk["wo"]
        z = _ln(blk["ln2"], h)
        h = h + F.relu(z @ blk["w1"]) @ blk["w2"]
        h = torch.where(pad[..., None], 0.0, h)
    return _ln(params["ln_f"], h)


def user_repr(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
              impl: str = "cuda") -> torch.Tensor:
    """Final-position hidden state [B, d] (the query vector at serve time)."""
    return encode(params, cfg, seq, impl)[:, -1, :]


def serve_step(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
               impl: str = "cuda") -> torch.Tensor:
    """Score the full catalog: float32 [B, n_items + 1]."""
    u = user_repr(params, cfg, seq, impl)
    return (u @ params["item_emb"].T).float()


def serve_step_topk(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
                    k: int = 100, impl: str = "cuda"):
    """(values float32 [B, k], item ids int32 [B, k]) of the best-scoring
    items; the [B, n_items + 1] scores are a transient."""
    vals, idx = torch.topk(serve_step(params, cfg, seq, impl), k, dim=-1)
    return vals, idx.to(torch.int32)


def score_candidates(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
                     candidates: torch.Tensor,
                     impl: str = "cuda") -> torch.Tensor:
    """Retrieval scoring: candidates int32 [B, NC] -> float32 [B, NC]: one
    gather of the candidate rows (ids clamped to the table), one batched
    dot."""
    B, NC = candidates.shape
    u = user_repr(params, cfg, seq, impl)
    table = params["item_emb"]
    flat = candidates.reshape(-1)
    if resolve_impl(impl) == "cuda":
        ce = gather_rows(table, flat, rows_per_step=1)
    else:
        ce = block_gather_ref(table, flat, 1)
    return torch.einsum("bd,bnd->bn", u, ce.reshape(B, NC, -1)).float()


class SASRec(nn.Module):
    """``nn.Module`` view of a SASRec parameter dict (frozen parameters
    sharing its storage); ``forward`` is :func:`encode`."""

    def __init__(self, cfg: SASRecConfig, params: Params):
        super().__init__()
        self.cfg = cfg
        self.top = ParamTree({k: v for k, v in params.items()
                              if k != "blocks"})
        self.blocks = nn.ModuleList(ParamTree(b) for b in params["blocks"])

    def tree(self) -> Params:
        return dict(self.top.tree(), blocks=[b.tree() for b in self.blocks])

    def forward(self, seq: torch.Tensor, impl: str = "cuda") -> torch.Tensor:
        return encode(self.tree(), self.cfg, seq, impl)
