"""SASRec — self-attentive sequential recommendation (arXiv:1808.09781), as
``repro.models.recsys.sasrec``: serving and the training loss.

Parameters are a dict of tensors (``blocks`` a list of dicts), so the JAX
package's tree carries over one to one (``interop.sasrec_params_from_jax``);
:class:`SASRec` is an ``nn.Module`` view of the same dict.  ``impl`` is the
port's switch: ``"cuda"`` runs the item lookup of :func:`encode` through the
EmbeddingBag kernel and the candidate gather of :func:`score_candidates`
through the block-gather kernel (their plain versions for CPU tensors);
``"torch"`` runs both plain.  Attention, LayerNorm and the products are
plain torch, as the JAX package leaves them to XLA.

Training (:func:`loss_fn`, the paper's BCE over positive and sampled
negative next items) reads the item table at three ids a position: the
history's (``encode``'s lookup), the positive's and the negative's.  On the
kernel route the three lookups are one autograd function over a
:class:`~repro_torch.models.plan.EdgePlan` of the batch's ids
(:func:`lookup_plan`, built once a batch): forward the ``embedding_bag``
kernel for the history (weight sqrt(d), pads -1) and ``block_gather`` for
the positives and negatives; backward one sum by item id of all three
lanes' gradients on ``block_gather`` + ``segment_sum``
(``models.plan.lane_sum``), so the [n_items + 1, d] table gradient is
written once.  A pad adds
nothing, so the padding row's gradient is the 0 JAX gives it.

Semantics kept from the reference for parity: :func:`user_repr` takes the
hidden state at position S - 1, which is a zeroed pad for a right-padded
history shorter than S (such a user scores every item ``ln_f.b . item``);
:func:`serve_step_topk` materialises the whole [B, V] score matrix, so a
caller at bulk scale scores in user chunks.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.backend import resolve_device, resolve_impl
from repro_torch.kernels.block_gather import block_gather_ref, gather_rows
from repro_torch.kernels.embedding_bag import embedding_bag, embedding_bag_ref
from repro_torch.models.plan import EdgePlan, _gather, edge_plan, lane_sum
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


def _place(params: Params, seq: torch.Tensor,
           rows: torch.Tensor) -> torch.Tensor:
    """The looked-up rows ``item_emb[seq] * sqrt(d)`` [B*S, d] plus the
    position embeddings, zero at the pads: [B, S, d]."""
    B, S = seq.shape
    h = rows.reshape(B, S, -1) + params["pos_emb"][None, :S]
    return torch.where((seq == 0)[..., None], 0.0, h)


def _lookup_ids(seq: torch.Tensor) -> torch.Tensor:
    """``seq`` as one-slot bags [B*S, 1], -1 at the pads."""
    return torch.where(seq == 0, -1, seq).reshape(-1, 1)


def embed(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
          impl: str = "cuda") -> torch.Tensor:
    """``item_emb[seq] * sqrt(d) + pos_emb``, zero at the pads: [B, S, d].

    The lookup is an EmbeddingBag of one slot per position, weight sqrt(d)
    rounded to float32 (as JAX rounds ``d ** 0.5``; the wrapper takes the
    number as it is, with no [B*S, 1] weight tensor), id -1 at the pads.
    """
    lookup = embedding_bag if resolve_impl(impl) == "cuda" \
        else embedding_bag_ref
    return _place(params, seq, lookup(params["item_emb"], _lookup_ids(seq),
                                      cfg.embed_dim ** 0.5))


def _blocks(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
            h: torch.Tensor) -> torch.Tensor:
    """The attention blocks and the final LayerNorm over embedded ``h``."""
    B, S = seq.shape
    d, H = cfg.embed_dim, cfg.n_heads
    dh = d // H
    pad = seq == 0
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


def encode(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
           impl: str = "cuda") -> torch.Tensor:
    """seq int32 [B, S] item ids (0 = padding) -> hidden states [B, S, d]."""
    return _blocks(params, cfg, seq, embed(params, cfg, seq, impl))


# ---------------------------------------------------------------------------
# training: the BCE loss over (positive, negative) next items
# ---------------------------------------------------------------------------

class TrainBatch(NamedTuple):
    """``(seq, pos, neg)`` int32 [B, S] (``pos == 0`` where padded) and,
    for the kernel route, their :func:`lookup_plan`."""
    seq: torch.Tensor
    pos: torch.Tensor
    neg: torch.Tensor
    plan: Optional[EdgePlan] = None


def lookup_plan(seq: torch.Tensor, pos: torch.Tensor, neg: torch.Tensor,
                n_rows: int) -> EdgePlan:
    """The plan of a batch's item lookups over a table of ``n_rows`` rows:
    lanes ``[seq (-1 at pads) | pos | neg]`` flattened, stable-sorted by
    item id with each id's ``row_ptr`` (the history's pads are not lanes).
    It holds ``(seq, pos, neg)`` and refuses another batch."""
    ids = torch.cat([_lookup_ids(seq).reshape(-1), pos.reshape(-1),
                     neg.reshape(-1)]).to(torch.int32)
    plan = edge_plan(ids, ids >= 0, n_rows)
    plan.built_from = (seq, pos, neg)
    return plan


class _ItemLookup(torch.autograd.Function):
    """(item_emb[seq] * w with 0 at the pads [B*S, d], item_emb[pos | neg]
    [2*B*S, d]) over the batch's plan; the gradient of the table is one sum
    by id of the three lookups' lane gradients (the history's times w)."""

    @staticmethod
    def forward(ctx, table, plan, w):
        ctx.plan, ctx.w = plan, w
        n = plan.dst.numel() // 3
        hist = embedding_bag(table, plan.dst[:n].reshape(n, 1), w)
        return hist, _gather(table, plan.dst[n:])

    @staticmethod
    def backward(ctx, g_hist, g_pn):
        if not ctx.needs_input_grad[0]:
            return None, None, None
        lanes = torch.cat([g_hist * ctx.w, g_pn])
        return lane_sum(ctx.plan, "dst", lanes), None, None


def _check_plan(plan: EdgePlan, seq, pos, neg, n_rows: int) -> None:
    if plan.n != n_rows or len(plan.built_from) != 3 or any(
            a is not b for a, b in zip(plan.built_from, (seq, pos, neg))):
        raise ValueError("lookup plan was built for another batch; build "
                         "one with lookup_plan(seq, pos, neg, n_rows)")


def loss_fn(params: Params, cfg: SASRecConfig, seq: torch.Tensor,
            pos: torch.Tensor, neg: torch.Tensor, impl: str = "cuda",
            plan: Optional[EdgePlan] = None) -> torch.Tensor:
    """BCE over (positive, negative) next items (paper Eq. 6), masked where
    ``pos == 0``.  The kernel route reads ``plan`` (made here when not
    given)."""
    table = params["item_emb"]
    if resolve_impl(impl) == "torch":
        h = encode(params, cfg, seq, "torch")
        pe, ne = table[pos.long()], table[neg.long()]
    else:
        if plan is None:
            plan = lookup_plan(seq, pos, neg, table.shape[0])
        _check_plan(plan, seq, pos, neg, table.shape[0])
        hist, pn = _ItemLookup.apply(table, plan, cfg.embed_dim ** 0.5)
        h = _blocks(params, cfg, seq, _place(params, seq, hist))
        pe, ne = pn.reshape((2,) + tuple(h.shape)).unbind(0)
    ps = torch.sum(h * pe, dim=-1).float()
    ns = torch.sum(h * ne, dim=-1).float()
    mask = pos != 0
    loss = -(F.logsigmoid(ps) + F.logsigmoid(-ns))
    return torch.where(mask, loss, 0.0).sum() / torch.clamp(mask.sum(),
                                                            min=1)


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
