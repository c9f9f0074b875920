"""Plain torch versions of paged decode attention.

* :func:`paged_attention_ref` — the kernel's oracle: gather each sequence's
  pages densely, then masked softmax attention in float32, as
  ``repro.kernels.paged_attention.ref.paged_attention_ref``;
* :func:`paged_attention_split_ref` — the split kernel's arithmetic: a
  partial ``(m, l, acc)`` per split of ``pages_per_split`` table slots, the
  partials merged in split order.

Block-table entries are clamped into ``[0, P)``: ``-1`` reads page 0 and an
id ``>= P`` page ``P - 1``, as the JAX kernel's clamped page fetch does.
"""
import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _scores(q, k_pages, v_pages, block_table, lengths, scale, window,
            softcap):
    """(masked scores [B, KVH, G, NP * page], V [B, KVH, NP * page, D]),
    both float32."""
    B, KVH, G, D = q.shape
    P, page = k_pages.shape[1], k_pages.shape[2]
    NP = block_table.shape[1]
    bt = block_table.long().clamp(0, P - 1)
    k = k_pages[:, bt].movedim(0, 1).reshape(B, KVH, NP * page, D)
    v = v_pages[:, bt].movedim(0, 1).reshape(B, KVH, NP * page, D)
    s = torch.einsum("bhgd,bhkd->bhgk", q.float(), k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    ki = torch.arange(NP * page, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    mask = ki < lens
    if window > 0:
        mask &= ki >= lens - window
    return torch.where(mask[:, None, None, :], s, NEG_INF), v.float()


def paged_attention_ref(q, k_pages, v_pages, block_table, lengths, *,
                        scale, window=0, softcap=0.0):
    """q [B, KVH, G, D]; pages [KVH, P, page, D]; block_table i32[B, NP];
    lengths i32[B] -> [B, KVH, G, D] in q's dtype."""
    s, v = _scores(q, k_pages, v_pages, block_table, lengths, scale,
                   window, softcap)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bhkd->bhgd", p, v).to(q.dtype)


def paged_attention_split_ref(q, k_pages, v_pages, block_table, lengths, *,
                              scale, window=0, softcap=0.0,
                              pages_per_split):
    """:func:`paged_attention_ref`'s value by the split kernel's arithmetic.

    Split ``s`` covers the slots ``[s * pps, (s + 1) * pps)``.  It visits
    those of its slots that hold live keys (from the window's first page to
    ``ceil(len / page)``), or every slot when the sequence has no live key,
    and keeps the partial ``m = max score``, ``l = sum exp(score - m)``,
    ``acc = sum exp(score - m) v`` over them (``m = -inf``, ``l = 0`` when it
    visits none).  The partials are merged in split order:
    ``sum_s w_s acc_s / sum_s w_s l_s`` with ``w_s = exp(m_s - max m)``.
    """
    B, KVH, G, D = q.shape
    page = k_pages.shape[2]
    NP = block_table.shape[1]
    pps = int(pages_per_split)
    n_split = -(-NP // pps)
    s, v = _scores(q, k_pages, v_pages, block_table, lengths, scale,
                   window, softcap)
    # the pages each sequence visits
    lens = lengths.long()[:, None]
    lo = (lens - window).clamp(min=0) if window > 0 else 0 * lens
    hi = lens.clamp(max=NP * page)
    any_live = lo < hi
    first = torch.where(any_live, lo // page, 0)
    last = torch.where(any_live, -(-hi // page), NP)
    slot = torch.arange(NP * page, device=q.device)[None, :] // page
    visited = (slot >= first) & (slot < last)                  # [B, NP*page]
    s = torch.where(visited[:, None, None, :], s, float("-inf"))
    pad = (n_split * pps - NP) * page
    s = F.pad(s, (0, pad), value=float("-inf")).reshape(
        B, KVH, G, n_split, pps * page)
    v = F.pad(v, (0, 0, 0, pad)).reshape(B, KVH, n_split, pps * page, D)
    m = s.amax(dim=-1)                                         # [B,KVH,G,S]
    p = torch.exp(s - torch.where(m == float("-inf"), 0.0, m)[..., None])
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgsk,bhskd->bhgsd", p, v)
    m_all = torch.where(l > 0, m, float("-inf")).amax(dim=-1)  # [B,KVH,G]
    o = torch.zeros_like(acc[..., 0, :])
    l_all = torch.zeros_like(l[..., 0])
    for i in range(n_split):
        w = torch.where(l[..., i] > 0, torch.exp(m[..., i] - m_all), 0.0)
        l_all = l_all + l[..., i] * w
        o = o + acc[..., i, :] * w[..., None]
    return (o / l_all.clamp(min=1e-30)[..., None]).to(q.dtype)
