"""Plain torch version of paged decode attention (the kernel's oracle):
gather each sequence's pages densely, then masked softmax attention in
float32, as ``repro.kernels.paged_attention.ref.paged_attention_ref``.

Block-table entries are clamped into ``[0, P)``: ``-1`` reads page 0 and an
id ``>= P`` page ``P - 1``, as the JAX kernel's clamped page fetch does.
"""
import torch

NEG_INF = -1e30


def paged_attention_ref(q, k_pages, v_pages, block_table, lengths, *,
                        scale, window=0, softcap=0.0):
    """q [B, KVH, G, D]; pages [KVH, P, page, D]; block_table i32[B, NP];
    lengths i32[B] -> [B, KVH, G, D] in q's dtype."""
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
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bhkd->bhgd", p, v.float()).to(q.dtype)
