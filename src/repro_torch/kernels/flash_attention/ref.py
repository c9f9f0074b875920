"""Plain torch version of prefill attention (the kernel's oracle): dense
softmax attention with GQA, causal mask, sliding window and softcap, in
float32, as ``repro.kernels.flash_attention.ref.attention_ref``."""
import torch

NEG_INF = -1e30


def attention_ref(q, k, v, *, scale, causal=True, window=0, softcap=0.0,
                  q_start=0):
    """q [B, H, Sq, D]; k, v [B, KVH, S, D] -> [B, H, Sq, D] in q's dtype.
    Query row i sits at position ``q_start + i`` of the S keys' sequence
    (a block of a sequence sharded by position; Sq = S and 0 otherwise)."""
    B, H, Sq, D = q.shape
    KVH, S = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KVH, H // KVH, Sq, D)    # head h -> kv h // G
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qi = torch.arange(q_start, q_start + Sq, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    mask = torch.ones((Sq, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    return o.reshape(B, H, Sq, D).to(q.dtype)


def attention_ref_bf16_p(q, k, v, *, scale, causal=True, window=0,
                         softcap=0.0):
    """:func:`attention_ref` with the bf16 tensor-core kernel's rounding of
    P: p = exp(s - max) in float32, summed in float32 for the denominator
    and rounded to bf16 before P·V.  Not the kernel's bits (its running max
    rescales p tile by tile), but its arithmetic: each p̃ within 2^-8 · p of
    p, so the output within 2^-8 · max_k |v| before its own rounding."""
    B, H, S, D = q.shape
    KVH = k.shape[1]
    qg = q.float().reshape(B, KVH, H // KVH, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k.float()) * scale
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    pos = torch.arange(S, device=q.device)
    qi, ki = pos[:, None], pos[None, :]
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= ki
    if window > 0:
        mask &= (qi - ki) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(),
                     v.float()) / p.sum(dim=-1, keepdim=True)
    return o.reshape(B, H, S, D).to(q.dtype)
