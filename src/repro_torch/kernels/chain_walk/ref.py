"""Plain torch versions of the chain walks (the kernels' oracles).

Host loops: each step handles the walks still going and drops the rest
(one ``nonzero`` sync a step), so a step over a long hub chain touches just
the walks on it.
"""
import torch

NULL = -1


def locate_ref(keys: torch.Tensor, nxt: torch.Tensor, v_head: torch.Tensor,
               qsrc: torch.Tensor, qdst: torch.Tensor, active: torch.Tensor):
    """(found_blk, found_lane) of each (qsrc, qdst), NULL when absent.

    Each step binary-searches one block per query and follows the chain; the
    first block in chain order holding ``qdst`` wins.
    """
    B = keys.shape[1]
    dev = keys.device
    n = qsrc.shape[0]
    fblk = torch.full((n,), NULL, dtype=torch.int32, device=dev)
    flane = torch.full((n,), NULL, dtype=torch.int32, device=dev)
    nv = v_head.shape[0]
    if nv == 0:
        return fblk, flane
    cur = v_head[qsrc.clamp(0, nv - 1).long()]
    q = torch.nonzero(active & (cur != NULL)).squeeze(1)
    cur = cur[q]
    while q.numel() > 0:
        blk = cur.long()
        rows = keys[blk]
        d = qdst[q]
        pos = torch.searchsorted(rows, d[:, None].contiguous()).squeeze(1)
        val = torch.gather(rows, 1, pos.clamp(max=B - 1)[:, None]).squeeze(1)
        hit = (pos < B) & (val == d)
        # a query leaves the walk at its hit, so its slots are NULL until then
        fblk[q] = torch.where(hit, cur, NULL)
        flane[q] = torch.where(hit, pos.to(torch.int32), NULL)
        nx = nxt[blk]
        go = torch.nonzero(~hit & (nx != NULL)).squeeze(1)
        q, cur = q[go], nx[go]
    return fblk, flane


def rank_walk_ref(keys: torch.Tensor, count: torch.Tensor, nxt: torch.Tensor,
                  heads: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """out[v, j]: the key at rank ``ranks[v, j]`` of the chain from
    ``heads[v]`` (NULL for a NULL head or a rank past the chain)."""
    B = keys.shape[1]
    V, k = ranks.shape
    out = torch.full((V * k,), NULL, dtype=torch.int32, device=keys.device)
    cur = heads.repeat_interleave(k) if k else heads[:0]
    rem = ranks.reshape(-1)
    q = torch.nonzero(cur != NULL).squeeze(1)
    cur, rem = cur[q], rem[q]
    while q.numel() > 0:
        blk = cur.long()
        cnt = count[blk]
        here = rem < cnt
        lane = rem.clamp(0, B - 1).long()
        out[q[here]] = keys[blk[here], lane[here]]
        go = torch.nonzero(~here & (nxt[blk] != NULL)).squeeze(1)
        q, cur, rem = q[go], nxt[blk][go], (rem - cnt)[go]
    return out.reshape(V, k)
