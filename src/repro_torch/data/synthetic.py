"""Synthetic data on the device: RMAT graphs, dynamic update streams, LM
token batches and SASRec training batches.

The port's own copy of the generators (the JAX package's are numpy on the
host and take minutes at LiveJournal size).  Same semantics, drawn from a
``torch.Generator`` on the device, so the numbers differ from numpy's for
the same seed:

* :func:`rmat_edges` — the same level-by-level quadrant draw and the same
  dedupe, which keeps the ``n_edges`` smallest ``src * nv + dst`` keys (so a
  heavily deduplicated graph leaves its high source ids without out-edges).
* :func:`update_stream` — vectorised: deletes drawn without replacement
  from the live edges, inserts drawn uniformly and redrawn until they are
  fresh, checked by ``searchsorted`` against the sorted int64 live keys.
* :func:`token_stream` — Zipf(1.3) tokens by numpy's rejection rule for
  ``Generator.zipf``, drawn in float64 on the device.
* :func:`sasrec_batches` — (seq, pos, neg) batches with item 0 as padding,
  right-padded to lengths uniform in ``seq // 2 .. seq`` as the JAX
  package's generator pads them.
"""
from __future__ import annotations

import math
from typing import Callable, Iterator, Optional, Tuple

import torch

from repro_torch.backend import resolve_device


def _generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def rmat_from_uniforms(draw: Callable[[int], torch.Tensor], n_vertices: int,
                       n_edges: int, *, a=0.57, b=0.19, c=0.19,
                       dedupe: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMAT from ``draw(level) -> uniforms[n_gen]``, one vector per level.

    ``n_gen`` is ``int(1.3 * n_edges)`` with dedupe, else ``n_edges``.
    """
    scale = max(1, int(math.ceil(math.log2(max(n_vertices, 2)))))
    src = dst = None
    for level in range(scale):
        r = draw(level)
        right = r >= a + b                        # dst high bit
        down = ((r >= a) & (r < a + b)) | (r >= a + b + c)
        if src is None:
            src = down.long()
            dst = right.long()
        else:
            src = src * 2 + down.long()
            dst = dst * 2 + right.long()
    src = src % n_vertices
    dst = dst % n_vertices
    if dedupe:
        key, order = torch.sort(src * n_vertices + dst, stable=True)
        first = torch.ones_like(key, dtype=torch.bool)
        first[1:] = key[1:] != key[:-1]
        idx = order[first][:n_edges]
        src, dst = src[idx], dst[idx]
    return src[:n_edges].to(torch.int32), dst[:n_edges].to(torch.int32)


def rmat_edges(n_vertices: int, n_edges: int, *, a=0.57, b=0.19, c=0.19,
               seed: int = 0, dedupe: bool = True, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """R-MAT power-law directed graph on ``device``; (src, dst) int32."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    n_gen = int(n_edges * 1.3) if dedupe else n_edges
    return rmat_from_uniforms(
        lambda level: torch.rand(n_gen, generator=gen, device=device),
        n_vertices, n_edges, a=a, b=b, c=c, dedupe=dedupe)


def _keys(src: torch.Tensor, dst: torch.Tensor, n_vertices: int):
    return src.long() * n_vertices + dst.long()


def update_stream(n_vertices: int,
                  existing: Tuple[torch.Tensor, torch.Tensor],
                  batch_size: int, n_batches: int, *,
                  delete_frac: float = 0.2, seed: int = 1,
                  device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                                 torch.Tensor, torch.Tensor]]:
    """Yields (src, dst, w, op) update batches (op: +1 insert / -1 delete).

    Inserts come first, then deletes.  Deletes are drawn without replacement
    from the edges live before the batch; inserts are uniform endpoint pairs
    that are neither live nor repeated within the batch.
    """
    device = resolve_device(device)
    gen = _generator(seed, device)
    live = torch.unique(_keys(existing[0].to(device), existing[1].to(device),
                              n_vertices))            # sorted, as a set
    for _ in range(n_batches):
        n_del = min(int(batch_size * delete_frac), live.numel())
        n_ins = batch_size - int(batch_size * delete_frac)
        dels = live[torch.randperm(live.numel(), generator=gen,
                                   device=device)[:n_del]]
        ins = _fresh_keys(live, n_ins, n_vertices, gen, device)
        keep = torch.ones_like(live, dtype=torch.bool)
        keep[torch.searchsorted(live, dels)] = False
        live, _ = torch.sort(torch.cat([live[keep], ins]))
        keys = torch.cat([ins, dels])
        src = (keys // n_vertices).to(torch.int32)
        dst = (keys % n_vertices).to(torch.int32)
        w = torch.rand(keys.numel(), generator=gen, device=device)
        op = torch.cat([torch.ones(ins.numel(), dtype=torch.int32,
                                   device=device),
                        -torch.ones(dels.numel(), dtype=torch.int32,
                                    device=device)])
        yield src, dst, w, op


def _fresh_keys(live: torch.Tensor, n: int, n_vertices: int,
                gen: torch.Generator, device: torch.device) -> torch.Tensor:
    """``n`` distinct uniform edge keys absent from the sorted ``live``,
    in draw order."""
    got: Optional[torch.Tensor] = None
    while got is None or got.numel() < n:
        need = n - (0 if got is None else got.numel())
        m = need + need // 8 + 16
        cand = _keys(torch.randint(0, n_vertices, (m,), generator=gen,
                                   device=device),
                     torch.randint(0, n_vertices, (m,), generator=gen,
                                   device=device), n_vertices)
        if got is not None:
            cand = torch.cat([got, cand])
        pos = torch.searchsorted(live, cand).clamp(max=max(live.numel() - 1,
                                                           0))
        fresh = (live[pos] != cand) if live.numel() else \
            torch.ones_like(cand, dtype=torch.bool)
        # first occurrence of each key, kept in draw order
        skey, order = torch.sort(cand, stable=True)
        first = torch.ones_like(skey, dtype=torch.bool)
        first[1:] = skey[1:] != skey[:-1]
        unique = torch.zeros_like(first)
        unique[order] = first
        got = cand[fresh & unique]
    return got[:n]


ZIPF_A = 1.3


def _zipf(n: int, a: float, gen: torch.Generator,
          device: torch.device) -> torch.Tensor:
    """``n`` Zipf(a) draws as int64: numpy's rejection rule (Devroye's),
    vectorised, redrawing the rejected lanes until none is left."""
    am1 = a - 1.0
    b = 2.0 ** am1
    out = torch.empty(n, dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u = 1.0 - torch.rand(m, generator=gen, dtype=torch.float64,
                             device=device)
        v = torch.rand(m, generator=gen, dtype=torch.float64, device=device)
        x = torch.floor(u ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1.0) & (x <= 2.0 ** 62) \
            & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = x[ok].to(torch.int64)
        todo = todo[~ok]
    return out


def token_stream(vocab: int, batch: int, seq: int, *, seed: int = 0,
                 device=None) -> Iterator[Tuple[torch.Tensor, torch.Tensor]]:
    """Zipf-ish token batches ``(tokens, labels)``, int32 [batch, seq], for
    LM training: labels are the tokens shifted by one."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    while True:
        z = _zipf(batch * (seq + 1), ZIPF_A, gen, device)
        toks = torch.minimum(z - 1, torch.tensor(vocab - 1, device=device))
        toks = toks.to(torch.int32).view(batch, seq + 1)
        yield toks[:, :-1], toks[:, 1:]


def sasrec_batches(n_items: int, batch: int, seq: int, *, seed: int = 0,
                   device=None
                   ) -> Iterator[Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]]:
    """``(seq, pos, neg)`` int32 [batch, seq] training batches; item 0 is
    padding, histories right-padded (``pos`` is ``seq`` shifted by one)."""
    device = resolve_device(device)
    gen = _generator(seed, device)
    while True:
        s = torch.randint(1, n_items + 1, (batch, seq + 1), generator=gen,
                          device=device, dtype=torch.int32)
        lengths = torch.randint(seq // 2, seq + 1, (batch,), generator=gen,
                                device=device)
        mask = torch.arange(seq, device=device)[None, :] < lengths[:, None]
        seq_in = torch.where(mask, s[:, :-1], 0)
        pos = torch.where(mask, s[:, 1:], 0)
        neg = torch.randint(1, n_items + 1, (batch, seq), generator=gen,
                            device=device, dtype=torch.int32)
        yield seq_in, pos, neg
