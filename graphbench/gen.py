"""The benchmark's traffic: an R-MAT graph and a sliding window of edge
updates over it, all drawn on the device from ``--seed``.

The stream is one sequence ``S`` of edge keys ``src * nv + dst``: the
``E`` initial edges, then every insert in the order it is made.  Round
``j`` inserts ``S[E + j d : E + (j + 1) d]`` and deletes
``S[j d : (j + 1) d]`` (the oldest live edges, first in first out), so the
live set after ``k`` rounds is the window ``S[k d : E + k d]`` and holds
``E`` edges at every epoch.

Initial edges and inserts come from one process: R-MAT draws in draw
order, each key kept at its first draw, and an insert only where its key
is none of the ``E + d`` positions before it.  So keys are distinct inside
every window of ``E + d`` positions (a round's deletes, live edges and
inserts), and the initial graph and the inserts follow one distribution:
the graph does not drift as the window slides over it.

``S`` is made on the device a block of whole rounds at a time
(:meth:`Stream.ensure`), as far as the rounds asked for, so it never runs
out and holds no more than the run uses; a block that every round still
to come has passed moves to host memory, where only the check reads it.
Making a block, and moving one, is the harness's work, done between the
program's calls and never inside one.
"""
from __future__ import annotations

import hashlib
import math
from typing import Callable, Optional, Tuple

import torch

INSERT, DELETE = 1, -1
CHUNK = 1 << 25            # R-MAT draws made at once
BLOCK_KEYS = 1 << 25       # inserts made at a time, in whole rounds


def derived_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of ``seed``, so every generator of a run
    draws its own numbers and the same ``seed`` gives the same run."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derived_seed(seed, tag))
    return gen


def rmat_from_uniforms(draw: Callable[[int], torch.Tensor], n_vertices: int,
                       n_edges: int, *, a=0.57, b=0.19, c=0.19
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RMAT from ``draw(level) -> uniforms[n_gen]``, one vector per level:
    the quadrant of each level from one uniform, ids folded into
    ``n_vertices``, the first ``n_edges`` draws kept with their repeats.
    (A copy of the program's ``repro_torch.data.synthetic.
    rmat_from_uniforms`` with ``dedupe=False``, kept here so that the
    benchmark's graphs cannot change with the program; the stream keeps
    each key at its first draw, see :func:`fresh_block`.)"""
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
    return src[:n_edges].to(torch.int32), dst[:n_edges].to(torch.int32)


def rmat_keys(n: int, n_vertices: int, gen: torch.Generator, device, *,
              a: float, b: float, c: float) -> torch.Tensor:
    """``n`` raw R-MAT draws as int64 keys ``src * n_vertices + dst``
    (duplicates kept), made ``CHUNK`` at a time."""
    out = []
    for lo in range(0, n, CHUNK):
        m = min(CHUNK, n - lo)
        s, d = rmat_from_uniforms(
            lambda level: torch.rand(m, generator=gen, device=device),
            n_vertices, m, a=a, b=b, c=c)
        out.append(s.long() * n_vertices + d.long())
    return torch.cat(out) if out else torch.empty(0, dtype=torch.int64,
                                                   device=device)


def _first_absent(cand: torch.Tensor, taken: torch.Tensor) -> torch.Tensor:
    """Mask of the candidates absent from the sorted ``taken`` and first of
    their key among the candidates."""
    if taken.numel():
        pos = torch.searchsorted(taken, cand).clamp(max=taken.numel() - 1)
        fresh = taken[pos] != cand
    else:
        fresh = torch.ones_like(cand, dtype=torch.bool)
    skey, order = torch.sort(cand, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    unique = torch.empty_like(first)
    unique[order] = first
    return fresh & unique


def fresh_block(n: int, taken: torch.Tensor, n_vertices: int,
                gen: torch.Generator, device, *, a, b, c, oversample: float,
                relabel: Optional[Callable] = None) -> torch.Tensor:
    """``n`` distinct R-MAT keys (through ``relabel``), none in the sorted
    ``taken``, in draw order."""
    got = torch.empty(0, dtype=torch.int64, device=device)
    while got.numel() < n:
        need = n - got.numel()
        new = rmat_keys(int(need * oversample) + 1024, n_vertices, gen,
                        device, a=a, b=b, c=c)
        cand = torch.cat([got, relabel(new) if relabel else new])
        got = cand[_first_absent(cand, taken)]
    return got[:n]


def _merge(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The sorted union of the sorted, disjoint ``a`` and ``b``."""
    out = torch.empty(a.numel() + b.numel(), dtype=a.dtype, device=a.device)
    at = torch.searchsorted(a, b) + torch.arange(b.numel(), device=b.device)
    slot = torch.ones(out.numel(), dtype=torch.bool, device=a.device)
    slot[at] = False
    out[at] = b
    out[slot] = a
    return out


class Stream:
    """``S`` (see the module doc): made on ``device`` from the seed, kept as
    segments ``(start, src, dst, w)``, on the device while a round to come
    reads them, then in host memory.

    ``recent`` holds, sorted and on the device, the keys of the ``E + d``
    positions before the first one not made yet: what the next insert must
    differ from."""

    def __init__(self, config: dict, d: int, seed: int, device):
        nv, E = int(config["vertices"]), int(config["edges"])
        if not 0 < d <= E:
            raise ValueError(f"a round's {d} deletes must be 1..{E} live "
                             f"edges")
        q = config["rmat"]
        self.nv, self.edges, self.d, self.device = nv, E, d, device
        self.rmat = dict(a=float(q["a"]), b=float(q["b"]), c=float(q["c"]),
                         oversample=float(config["oversample"]))
        self.weights = tuple(float(x) for x in config["weights"])
        self.block = max(1, min(BLOCK_KEYS, E) // d) * d
        self.op = torch.cat([
            torch.full((d,), INSERT, dtype=torch.int32, device=device),
            torch.full((d,), DELETE, dtype=torch.int32, device=device)])
        self._wgen = generator(seed, "weights", device)
        self._igen = generator(seed, "inserts", device)
        self._relabel = None
        if config.get("permute_labels"):
            perm = torch.randperm(nv, generator=generator(seed, "labels",
                                                          device),
                                  device=device)
            self._relabel = lambda k: perm[k // nv] * nv + perm[k % nv]
        none = torch.empty(0, dtype=torch.int64, device=device)
        keys = fresh_block(E, none, nv,
                           generator(seed, "rmat", device), device,
                           relabel=self._relabel, **self.rmat)
        self.recent = torch.sort(keys)[0]
        self.segments = []
        self.initial = self._append(keys)

    @property
    def made(self) -> int:
        """Positions of ``S`` made so far."""
        return self.segments[-1][0] + self.segments[-1][1].numel()

    @property
    def rounds(self) -> int:
        """Rounds whose inserts are made."""
        return (self.made - self.edges) // self.d

    def _append(self, keys: torch.Tensor):
        """Store ``keys`` with fresh weights as the next positions of ``S``;
        ``(src, dst, w)`` on the device."""
        lo, hi = self.weights
        w = lo + (hi - lo) * torch.rand(keys.numel(), generator=self._wgen,
                                        device=self.device)
        out = ((keys // self.nv).to(torch.int32),
               (keys % self.nv).to(torch.int32), w)
        start = self.made if self.segments else 0
        self.segments.append((start, *out))
        return out

    def ensure(self, rounds: int) -> None:
        """Make blocks until the inserts of ``rounds`` rounds exist."""
        while self.rounds < rounds:
            self._extend()

    def _extend(self) -> None:
        E, d, P, b = self.edges, self.d, self.made, self.block
        keys = fresh_block(b, self.recent, self.nv, self._igen, self.device,
                           relabel=self._relabel, **self.rmat)
        # slide ``recent`` from S[P - E - d : P] to S[P + b - E - d : P + b]
        lo, hi = max(0, P - E - d), max(0, P + b - E - d)
        if hi > lo:
            s, t, _ = self.take(lo, hi)
            old = torch.sort(s.long() * self.nv + t.long())[0]
            keep = torch.ones_like(self.recent, dtype=torch.bool)
            keep[torch.searchsorted(self.recent, old)] = False
            self.recent = self.recent[keep]
        self.recent = _merge(self.recent, torch.sort(keys)[0])
        self._append(keys)

    def _parts(self, lo: int, hi: int):
        """The pieces of ``S[lo:hi]``: ``[src...], [dst...], [w...]``, each
        where its segment lies."""
        if not 0 <= lo <= hi <= self.made:
            raise IndexError(f"S[{lo}:{hi}] of {self.made} made")
        parts = [[], [], []]
        for start, *arrays in self.segments:
            a, b = max(lo, start), min(hi, start + arrays[0].numel())
            if a < b:
                for part, x in zip(parts, arrays):
                    part.append(x[a - start:b - start])
        return parts

    def take(self, lo: int, hi: int, device=None):
        """``(src, dst, w)`` of ``S[lo:hi]`` on ``device`` (the stream's
        own by default)."""
        device = device or self.device
        out = []
        for part, x in zip(self._parts(lo, hi), self.segments[0][1:]):
            part = [y.to(device) for y in part] or [x[:0].to(device)]
            out.append(torch.cat(part))
        return tuple(out)

    def batch(self, j: int, out=None):
        """Round ``j``'s batch on the device: its ``d`` inserts, then its
        ``d`` deletes, ``(src, dst, w)`` (into the tensors ``out``)."""
        self.ensure(j + 1)
        E, d = self.edges, self.d
        ins = self._parts(E + j * d, E + (j + 1) * d)
        dels = self._parts(j * d, (j + 1) * d)
        if out is None:
            return tuple(torch.cat(a + b) for a, b in zip(ins, dels))
        for o, a, b in zip(out, ins, dels):
            torch.cat(a + b, out=o)
        self._retire(j * d)
        return out

    def _retire(self, lo: int) -> None:
        """Move to host memory the segments that lie wholly below ``lo``,
        which no round from there on reads."""
        for i, (start, *arrays) in enumerate(self.segments):
            if start + arrays[0].numel() > lo:
                break
            if arrays[0].device.type != "cpu":
                self.segments[i] = (start, *(x.cpu() for x in arrays))

    def gather(self, pos: torch.Tensor):
        """``(src, dst, w)`` of ``S`` at the int64 positions ``pos``, on
        ``pos``'s device."""
        host = pos.cpu()
        starts = torch.tensor([s for s, *_ in self.segments])
        seg = torch.searchsorted(starts, host, right=True) - 1
        out = [torch.empty(host.numel(), dtype=x.dtype)
               for x in self.segments[0][1:]]
        for i, (start, *arrays) in enumerate(self.segments):
            m = seg == i
            idx = host[m] - start
            for o, x in zip(out, arrays):
                o[m] = x[idx.to(x.device)].cpu()
        return tuple(x.to(pos.device) for x in out)

    def live(self, k: int, device=None):
        """The live edges after ``k`` rounds, ``S[k d : E + k d]``, on
        ``device`` (the stream's own by default)."""
        return self.take(k * self.d, self.edges + k * self.d, device)


def make_stream(config: dict, d: int, seed: int, device):
    """``(stream, initial edges)``: the stream of rounds of ``d`` inserts
    and ``d`` deletes over the configuration's initial graph, from
    ``seed``; the initial edges ``(src, dst, w)`` on the device, in
    first-in-first-out order, for the store's build."""
    stream = Stream(config, d, seed, device)
    init, stream.initial = stream.initial, None     # the store's to keep
    return stream, init


def pick_source(init_src: torch.Tensor, nv: int, min_degree: int,
                seed: int) -> int:
    """A seeded vertex whose initial out-degree is at least ``min_degree``
    (the most-connected vertex when none is)."""
    deg = torch.bincount(init_src.long(), minlength=nv)
    cand = torch.nonzero(deg >= max(1, min_degree)).squeeze(1)
    if cand.numel() == 0:
        return int(torch.argmax(deg))
    gen = generator(seed, "source", "cpu")
    return int(cand[int(torch.randint(cand.numel(), (1,), generator=gen))])


def sample_positions(stream: Stream, k: int, n: int, seed: int,
                     device) -> torch.Tensor:
    """Positions of ``S`` whose keys the check reads back after ``k``
    rounds: ``n`` drawn from the live window, ``n`` from the deleted part,
    ``n // 4`` from the inserts made but not yet applied, and every key of
    the last round's batch."""
    gen = generator(seed, "check", device)
    d, E = stream.d, stream.edges
    end = stream.made
    parts = [torch.randint(k * d, E + k * d, (n,), generator=gen,
                           device=device)]
    if k:
        parts.append(torch.randint(0, k * d, (n,), generator=gen,
                                   device=device))
        last = k - 1
        parts.append(torch.arange(E + last * d, E + k * d, device=device))
        parts.append(torch.arange(last * d, k * d, device=device))
    if E + k * d < end:
        parts.append(torch.randint(E + k * d, end, (max(1, n // 4),),
                                   generator=gen, device=device))
    return torch.cat(parts)
