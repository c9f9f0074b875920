"""Functional AdamW with optional 8-bit block-quantized moments, as
``repro.optim.adamw``.

Parameters, gradients and moments are trees of tensors (``repro_torch.tree``:
dicts and lists, walked in JAX's leaf order); every update returns new
tensors and changes none in place.  The 8-bit state is blockwise absmax
quantization (Dettmers-style): int8 codes in blocks of ``QBLOCK`` with one
float32 scale a block, each moment padded to a multiple of ``QBLOCK * 512``
(the JAX package pads so the block count divides every mesh data axis; the
port keeps the layout so the codes compare bit for bit).  ``torch.round``
rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tree as T

QBLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    quantized_state: bool = False     # 8-bit moments


# ---------------------------------------------------------------------------
# 8-bit blockwise quantization
# ---------------------------------------------------------------------------

def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32[N...] -> (int8 codes [blocks, QBLOCK], f32 per-block absmax
    scales [blocks])."""
    flat = x.reshape(-1)
    flat = F.pad(flat, (0, (-flat.shape[0]) % (QBLOCK * 512)))
    return _quantize_blocks(flat.reshape(-1, QBLOCK))


def _quantize_blocks(blocks: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    codes = torch.round(blocks / scale.clamp(min=1e-12)).to(torch.int8)
    return codes, scale[:, 0]


def _dequantize(codes: torch.Tensor, scale: torch.Tensor,
                shape) -> torch.Tensor:
    flat = (codes.to(torch.float32) * scale[:, None]).reshape(-1)
    n = 1
    for s in shape:
        n *= s
    return flat[:n].reshape(shape)


class QTensor(NamedTuple):
    qcodes: torch.Tensor   # int8 blockwise codes (the JAX package's names,
    qscale: torch.Tensor   # so checkpoint paths match)


def _q(x: torch.Tensor) -> QTensor:
    return QTensor(*_quantize(x))


def _dq(q: QTensor, shape) -> torch.Tensor:
    return _dequantize(q.qcodes, q.qscale, shape)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def init_opt_state(params, cfg: AdamWConfig):
    """Zero moments (8-bit when ``cfg.quantized_state``) and step 0 (int32,
    on the first parameter's device)."""
    zeros = T.tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                       params)
    if cfg.quantized_state:
        m = T.tree_map(_q, zeros)
        v = T.tree_map(_q, zeros)
    else:
        m, v = zeros, T.tree_map(torch.clone, zeros)
    device = T.leaves(params)[0].device
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state)."""
    step = state["step"] + 1
    b1c = 1.0 - cfg.b1 ** step.to(torch.float32)
    b2c = 1.0 - cfg.b2 ** step.to(torch.float32)
    lr = cfg.lr * lr_scale

    def moments(g, m, v):
        g = g.to(torch.float32)
        return (cfg.b1 * m + (1 - cfg.b1) * g,
                cfg.b2 * v + (1 - cfg.b2) * g * g)

    def new_param(p, m, v, b1c=b1c, b2c=b2c):
        mh = m / b1c
        vh = v / b2c
        p32 = p.to(torch.float32)
        return (p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                            + cfg.weight_decay * p32)).to(p.dtype)

    from torch.distributed.tensor import DTensor
    flat_p = T.leaves(params)
    flat_g = T.flatten_up_to(params, grads)
    flat_m = T.flatten_up_to(params, state["m"])
    flat_v = T.flatten_up_to(params, state["v"])
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if cfg.quantized_state and isinstance(p, DTensor):
            # 8-bit moments' flat blocks lie over the mesh in another
            # layout than the parameter's: each rank updates its own
            # blocks, the parameter's and gradient's elements there
            # brought to it and the new parameter's sent back
            ex = _exchange(p, m.qcodes)
            mf, vf = moments(ex.to_blocks(g), _dq_local(m), _dq_local(v))
            pf = new_param(ex.to_blocks(p), mf, vf, _local(b1c),
                           _local(b2c))
            new_p.append(ex.to_param(pf, p))
            new_m.append(ex.quantized(mf, m))
            new_v.append(ex.quantized(vf, v))
        elif cfg.quantized_state:
            m, v = moments(g, _dq(m, g.shape), _dq(v, g.shape))
            new_p.append(new_param(p, m, v))
            new_m.append(_q(m))
            new_v.append(_q(v))
        else:
            m, v = moments(g, m, v)
            new_p.append(new_param(p, m, v))
            new_m.append(m)
            new_v.append(v)
    return T.unflatten(params, new_p), {
        "m": T.unflatten(params, new_m), "v": T.unflatten(params, new_v),
        "step": step}


def _local(x):
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _dq_local(q: QTensor) -> torch.Tensor:
    """This rank's blocks of an 8-bit moment (DTensors), dequantized and
    flat."""
    codes, scale = q.qcodes.to_local(), q.qscale.to_local()
    return (codes.to(torch.float32) * scale[:, None]).reshape(-1)


def _box(shape, placements, mesh_shape, coord) -> list:
    """[(offset, size)] a tensor dim: the block of a DTensor of ``shape``
    and ``placements`` that the rank at mesh coordinate ``coord`` holds
    (Shard splits as ``torch.chunk``, nested in mesh-dim order)."""
    box = [(0, n) for n in shape]
    for i, pl in enumerate(placements):
        if pl.is_shard():
            off, n = box[pl.dim]
            step = -(-n // mesh_shape[i])
            lo = min(coord[i] * step, n)
            box[pl.dim] = (off + lo, min(lo + step, n) - lo)
    return box


def _below(box, shape, x: int) -> int:
    """The elements of ``box`` whose row-major flat index in ``shape`` is
    below x."""
    total = 1
    for _, n in box:
        total *= n
    if x >= math.prod(shape):
        return total
    idx = []
    for n in reversed(shape):
        idx.append(x % n)
        x //= n
    idx.reverse()
    count, inside = 0, 1
    for k, ((off, n), i) in enumerate(zip(box, idx)):
        rest = math.prod(b for _, b in box[k + 1:])
        count += inside * min(max(i - off, 0), n) * rest
        inside &= int(off <= i < off + n)
    return count


_EXCHANGES: dict = {}


def _exchange(p, codes) -> "_FlatExchange":
    """The :class:`_FlatExchange` of a leaf's layouts, made once a layout
    (the layers of a model share theirs)."""
    import torch.distributed as dist
    key = (p.device_mesh, dist.get_rank(), tuple(p.shape),
           tuple(p.placements), tuple(codes.shape), tuple(codes.placements),
           codes.to_local().device)
    if key not in _EXCHANGES:
        _EXCHANGES[key] = _FlatExchange(p, codes)
    return _EXCHANGES[key]


class _FlatExchange:
    """One 8-bit leaf's two layouts on the mesh: the parameter's blocks
    (``p``'s placements) and the moments' flat blocks (``codes``'
    placements, QBLOCK elements a row).  :meth:`to_blocks` brings the
    parameter's elements in this rank's flat range to it, :meth:`to_param`
    sends a flat range's elements back to the ranks whose blocks hold
    them; each is one all-to-all of about a block a rank.  A rank takes an
    element from a rank that holds it and agrees with it on the mesh dims
    that the sender's layout replicates.  The mesh's ranks are the world's
    in coordinate order (``init_device_mesh``, ``make_debug_mesh``).  It
    holds the layouts' arithmetic only, no mesh, so it can be kept a
    layout."""

    def __init__(self, p, codes):
        import itertools

        import torch.distributed as dist
        mesh = p.device_mesh
        ms = tuple(mesh.shape)
        if mesh.mesh.flatten().tolist() != list(range(
                dist.get_world_size())):
            raise ValueError("8-bit AdamW on DTensors wants a mesh over "
                             "the world's ranks in coordinate order")
        self.ms, self.shape = ms, tuple(p.shape)
        self.n, self.placements = p.numel(), p.placements
        self.coords = list(itertools.product(*map(range, ms)))
        self.rank_of = {c: r for r, c in enumerate(self.coords)}
        me = self.me = mesh.get_rank()
        mine = self.coords[me]
        self.boxes = [_box(self.shape, p.placements, ms, c)
                      for c in self.coords]
        rows = [_box(tuple(codes.shape), codes.placements, ms, c)[0]
                for c in self.coords]
        self.ranges = [(o * QBLOCK, (o + k) * QBLOCK) for o, k in rows]
        self.rows = rows[me][1]
        self.lo, self.hi = (min(x, self.n) for x in self.ranges[me])
        self.rep_p = [i for i, pl in enumerate(p.placements)
                      if not pl.is_shard()]
        rep_c = [i for i, pl in enumerate(codes.placements)
                 if not pl.is_shard()]
        world = range(len(self.coords))

        def agree(r, dims):
            return all(self.coords[r][i] == mine[i] for i in dims)
        # the parameter's elements to the flat blocks: from each rank that
        # agrees with me on the dims the parameter replicates, its
        # elements in my range; mine to the ranks that agree likewise
        self.recv_p = [self._cut(s, me) if agree(s, self.rep_p) else 0
                       for s in world]
        self.send_p = [self._cut(me, r) if agree(r, self.rep_p) else 0
                       for r in world]
        # where each rank's range starts in my block (a run in my order)
        self.starts = [_below(self.boxes[me], self.shape, self.ranges[r][0])
                       for r in world]
        # the flat blocks back to the parameter: to each rank that agrees
        # with me on the dims the moments replicate, its elements in my
        # range; from such ranks, my elements in theirs
        self.send_c = [self._cut(r, me) if agree(r, rep_c) else 0
                       for r in world]
        self.recv_c = [self._cut(me, r) if agree(r, rep_c) else 0
                       for r in world]
        # my range's elements sorted by the rank they come from (stable:
        # by index within a rank), the order the all-to-all delivers them
        f = torch.arange(self.lo, self.hi, dtype=torch.int64,
                         device=codes.to_local().device)
        lin = torch.zeros_like(f)
        for i, pl in enumerate(p.placements):
            if pl.is_shard():
                off, k, idx = self._left(pl.dim, i, f)
                step = torch.div(k + ms[i] - 1, ms[i],
                                 rounding_mode="floor").clamp(min=1)
                c = torch.div(idx - off, step, rounding_mode="floor")
            else:
                c = torch.full_like(f, mine[i])
            lin = lin * ms[i] + c
        self.order = torch.argsort(lin, stable=True)
        # the all-to-alls' index lists, each one gather a call
        dev, i64 = f.device, torch.int64

        def runs(starts, counts):
            return torch.cat([torch.arange(a, a + c, dtype=i64, device=dev)
                              for a, c in zip(starts, counts) if c]
                             or [f[:0]])
        self.send_p_idx = runs(self.starts, self.send_p)
        at = [0]
        for c in self.recv_p:
            at.append(at[-1] + c)
        # rank r's elements sit in the run of the rank with r's block that
        # agrees with me on the dims the parameter replicates
        src = [self.rank_of[tuple(mine[i] if i in self.rep_p else
                                  self.coords[r][i] for i in range(len(ms)))]
               for r in world]
        self.send_c_idx = self.order[runs([at[src[r]] for r in world],
                                          self.send_c)]
        # the runs I receive back tile my block in rank order: the ranks
        # that agree with me on the moments' replicated dims hold their
        # flat ranges in rank order
        tiled = [self.starts[r] for r in world if self.recv_c[r]]
        if tiled != sorted(tiled) or sum(self.recv_c) != math.prod(
                n for _, n in self.boxes[me]):
            raise ValueError("8-bit AdamW on DTensors: the moments' flat "
                             "blocks do not lie in the mesh's rank order")

    def _cut(self, s: int, r: int) -> int:
        """Elements of rank s's parameter block in rank r's flat range."""
        lo, hi = (min(x, self.n) for x in self.ranges[r])
        return (_below(self.boxes[s], self.shape, hi)
                - _below(self.boxes[s], self.shape, lo))

    def _left(self, dim: int, upto: int, f):
        """(offset, size) of tensor dim ``dim`` left to mesh dim ``upto``
        by the mesh dims before it that shard it, and the index in that
        dim, as tensors over the flat indices f."""
        off = torch.zeros_like(f)
        n = torch.full_like(f, self.shape[dim])
        idx = (f // math.prod(self.shape[dim + 1:])) % self.shape[dim]
        for i, pl in enumerate(self.placements[:upto]):
            if pl.is_shard() and pl.dim == dim:
                step = torch.div(n + self.ms[i] - 1, self.ms[i],
                                 rounding_mode="floor").clamp(min=1)
                c = torch.div(idx - off, step, rounding_mode="floor")
                lo = torch.minimum(c * step, n)
                off = off + lo
                n = torch.minimum(lo + step, n) - lo
        return off, n, idx

    @staticmethod
    def _all_to_all(x, send, recv):
        import torch.distributed as dist
        import torch.distributed._functional_collectives as funcol
        return funcol.all_to_all_single(x.contiguous(), recv, send,
                                        dist.group.WORLD)

    def to_blocks(self, x) -> torch.Tensor:
        """The DTensor x (the parameter's layout) as this rank's flat
        range of the padded moments (zeros past the leaf's elements)."""
        local = x.to_local().reshape(-1)
        got = self._all_to_all(local[self.send_p_idx], self.send_p,
                               self.recv_p)
        flat = local.new_zeros(self.rows * QBLOCK)
        flat[:self.hi - self.lo][self.order] = got
        return flat

    def to_param(self, flat: torch.Tensor, like):
        """This rank's flat range back in the parameter's layout: a
        DTensor placed as the parameter ``like``."""
        from torch.distributed.tensor import DTensor
        got = self._all_to_all(flat[self.send_c_idx], self.send_c,
                               self.recv_c)
        box = [k for _, k in self.boxes[self.me]]
        return DTensor.from_local(got.view(box), like.device_mesh,
                                  self.placements, shape=self.shape,
                                  stride=_contiguous_strides(self.shape))

    def quantized(self, flat: torch.Tensor, like: QTensor) -> QTensor:
        """This rank's flat range of a moment quantized (whole blocks, so
        bit for bit the whole moment's codes there), placed as ``like``."""
        from torch.distributed.tensor import DTensor
        codes, scale = _quantize_blocks(flat.view(-1, QBLOCK))
        return QTensor(*(DTensor.from_local(
            x, ref.device_mesh, ref.placements, shape=ref.shape,
            stride=ref.stride()) for x, ref in ((codes, like.qcodes),
                                                (scale, like.qscale))))


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(shape):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in T.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return T.tree_map(lambda g: g * scale, grads), n
