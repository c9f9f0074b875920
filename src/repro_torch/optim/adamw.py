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
    blocks = flat.reshape(-1, QBLOCK)
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

    def new_param(p, m, v):
        mh = m / b1c
        vh = v / b2c
        p32 = p.to(torch.float32)
        return (p32 - lr * (mh / (torch.sqrt(vh) + cfg.eps)
                            + cfg.weight_decay * p32)).to(p.dtype)

    flat_p = T.leaves(params)
    flat_g = T.flatten_up_to(params, grads)
    flat_m = T.flatten_up_to(params, state["m"])
    flat_v = T.flatten_up_to(params, state["v"])
    new_p, new_m, new_v = [], [], []
    for p, g, m, v in zip(flat_p, flat_g, flat_m, flat_v):
        if cfg.quantized_state:
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


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in T.leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(n, min=1e-9), max=1.0)
    return T.tree_map(lambda g: g * scale, grads), n
