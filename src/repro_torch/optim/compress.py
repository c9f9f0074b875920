"""Gradient compression for cross-pod data parallelism, as
``repro.optim.compress``.

Top-k sparsification with error feedback (Deep Gradient Compression style)
plus int8 stochastic-rounding quantization.  Intended placement: between
the reduce-scatter inside a pod and the all-reduce between pods, so only
the pod-boundary hop is compressed.  The compressors are pure functions of
one tensor.

``topk_compress`` returns the kept values and their flat indices (int32)
sorted by magnitude, largest first, as ``lax.top_k`` does; on ties the
order may differ from JAX's.  ``int8_compress`` takes its noise: the JAX
function draws it from ``jax.random.uniform(key)``, a stream torch cannot
reproduce, so the caller passes the draw (uniform in [-0.5, 0.5), the
tensor's shape) or a ``torch.Generator`` to draw it from.  The arithmetic
is JAX's in float32 (``max|g| / 127 + 1e-12``, round half to even, clip to
+-127), so ``q`` and ``scale`` match JAX's bit for bit on the same noise.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch


class ErrorFeedback(NamedTuple):
    residual: torch.Tensor


def topk_compress(g: torch.Tensor, k_frac: float,
                  ef: ErrorFeedback | None = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, ErrorFeedback]:
    """Keep the top ``k_frac`` fraction of |g| entries; the rest accumulate
    in the error-feedback residual.  Returns (values, flat indices, new
    ef)."""
    flat = g.reshape(-1).to(torch.float32)
    if ef is not None:
        flat = flat + ef.residual
    k = max(1, int(flat.shape[0] * k_frac))
    idx = torch.topk(flat.abs(), k, sorted=True).indices
    sel = flat[idx]
    residual = flat.index_fill(0, idx, 0.0)
    return sel, idx.to(torch.int32), ErrorFeedback(residual)


def topk_decompress(vals: torch.Tensor, idx: torch.Tensor,
                    shape) -> torch.Tensor:
    n = 1
    for s in shape:
        n *= s
    out = torch.zeros((n,), dtype=torch.float32, device=vals.device)
    return out.index_copy_(0, idx.long(), vals).reshape(shape)


def int8_compress(g: torch.Tensor,
                  noise: Union[torch.Tensor, torch.Generator]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stochastic-rounding int8 with a per-tensor scale (unbiased).
    ``noise``: uniform in [-0.5, 0.5) of ``g``'s shape, or the generator
    (on ``g``'s device) to draw it from."""
    if isinstance(noise, torch.Generator):
        noise = torch.rand(g.shape, generator=noise, dtype=torch.float32,
                           device=g.device) - 0.5
    if noise.shape != g.shape:
        raise ValueError(f"int8_compress: noise {tuple(noise.shape)} is not "
                         f"g's shape {tuple(g.shape)}")
    scale = g.abs().max() / 127.0 + 1e-12          # in g's type, as JAX's
    q = torch.clamp(torch.round(g.to(torch.float32) / scale + noise),
                    -127, 127)
    return q.to(torch.int8), scale


def int8_decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale
