"""Prefill attention: the ``impl`` switch and the wrapper of the flash
kernels (``csrc/flash_attention_wgmma.cu`` for bf16,
``csrc/flash_attention.cu`` for float32).

``attention(..., impl="torch")`` is the plain version (the JAX package's
``impl="xla"``); ``impl="cuda"`` goes through :func:`flash_attention`, which
runs the plain version for a CPU tensor and launches a kernel for a CUDA
tensor.  Unlike the Pallas kernel, the CUDA ones take any S (they mask the
ragged tile) and q / k / v views whose last axis is contiguous.  Both run
on the tensor cores: bf16 as it is, float32 through split TF32 (each
operand as a TF32 high part and a TF32 remainder, three products for one).
"""
from __future__ import annotations

import torch

from repro_torch import backend
from repro_torch.kernels.flash_attention.ref import attention_ref

MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention wants q[B, H, S, D] and "
                         f"k, v[B, KVH, S, D], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (B, S, D) or \
            H % k.shape[1]:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"fit q {tuple(q.shape)}")
    if q.dtype not in backend.DTYPE_FLAGS or not q.dtype == k.dtype == \
            v.dtype:
        raise TypeError(f"flash_attention wants float32 or bfloat16 q, k, v "
                        f"of one type, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not q.device == k.device == v.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {D} > {MAX_HEAD_DIM}")


def _tma_view(x: torch.Tensor) -> tuple:
    """(x, its [batch, head, row] strides) as the tensor maps take them:
    16-byte aligned base and strides, else a contiguous copy.  A dimension
    of size 1 is never stepped, so its stride is reported as a packed one."""
    if x.stride(-1) != 1 or x.data_ptr() % 16 or any(
            x.stride(i) % 8 for i in range(3) if x.shape[i] > 1):
        x = x.contiguous()
    packed = (x.shape[1] * x.shape[2] * x.shape[3], x.shape[2] * x.shape[3],
              x.shape[3])
    return x, tuple(x.stride(i) if x.shape[i] > 1 else packed[i]
                    for i in range(3))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    scale: float, causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """q [B, H, S, D]; k, v [B, KVH, S, D] with H % KVH == 0 -> o [B, H, S, D].

    A CPU tensor takes the plain version; a CUDA tensor launches a kernel,
    chosen by dtype: bfloat16 goes to ``flash_attention_wgmma`` (wgmma and
    TMA, D a multiple of 8), float32 to ``flash_attention`` (split TF32 on
    wgmma: its prep kernels write hi / lo copies of q and k and of v
    transposed, zero-padded to the head-dim template, into a workspace this
    wrapper allocates at the size the C side gives, then the attention
    kernel runs).  That is a dispatch
    on the type, not a fallback: a call that cannot build or launch its
    kernel raises.  The kernels have no backward, so a call under autograd
    with a q, k or v that asks for a gradient raises too, on any device:
    training runs attention with ``impl="torch"``.
    """
    _check(q, k, v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        raise RuntimeError(
            "flash_attention: the flash kernels have no backward, so no "
            "gradient would reach q, k or v; train with impl='torch' (the "
            "plain version), or call under torch.no_grad()")
    if q.device.type in ("cpu", "meta"):
        # on meta (the dry run) the plain version's ops carry no data and
        # give the output's shape; a FLOP count sees the kernel's products
        # as the reference's full S x S einsums, the JAX package's count
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, H, S, D = q.shape
    if q.dtype == torch.bfloat16:
        if D % 8:
            raise ValueError(f"flash_attention: bf16 head_dim {D} is not a "
                             f"multiple of 8")
        (q, qs), (k, ks), (v, vs) = (_tma_view(x) for x in (q, k, v))
        o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
        backend.launch("flash_attention_wgmma", q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), o.data_ptr(), B, H, k.shape[1], S, D,
                       *qs, *ks, *vs, float(scale), int(bool(causal)),
                       int(window), float(softcap))
        return o
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    o = torch.empty((B, H, S, D), dtype=q.dtype, device=q.device)
    n_ws = backend.query("flash_attention_workspace", B, H, k.shape[1], S,
                         D)
    ws = torch.empty(n_ws, dtype=torch.float32, device=q.device)
    backend.launch("flash_attention", q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), o.data_ptr(), ws.data_ptr(), n_ws, B, H,
                   k.shape[1], S, D,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                   float(scale), int(bool(causal)), int(window),
                   float(softcap))
    return o


def attention(q, k, v, *, scale: float, causal: bool = True, window: int = 0,
              softcap: float = 0.0, impl: str = "cuda") -> torch.Tensor:
    """Prefill attention through the plain version or the flash kernel."""
    if backend.resolve_impl(impl) == "torch":
        return attention_ref(q, k, v, scale=scale, causal=causal,
                             window=window, softcap=softcap)
    return flash_attention(q, k, v, scale=scale, causal=causal,
                           window=window, softcap=softcap)
