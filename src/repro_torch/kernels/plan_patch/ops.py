"""Wrappers of the sweep-plan patch kernels (``csrc/plan_patch.cu``).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
Neither synchronises the host: the caller sizes the new stream.
"""
from __future__ import annotations

import torch

from repro_torch import backend
from repro_torch.kernels.plan_patch.ref import (locate_lanes_ref,
                                                merge_lanes_ref)

INT32_MAX = torch.iinfo(torch.int32).max


def _check(what: str, tensors: dict) -> torch.device:
    dev = None
    for name, x in tensors.items():
        want = torch.float32 if name in ("w", "rw") else torch.int32
        if x.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {x.dtype}")
        if x.dim() != 1 or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be 1-D and contiguous")
        if x.numel() > INT32_MAX:
            raise ValueError(f"{what}: {name} has more than INT32_MAX "
                             "entries")
        if dev is None:
            dev = x.device
        elif x.device != dev:
            raise ValueError(f"{what}: {name} on {x.device}, not {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def locate_lanes(src: torch.Tensor, row_ptr: torch.Tensor,
                 rdst: torch.Tensor, rsrc: torch.Tensor):
    """``(pos i32[K], found bool[K])`` of the records ``(rdst, rsrc)`` in a
    lanes stream sorted by (dst, src) (see :func:`locate_lanes_ref`);
    every ``rdst`` must lie in ``[0, len(row_ptr) - 1)``."""
    dev = _check("locate_lanes", dict(src=src, row_ptr=row_ptr, rdst=rdst,
                                      rsrc=rsrc))
    if rdst.shape != rsrc.shape:
        raise ValueError("locate_lanes: rdst and rsrc differ in length")
    if dev.type == "cpu":
        return locate_lanes_ref(src, row_ptr, rdst, rsrc)
    n = rdst.numel()
    pos = torch.empty(n, dtype=torch.int32, device=dev)
    found = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        backend.launch("plan_patch_locate", src.data_ptr(),
                       row_ptr.data_ptr(), rdst.data_ptr(), rsrc.data_ptr(),
                       pos.data_ptr(), found.data_ptr(), n)
    return pos, found


def merge_lanes(src: torch.Tensor, w: torch.Tensor, pos: torch.Tensor,
                cum_found: torch.Tensor, cum_ins: torch.Tensor,
                rsrc: torch.Tensor, rw: torch.Tensor, num_lanes: int):
    """The patched ``(src, w)`` streams of ``num_lanes`` lanes (see
    :func:`merge_lanes_ref`); ``pos`` ascending, ``cum_found`` and
    ``cum_ins`` one longer than it."""
    dev = _check("merge_lanes", dict(src=src, w=w, pos=pos,
                                     cum_found=cum_found, cum_ins=cum_ins,
                                     rsrc=rsrc, rw=rw))
    n = pos.numel()
    if src.shape != w.shape or rsrc.numel() != n or rw.numel() != n \
            or cum_found.numel() != n + 1 or cum_ins.numel() != n + 1:
        raise ValueError("merge_lanes: inconsistent lengths")
    if not 0 <= num_lanes <= INT32_MAX:
        raise ValueError(f"merge_lanes: {num_lanes} lanes do not fit an "
                         "int32 stream")
    if dev.type == "cpu":
        return merge_lanes_ref(src, w, pos, cum_found, cum_ins, rsrc, rw,
                               num_lanes)
    new_src = torch.empty(num_lanes, dtype=torch.int32, device=dev)
    new_w = torch.empty(num_lanes, dtype=torch.float32, device=dev)
    tile_lo = torch.empty(backend.query("plan_patch_tiles", src.numel()) + 1,
                          dtype=torch.int32, device=dev)
    backend.launch("plan_patch_merge", src.data_ptr(), w.data_ptr(),
                   src.numel(), pos.data_ptr(), cum_found.data_ptr(),
                   cum_ins.data_ptr(), rsrc.data_ptr(), rw.data_ptr(), n,
                   tile_lo.data_ptr(), new_src.data_ptr(), new_w.data_ptr())
    return new_src, new_w
