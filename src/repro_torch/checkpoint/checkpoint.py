"""Async checkpointing of parameter trees, as ``repro.checkpoint``.

Layout: <dir>/step_<n:09d>/
  manifest.json          — leaf paths, shapes, dtypes, step
  <leaf-index>.npy       — one file per leaf

Leaves are numbered in JAX's flatten order (``repro_torch.tree``: dict keys
sorted) and carry the same path strings, so either package restores what
the other wrote, bit for bit.  ``restore`` maps files to the template's
leaves by index and puts them on ``device`` (the card unless the caller
names another), where the JAX package takes a sharding tree.

A ``layout`` is written where the port's tree and the JAX package's differ
in shape: it maps the tree with every leaf replaced by its flatten index to
the tree that is written, whose leaves are those indices or
:class:`Stacked` groups of them (``interop.lm_checkpoint_layout``: the LM's
layer list as JAX's period-stacked ``periods/l{i}`` plus ``tail``).  A
stacked leaf is assembled on the host copy, each of its parts copied from
the device straight into its slice, and ``restore`` with the same layout
cuts it back into the template's leaves.

Async: ``save_async`` copies every leaf to host memory on the caller's
thread (the step barrier) and writes the files on a background thread, so
training overlaps the write.

A state placed on a mesh (DTensor leaves, ``runtime/elastic.py``) is
written as its logical arrays: every rank of the process group calls
``save`` (each DTensor is gathered whole, a collective) and rank 0 writes.
``restore`` reads plain tensors; ``runtime.elastic.reshard_state`` places
them on the new mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as T
from repro_torch.backend import resolve_device


# numpy has no bfloat16: a bf16 leaf is written as 2-byte void records
# (the bytes and the ``.npy`` header JAX's ml_dtypes arrays get) and
# named "bfloat16" in the manifest, as the JAX package names it
_BF16_NPY = np.dtype("V2")


class Stacked:
    """A written leaf that stacks several leaves of the tree (by flatten
    index, in order) along a new first axis."""

    __slots__ = ("indices",)

    def __init__(self, indices):
        self.indices = tuple(indices)


def _numpy(host: torch.Tensor) -> np.ndarray:
    if host.dtype == torch.bfloat16:
        return host.view(torch.int16).numpy().view(_BF16_NPY)
    return host.numpy()


def _whole(leaf):
    """A DTensor leaf gathered whole (a collective over its mesh); any other
    leaf as it is."""
    if dist.is_available() and dist.is_initialized():
        from torch.distributed.tensor import DTensor
        if isinstance(leaf, DTensor):
            return leaf.full_tensor()
    return leaf


def _writes() -> bool:
    """Whether this process writes: rank 0 of a process group, or a process
    with none."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def _to_host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return _numpy(leaf.detach().to("cpu", copy=True))
    return np.array(leaf)


def _stack_to_host(parts: List[Any]) -> np.ndarray:
    """``parts`` stacked on the host: each tensor copied from its device
    into its slice of one host array, with no stacked copy on the device."""
    if not all(isinstance(x, torch.Tensor) for x in parts):
        return np.stack([np.asarray(x) for x in parts])
    out = torch.empty((len(parts),) + tuple(parts[0].shape),
                      dtype=parts[0].dtype)
    for row, x in zip(out, parts):
        row.copy_(x.detach())
    return _numpy(out)


def _dtype_name(a: np.ndarray) -> str:
    return "bfloat16" if a.dtype == _BF16_NPY else str(a.dtype)


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _treedef(tree) -> str:
    """The tree's structure with ``*`` for each leaf (for the reader; restore
    takes the structure from its template)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{k}={_treedef(v)}" for k, v in zip(tree._fields, tree)) + ")"
    if isinstance(tree, (list, tuple)):
        inner = ", ".join(_treedef(v) for v in tree)
        return f"[{inner}]" if isinstance(tree, list) else f"({inner})"
    return "*"


def _write(out: Path, step: int, paths: List[str], host: List[np.ndarray],
           treedef: str) -> Path:
    tmp = out.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    manifest = {"step": step, "leaves": [], "treedef": treedef}
    for i, (p, a) in enumerate(zip(paths, host)):
        np.save(tmp / f"{i}.npy", a)
        manifest["leaves"].append({"path": p, "shape": list(a.shape),
                                   "dtype": _dtype_name(a)})
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if out.exists():
        shutil.rmtree(out)
    tmp.rename(out)                                     # atomic publish
    return out


def _written(tree: Any, layout: Optional[Callable]):
    """(paths, groups, treedef) of what a checkpoint of ``tree`` holds:
    each group the flatten index of one leaf of ``tree``, or a
    :class:`Stacked` of several."""
    n = len(T.leaves(tree))
    if layout is None:
        return T.flatten_with_paths(tree)[0], list(range(n)), _treedef(tree)
    saved = layout(T.unflatten(tree, range(n)))
    paths, groups = T.flatten_with_paths(saved)
    return paths, groups, _treedef(saved)


def _host_copy(tree: Any, layout: Optional[Callable]):
    """(paths, host arrays, treedef): the step barrier's copy."""
    paths, groups, treedef = _written(tree, layout)
    leaves = [_whole(x) for x in T.leaves(tree)]
    host = [_stack_to_host([leaves[i] for i in g.indices])
            if isinstance(g, Stacked) else _to_host(leaves[g])
            for g in groups]
    return paths, host, treedef


def save(ckpt_dir: str | os.PathLike, step: int, tree: Any,
         layout: Optional[Callable] = None) -> Path:
    """Synchronous checkpoint write; returns the step directory."""
    paths, host, treedef = _host_copy(tree, layout)
    out = Path(ckpt_dir) / f"step_{step:09d}"
    return _write(out, step, paths, host, treedef) if _writes() else out


class AsyncCheckpointer:
    """Orbax-style async writer: snapshot on-thread, persist off-thread;
    keeps the newest ``keep`` checkpoints, each in ``layout``.
    ``write_seconds`` holds each finished write's time on the writer
    thread."""

    def __init__(self, ckpt_dir: str | os.PathLike, keep: int = 3,
                 layout: Optional[Callable] = None):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self.layout = layout
        self.write_seconds: List[float] = []
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None

    def wait(self):
        """Join the write in flight; re-raise its error, if it failed."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Any):
        self.wait()                                     # one in flight
        paths, host, treedef = _host_copy(tree, self.layout)   # barrier
        if not _writes():
            return

        def write():
            try:
                t0 = time.perf_counter()
                _write(self.ckpt_dir / f"step_{step:09d}", step, paths,
                       host, treedef)
                self.write_seconds.append(time.perf_counter() - t0)
                self._gc()
            except Exception as e:                      # raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = sorted(self.ckpt_dir.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)


def latest_step(ckpt_dir: str | os.PathLike) -> Optional[int]:
    steps = sorted(Path(ckpt_dir).glob("step_*"))
    if not steps:
        return None
    return int(steps[-1].name.split("_")[1])


def restore(ckpt_dir: str | os.PathLike, template: Any,
            step: Optional[int] = None, device=None,
            layout: Optional[Callable] = None) -> Any:
    """Restore into the structure of ``template``, every leaf a tensor on
    ``device``: leaf ``i`` from file ``i``, or, with a ``layout``, from
    where that layout writes it (a stacked file cut back into its
    leaves)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    dev = resolve_device(device)
    src = Path(ckpt_dir) / f"step_{step:09d}"
    manifest = json.loads((src / "manifest.json").read_text())
    _, groups, _ = _written(template, layout)
    n = len(manifest["leaves"])
    if n != len(groups):
        raise ValueError(f"checkpoint {src} holds {n} leaves, the template "
                         f"{len(groups)}")
    out: List[Any] = [None] * len(T.leaves(template))
    for i, (g, leaf) in enumerate(zip(groups, manifest["leaves"])):
        a = np.load(src / f"{i}.npy")
        if not isinstance(g, Stacked):
            out[g] = _from_host(a, leaf["dtype"]).to(dev)
            continue
        if a.shape[:1] != (len(g.indices),):
            raise ValueError(f"checkpoint {src} leaf {leaf['path']} stacks "
                             f"{a.shape[:1]}, the template "
                             f"{len(g.indices)} leaves")
        for part, j in zip(a, g.indices):
            out[j] = _from_host(part, leaf["dtype"]).to(dev)
    return T.unflatten(template, out)
