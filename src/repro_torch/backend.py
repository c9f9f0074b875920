"""Device, ``impl=`` and kernel-build shim (the counterpart of ``repro.compat``).

* :func:`resolve_device` — entry points run on the card unless the caller
  names another device; with no CUDA and no device given they raise rather
  than quietly running on the host.
* :func:`resolve_impl` — the port's ``impl=`` convention: ``"torch"`` is the
  plain tensor-op oracle (the JAX package's ``"xla"``), ``"cuda"`` routes the
  ``combine="sum"`` sweeps, the LM's attention and the SASRec item
  lookups through the hand-written kernels (the chain walks of point
  reads, deletes and the sampler always take theirs on the card).  A kernel
  wrapper handed a CPU tensor runs the kernel's plain version (the analogue
  of Pallas interpret mode); handed a CUDA tensor it launches the kernel.
* :func:`load_kernels` — builds every ``csrc/*.cu`` with ``nvcc`` into
  ``build/repro_torch/`` at first use (one ``nvcc`` per source, all started
  together) and binds the plain C entry points through ``ctypes``.
* :data:`LAUNCHES` — one integer per kernel, bumped by its wrapper where it
  launches, so a run can show that its main path went through the kernel
  (a replayed CUDA graph, ``launch.serve.DecodeGraph``, adds the launches
  its capture counted); :data:`PLAN_BUILDS` and :data:`PLAN_PATCHES` count
  the engine's sweep plans built and patched the same way.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

IMPLS = ("torch", "cuda")

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# C signatures of the kernels' entry points: every pointer and the stream
# are c_void_p (a bare int would be cut to 32 bits), sizes are 64-bit
_VP, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_F32 = ctypes.c_float
_SIGNATURES = {
    # data_sorted, row_ptr, parts, carry scratch, out, num_rows, F, n_ctas,
    # stream
    "segment_sum": ("segment_sum_csr_f32", (_VP,) * 5 + (_I64, _I32, _I64,
                                                          _VP)),
    "block_gather": ("block_gather_f32", (_VP, _VP, _VP, _I64, _I64, _I64,
                                          _VP)),
    # the same entry point for the sweep plan's copy of the blocks in owner
    # order (``core.engine``), counted apart from the sweeps' gathers
    "plan_block_gather": ("block_gather_f32", (_VP, _VP, _VP, _I64, _I64,
                                               _I64, _VP)),
    # float32 on the tensor cores (split TF32): q, k, v, o, workspace,
    # workspace floats, B, H, KVH, S, D, (batch, head, row) strides of q, k
    # and v, scale, causal, window, softcap, stream
    "flash_attention": ("flash_attention_fwd",
                        (_VP,) * 5 + (_I64,) + (_I32,) * 5 + (_I64,) * 9
                        + (_F32, _I32, _I32, _F32, _VP)),
    # bf16 on the tensor cores: q, k, v, o, B, H, KVH, S, D, (batch, head,
    # row) strides of q, k and v, scale, causal, window, softcap, stream
    "flash_attention_wgmma": ("flash_attention_wgmma_bf16",
                              (_VP,) * 4 + (_I32,) * 5 + (_I64,) * 9
                              + (_F32, _I32, _I32, _F32, _VP)),
    # q, k_pages, v_pages, block_table, lengths, o, o_part, ml_part, dtype,
    # B, KVH, G, D, P, page, npmax, pages_per_split, scale, window, softcap,
    # stream
    "paged_attention": ("paged_attention_fwd",
                        (_VP,) * 8 + (_I32,) * 9 + (_F32, _I32, _F32, _VP)),
    # table, ids, weights (one a slot, or NULL), weight (every slot's when
    # NULL), row_ptr (or NULL), out, num_bags, bag_len, F, V, stream
    "embedding_bag": ("embedding_bag_f32",
                      (_VP,) * 3 + (_F32, _VP, _VP, _I64, _I64, _I32, _I64,
                                    _VP)),
    # keys, nxt, v_head, qsrc, qdst, active, fblk, flane, n, width, NV,
    # stream
    "chain_walk_locate": ("chain_walk_locate",
                          (_VP,) * 8 + (_I64, _I32, _I32, _VP)),
    # keys, count, nxt, heads, ranks, out, V, k, width, stream
    "chain_walk_rank": ("chain_walk_rank",
                        (_VP,) * 6 + (_I64, _I32, _I32, _VP)),
    # src, row_ptr, rdst, rsrc, pos, found, n, stream
    "plan_patch_locate": ("plan_patch_locate", (_VP,) * 6 + (_I64, _VP)),
    # src, w, V, pos, cum_found, cum_ins, rsrc, rw, n, tile_lo, new_src,
    # new_w, stream
    "plan_patch_merge": ("plan_patch_merge",
                         (_VP, _VP, _I64) + (_VP,) * 5
                         + (_I64,) + (_VP,) * 4),
}
# the source of a kernel whose name is not its source's stem
_SOURCES = {"plan_block_gather": "block_gather",
            "chain_walk_locate": "chain_walk",
            "chain_walk_rank": "chain_walk",
            "plan_patch_locate": "plan_patch",
            "plan_patch_merge": "plan_patch"}

# C functions that size a kernel's buffers and launch nothing: name ->
# (source, symbol, argument types), each returning a 64-bit count
_QUERIES = {
    # floats of the float32 flash kernel's workspace: B, H, KVH, S, D
    "flash_attention_workspace": ("flash_attention",
                                  "flash_attention_workspace_floats",
                                  (_I32,) * 5),
    # tiles of the plan patch's merge over V old lanes (its scratch holds
    # one int more): V
    "plan_patch_tiles": ("plan_patch", "plan_patch_tiles", (_I64,)),
}

# the element-type flag of the attention kernels' entry points
DTYPE_FLAGS = {torch.float32: 0, torch.bfloat16: 1}

LAUNCHES: Dict[str, int] = {name: 0 for name in _SIGNATURES}
# sweep plans built (``core.engine.sweep_plan``): one per ``run_program`` of
# a program with a sum sweep on the kernel route, save where a plan kept
# across snapshots is patched instead (``PLAN_PATCHES``)
PLAN_BUILDS = 0
PLAN_PATCHES = 0

_kernels: Dict[str, ctypes._CFuncPtr] = {}
_queries: Dict[str, ctypes._CFuncPtr] = {}
last_build_seconds: Optional[float] = None
# seconds from the start of the last build to each source's library
last_build_seconds_by_source: Dict[str, float] = {}


def reset_launch_counts() -> None:
    """Every kernel's launch count and the plan counts back to 0."""
    global PLAN_BUILDS, PLAN_PATCHES
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    PLAN_BUILDS = PLAN_PATCHES = 0


def resolve_device(device=None) -> torch.device:
    """``device`` as a :class:`torch.device`; ``None`` means the card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the host")
    return torch.device("cuda")


def resolve_impl(impl: str) -> str:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def library_path(name: str) -> Path:
    """The shared library that :func:`build_kernels` builds from
    ``csrc/<name>.cu``."""
    return _library_path(CSRC / f"{name}.cu")


def build_kernels() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library yet.

    The sources are compiled in parallel, each into its own shared library
    named by the hash of its text, so an edited source is never served a
    stale build.  Raises with the compiler's output when any build fails.
    """
    global last_build_seconds
    t0 = time.perf_counter()
    last_build_seconds_by_source.clear()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for src in sorted(CSRC.glob("*.cu")):
        out = _library_path(src)
        libs[src.stem] = out
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failures = []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        last_build_seconds_by_source[src.stem] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"{src.name}:\n{log}")
        else:
            tmp.replace(out)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    last_build_seconds = time.perf_counter() - t0
    return libs


def load_kernels() -> Dict[str, ctypes._CFuncPtr]:
    """Build (if needed) and bind every kernel; cached for the process."""
    if _kernels:
        return _kernels
    libs = build_kernels()
    for name, (symbol, argtypes) in _SIGNATURES.items():
        lib = ctypes.CDLL(str(libs[_SOURCES.get(name, name)]))
        fn = getattr(lib, symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _kernels[name] = fn
    for name, (source, symbol, argtypes) in _QUERIES.items():
        fn = getattr(ctypes.CDLL(str(libs[source])), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_longlong
        _queries[name] = fn
    return _kernels


def query(name: str, *args) -> int:
    """Call the sizing function ``name`` of :data:`_QUERIES` (no launch,
    no launch count)."""
    load_kernels()
    return int(_queries[name](*args))


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream; raise on a CUDA error."""
    fn = load_kernels()[name]
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
