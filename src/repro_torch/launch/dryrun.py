"""Multi-pod dry run on the host, as ``repro.launch.dryrun``: every (arch x
shape x mesh) cell of the registry built on the meta device and placed on
the production meshes of a fake process group.

The JAX package lowers and compiles each cell on 256 / 512 forced host
devices and reads XLA's memory and cost analyses.  The port has no
compiler to ask: it sets up the fake process group (``"fake"`` backend,
256 or 512 ranks, collectives that do nothing) in this process, builds the
16 x 16 and 2 x 16 x 16 meshes on it, places every argument and output
leaf by :mod:`repro_torch.distributed.sharding` and counts the step on meta
tensors (:mod:`repro_torch.launch.step_cost`).  Per cell it writes

  * ``n_devices`` and the mesh's shape,
  * argument and output bytes a device (rank 0's shards),
  * FLOPs a step (the whole global batch; rank 0's for an LM ``opt``
    cell, whose step runs on DTensors under the mesh),
  * collective bytes by kind (the LM ``opt`` cells),
  * ``argument_bytes_fit_h100_80gb``: argument bytes a device <= 80e9, a
    computed number, not a measurement,

into ``<out>/<arch>__<shape>__<mesh>[__opt].json`` (cells with a JSON are
skipped unless ``--force``).  Temporary memory, and the collective bytes
of a step on plain tensors, are ``null`` with the reason
(``step_cost.NOT_COUNTED``).  The fake group is
destroyed at the end.  A process holds one default process group, so this
refuses to run beside another (NCCL, gloo).

Usage:
  python -m repro_torch.launch.dryrun --all --mesh both --out DIR
  python -m repro_torch.launch.dryrun --arch gin-tu --shape molecule
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch import step_cost
from repro_torch.launch.mesh import make_production_mesh

OUT_DIR = Path("experiments/dryrun_torch")
H100_BYTES = 80 * 10 ** 9          # one H100's 80 GB of HBM3


def init_fake_group(world_size: int) -> None:
    """The fake process group of ``world_size`` ranks as this process's
    default group (rank 0)."""
    if dist.is_initialized():
        raise RuntimeError(
            "dryrun: a default process group exists already; the fake group "
            "needs a process of its own (one default group a process)")
    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def cell_tag(arch: str, shape: str, multi_pod: bool, opt: bool) -> str:
    tag = f"{arch}__{shape}__{'multipod' if multi_pod else 'pod'}"
    return tag.replace("/", "_") + ("__opt" if opt else "")


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path,
             force: bool = False, opt: bool = False,
             flops_cache: Optional[Dict] = None) -> dict:
    """One cell's record, written to ``out_dir``; the FLOP count is shared
    across meshes through ``flops_cache`` (it does not depend on the mesh,
    but an ``opt`` cell's config does)."""
    mesh_name = "multipod" if multi_pod else "pod"
    out_path = out_dir / f"{cell_tag(arch, shape, multi_pod, opt)}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    t0 = time.perf_counter()
    cb = registry.build_cell(arch, shape, opt=(mesh_name if opt else ""))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    t_build = time.perf_counter() - t0
    key = (arch, shape, cb.opt)
    cache = flops_cache if flops_cache is not None else {}
    if key not in cache:
        cache[key] = step_cost.step_flops(
            cb, mesh if step_cost.spmd_cell(cb) else None)
    cost = step_cost.cell_cost(cb, mesh, cache[key])
    record = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "opt": bool(opt),
        "kind": cb.kind, "family": cb.family,
        "n_devices": mesh.size(), "mesh_shape": list(mesh.shape),
        "timing": {"build_s": t_build,
                   "step_on_meta_s": cache[key]["seconds"],
                   "cost_s": time.perf_counter() - t0 - t_build},
        **cost,
        "argument_bytes_fit_h100_80gb":
            cost["argument_bytes_per_device"] <= H100_BYTES,
    }
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(record, indent=1))
    flops = record["flops_per_step"]
    print(f"[dryrun] {out_path.stem}: OK args/device="
          f"{record['argument_bytes_per_device'] / 1e9:.3f} GB "
          f"flops/step={'null' if flops is None else f'{flops:.3e}'}",
          flush=True)
    return record


def main(argv: Optional[List[str]] = None) -> List[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", choices=["pod", "multi", "both"], default="pod")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="the SPMD-optimized variant of each cell")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)
    out_dir = Path(args.out)

    meshes = {"pod": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    if args.all:
        cells = [(c.arch, c.shape) for c in registry.list_cells()
                 if c.skip_reason is None]
    else:
        cells = [(args.arch, args.shape)]

    init_fake_group(512 if True in meshes else 256)
    records, failures, flops_cache = [], [], {}
    t0 = time.perf_counter()
    try:
        for arch, shape in cells:
            for mp in meshes:
                try:
                    records.append(run_cell(arch, shape, mp, out_dir,
                                            force=args.force, opt=args.opt,
                                            flops_cache=flops_cache))
                except Exception as e:  # noqa: BLE001 -- record, continue
                    failures.append((arch, shape, mp, repr(e)))
                    print(f"[dryrun] {cell_tag(arch, shape, mp, args.opt)}: "
                          f"FAIL {e!r}", flush=True)
                    traceback.print_exc()
    finally:
        dist.destroy_process_group()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall requested dry-run cells placed and counted "
          f"({len(records)} records, {time.perf_counter() - t0:.1f} s)")
    return records


if __name__ == "__main__":
    main()
