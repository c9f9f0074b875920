#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one CUDA device.

    python3 chip_smoke.py [--seed N] [--scale F] [--profile]

Phases, one report line each:

1. set-up: the card's name and power limit, the kernels' build, an RMAT
   graph the size of SNAP's soc-LiveJournal1 (4,847,571 vertices,
   68,993,773 edges) made on the device from ``--seed``, and
   ``GraphService.from_coo`` over it;
2. agreement on a small input: one update/read/analytics sequence on the
   card and on the host, stores bit-exact and analytics equal;
3. kernels against their plain versions at the service graph's shapes
   (push and pull F = 1, plus push_feat F = 16 on a 1/16-size graph):
   ``block_gather`` exact, ``segment_sum`` within rtol 1e-5 of a float64
   sum and bit-identical on a repeat, each timed beside its plain version,
   one PyTorch library call and its bytes bound;
4. the service's main path with every launch counter at 0: cold PageRank,
   BFS, SSSP and CC, three rounds of 1,000,000 updates (20 % deletes) through
   ``apply`` + ``flush`` with point reads of just-inserted and just-deleted
   pairs after each, then the same analytics warm;
5. checks: ranks sum to 1, PageRank with ``impl="torch"`` agrees with the
   kernel path, both kernels launched on the main path.

The last two lines are the ``kernels`` JSON object and the device line.  It
exits non-zero, printing no result, without a CUDA device or without the
repository's ``src/`` beside it.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
LJ_VERTICES, LJ_EDGES = 4_847_571, 68_993_773      # SNAP soc-LiveJournal1
HBM_BYTES_PER_S = 3.35e12                          # H100 SXM, 700 W
FP32_OPS_PER_S = 67e12                             # non-tensor float32 peak
UPDATES_PER_ROUND, ROUNDS, DELETE_FRAC = 1_000_000, 3, 0.2
READ_PAIRS = 65_536
SEG_RTOL, SEG_ATOL = 1e-5, 1e-6


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of ``fn`` per call: CUDA events around ``reps`` calls
    after a warm-up."""

    def __init__(self, torch):
        self.torch = torch

    def sync(self):
        self.torch.cuda.synchronize()

    def ms(self, fn, reps: int = 5) -> float:
        fn()
        self.sync()
        start = self.torch.cuda.Event(enable_timing=True)
        end = self.torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def wall(self, fn):
        """(result, seconds) of one call, synchronised on both ends."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0


def profiled(torch, fn, top: int = 15):
    """(result, summary) of one call of ``fn`` under ``torch.profiler``:
    device time by op, the device's busy share of the wall time, and the
    call counts of the ops that mark host-loop steps."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    kernels = [e for e in events
               if "CUDA" in str(getattr(e, "device_type", ""))]
    dev = [(e.key, e.count, e.self_device_time_total)
           for e in (kernels or events) if e.self_device_time_total > 0]
    dev.sort(key=lambda r: -r[2])
    busy_us = sum(r[2] for r in dev)
    calls = {e.key: e.count for e in events
             if e.key in ("aten::searchsorted", "aten::nonzero", "aten::sort",
                          "aten::item", "aten::_local_scalar_dense")}
    return out, dict(wall_s=wall, device_busy_s=busy_us / 1e6,
                     device_busy_share=busy_us / 1e6 / wall,
                     host_calls=calls,
                     top=[dict(op=k, count=c, device_ms=t / 1e3)
                          for k, c, t in dev[:top]])


def bound_ms(nbytes: float, ops: float) -> tuple:
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(by_bytes, by_ops) * 1e3, ("bytes" if by_bytes >= by_ops
                                          else "operations")


# ---------------------------------------------------------------------------
# kernels against their plain versions
# ---------------------------------------------------------------------------

def sweep_inputs(torch, cbl, x):
    """The engine's kernel inputs for one push, pull and (2-D x) push_feat
    sweep over ``cbl``: ((gather table, ids), (segment data, seg))."""
    from repro_torch.core.traversal import lane_mask
    st = cbl.store
    nv = cbl.capacity_vertices
    mask = lane_mask(st)
    owner = st.owner.clamp(min=0).contiguous()
    table = x.reshape(nv, -1).contiguous()
    xs = table[owner.long()]
    if table.shape[1] == 1:
        msg = torch.where(mask, xs * st.vals, 0.0).reshape(-1, 1)
    else:
        msg = (xs[:, None, :] * torch.where(mask, st.vals, 0.0)[:, :, None]
               ).reshape(-1, table.shape[1])
    seg = torch.where(mask, st.keys, nv).reshape(-1).contiguous()
    return (table, owner), (msg.contiguous(), seg)


def time_segment_sum(torch, timer, name, data, seg, num_rows):
    from repro_torch.kernels.segment_matmul.ops import (segment_matmul,
                                                        segment_sum_sorted,
                                                        sorted_layout)
    from repro_torch.kernels.segment_matmul.ref import segment_sum_ref
    got = segment_matmul(data, seg, num_rows)
    again = segment_matmul(data, seg, num_rows)
    ref64 = segment_sum_ref(data.double(), seg, num_rows)
    err = (got.double() - ref64).abs()
    ok = bool((err <= SEG_ATOL + SEG_RTOL * ref64.abs()).all())
    check(ok, f"segment_sum {name}: outside rtol {SEG_RTOL} of the "
              f"float64 sum (max abs err {float(err.max()):.3e})")
    check(torch.equal(got, again), f"segment_sum {name}: repeat differs")
    order, row_ptr = sorted_layout(seg, num_rows)
    valid = (seg >= 0) & (seg < num_rows)
    idx, vals = seg[valid].long(), data[valid]
    E, F = data.shape
    n_valid = int(valid.sum())
    # the payload of in-range lanes only (the rest is dropped unread), every
    # segment id, the output once
    b_ms, b_by = bound_ms(n_valid * F * 4 + E * 4 + num_rows * F * 4,
                          n_valid * F)
    row = dict(
        name="segment_sum", shape=name, E=E, E_valid=n_valid, F=F,
        rows=num_rows, max_abs_err=float(err.max()), bit_identical_repeat=True,
        ms=timer.ms(lambda: segment_matmul(data, seg, num_rows)),
        kernel_ms=timer.ms(lambda: segment_sum_sorted(data, order, row_ptr,
                                                      num_rows)),
        plain_ms=timer.ms(lambda: segment_sum_ref(data, seg, num_rows)),
        library_ms=timer.ms(lambda: torch.zeros(
            (num_rows, F), device=data.device).index_add_(0, idx, vals)),
        bound_ms=b_ms, bound_by=b_by)
    say("kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in row.items()})
    return row


def time_gather(torch, timer, name, table, ids, rows_per_step=1):
    from repro_torch.kernels.block_gather.ops import gather_rows
    from repro_torch.kernels.block_gather.ref import block_gather_ref
    got = gather_rows(table, ids, rows_per_step=rows_per_step)
    ref = block_gather_ref(table, ids, rows_per_step)
    check(torch.equal(got, ref), f"block_gather {name}: differs from plain")
    ids64 = ids.long()
    # only the table rows the (clamped) ids name are read, each once
    rows_read = int(torch.unique(ids.clamp(0, table.shape[0] // rows_per_step
                                           - 1)).numel()) * rows_per_step
    nbytes = rows_read * table.shape[1] * 4 + ids.numel() * 4 \
        + got.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 0)
    row = dict(
        name="block_gather", shape=name, N=ids.numel(), F=table.shape[1],
        rows_read=rows_read,
        max_abs_err=float((got - ref).abs().max()),
        ms=timer.ms(lambda: gather_rows(table, ids,
                                        rows_per_step=rows_per_step)),
        plain_ms=timer.ms(lambda: block_gather_ref(table, ids,
                                                   rows_per_step)),
        library_ms=timer.ms(lambda: table.index_select(0, ids64)),
        bound_ms=b_ms, bound_by=b_by)
    say("kernel", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                     for k, v in row.items()})
    return row


def kernel_phase(torch, timer, dev, cbl, small_cbl, seed):
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    nv = cbl.capacity_vertices
    x = torch.rand(nv, generator=gen, device=dev)
    (table, owner), (msg, seg) = sweep_inputs(torch, cbl, x)
    st = cbl.store
    rows = [time_gather(torch, timer, "push x[owner]", table, owner)]
    dst_ids = st.keys.clamp(0, nv - 1).reshape(-1).contiguous()
    rows.append(time_gather(torch, timer, "pull x[dst]", table, dst_ids))
    rows.append(time_segment_sum(torch, timer, "push", msg, seg, nv))
    per_blk = msg.reshape(st.num_blocks, -1).sum(1, keepdim=True).contiguous()
    owner_seg = torch.where(st.owner == -1, nv, st.owner).contiguous()
    rows.append(time_segment_sum(torch, timer, "pull", per_blk, owner_seg, nv))
    del msg, seg, per_blk, dst_ids
    snv = small_cbl.capacity_vertices
    xf = torch.rand((snv, 16), generator=gen, device=dev)
    (ftable, fowner), (fmsg, fseg) = sweep_inputs(torch, small_cbl, xf)
    rows.append(time_gather(torch, timer, "push_feat x[owner] F=16",
                            ftable, fowner))
    rows.append(time_segment_sum(torch, timer, "push_feat F=16", fmsg, fseg,
                                 snv))
    return rows


# ---------------------------------------------------------------------------
# agreement with the host on a small input
# ---------------------------------------------------------------------------

def agreement_phase(torch, dev, seed):
    """The same service sequence on ``dev`` and on the host, compared."""
    from repro_torch import interop
    from repro_torch.data.synthetic import rmat_edges, update_stream
    from repro_torch.stream.service import GraphService
    nv, ne = 3000, 30000
    src, dst = rmat_edges(nv, ne, seed=seed, device="cpu")
    w = torch.rand(ne, generator=torch.Generator().manual_seed(seed)) + 0.1
    svcs = [GraphService.from_coo(src, dst, w, num_vertices=nv, block_width=8,
                                  log_capacity=8192, device=d)
            for d in (dev, "cpu")]
    outs = [[], []]
    for s, d, uw, op in update_stream(nv, (src, dst), 4000, 2, seed=seed,
                                      device="cpu"):
        for k, svc in enumerate(svcs):
            svc.apply(s, d, uw, op)
            rep = svc.flush()
            outs[k].append((rep, interop.cbl_to_numpy(svc.snapshot.cbl),
                            svc.analytics("pagerank"),
                            svc.analytics("bfs", source=0),
                            svc.analytics("sssp", source=0),
                            svc.analytics("cc"),
                            svc.query_edges(s, d)))
    import numpy as np
    for got, ref in zip(*outs):
        check(got[0] == ref[0], "small input: flush reports differ")
        for k in ref[1]:
            a, b = got[1][k], ref[1][k]
            same = all(np.array_equal(a[f], b[f]) for f in b) \
                if isinstance(b, dict) else np.array_equal(a, b)
            check(same, f"small input: store array {k} differs")
        pr_d, pr_h = interop.to_numpy(got[2]), interop.to_numpy(ref[2])
        check(np.allclose(pr_d, pr_h, rtol=1e-5, atol=1e-8),
              "small input: PageRank differs")
        for i, name in ((3, "bfs"), (4, "sssp"), (5, "cc")):
            check(np.array_equal(interop.to_numpy(got[i]),
                                 interop.to_numpy(ref[i])),
                  f"small input: {name} differs")
        for a, b in zip(got[6], ref[6]):
            check(np.array_equal(interop.to_numpy(a), interop.to_numpy(b)),
                  "small input: point reads differ")
    say("agreement", vertices=nv, edges=ne, rounds=len(outs[0]),
        stores="bit-exact", pagerank="rtol 1e-5", bfs_sssp_cc="exact")


# ---------------------------------------------------------------------------
# the service's main path
# ---------------------------------------------------------------------------

def service_phase(torch, timer, dev, svc, coo, seed, report, profile=False):
    from repro_torch import backend
    from repro_torch.data.synthetic import update_stream
    out = {}
    backend.reset_launch_counts()
    (ranks, pr_s) = timer.wall(lambda: svc.analytics("pagerank"))
    out["pagerank_cold"] = dict(seconds=pr_s, iterations=svc.last_iterations)
    for name, kw in (("bfs", {"source": 0}), ("sssp", {"source": 0}),
                     ("cc", {})):
        _, sec = timer.wall(lambda: svc.analytics(name, **kw))
        out[f"{name}_cold"] = dict(seconds=sec,
                                   iterations=svc.last_iterations)
    say("service.cold", **{k: f"{v['seconds']:.3f}s/{v['iterations']}it"
                           for k, v in out.items()})
    rounds = []
    stream = update_stream(svc.snapshot.cbl.capacity_vertices, coo,
                           UPDATES_PER_ROUND, ROUNDS,
                           delete_frac=DELETE_FRAC, seed=seed + 1, device=dev)
    for r, (s, d, w, op) in enumerate(stream):
        timer.sync()
        receipt, apply_s = timer.wall(lambda: svc.apply(s, d, w, op))
        check(bool(receipt.admitted), f"round {r}: batch not admitted")
        if profile and r == ROUNDS - 1:
            rep, prof = profiled(torch, svc.flush)
            flush_s = prof["wall_s"]         # the trace's processing left out
            report["profile_flush"] = prof
        else:
            rep, flush_s = timer.wall(svc.flush)
        ins = op == 1
        qs_i, qd_i, w_i = s[ins][:READ_PAIRS], d[ins][:READ_PAIRS], \
            w[ins][:READ_PAIRS]
        qs_d, qd_d = s[~ins][:READ_PAIRS], d[~ins][:READ_PAIRS]
        (found_i, got_w), read_i_s = timer.wall(
            lambda: svc.query_edges(qs_i, qd_i))
        (found_d, _), read_d_s = timer.wall(
            lambda: svc.query_edges(qs_d, qd_d))
        check(bool(found_i.all()), f"round {r}: an inserted pair is missing")
        check(torch.equal(got_w, w_i), f"round {r}: inserted weights differ")
        check(not bool(found_d.any()), f"round {r}: a deleted pair is found")
        row = dict(round=r, updates=int(s.numel()), apply_s=apply_s,
                   flush_s=flush_s,
                   updates_per_s=int(s.numel()) / (apply_s + flush_s),
                   applied_inserts=rep.applied_inserts,
                   applied_deletes=rep.applied_deletes,
                   grow_retries=rep.grow_retries,
                   maintenance=rep.maintenance.kind,
                   read_pairs=qs_i.numel() + qs_d.numel(),
                   read_pairs_per_s=(qs_i.numel() + qs_d.numel())
                   / (read_i_s + read_d_s))
        rounds.append(row)
        say("service.flush", **{k: (f"{v:.4g}" if isinstance(v, float) else v)
                                for k, v in row.items()})
    out["rounds"] = rounds
    warm = {}
    if profile:
        ranks_warm, prof = profiled(torch, lambda: svc.analytics("pagerank"))
        sec = prof["wall_s"]
        report["profile_pagerank_warm"] = prof
    else:
        (ranks_warm, sec) = timer.wall(lambda: svc.analytics("pagerank"))
    warm["pagerank_warm"] = dict(seconds=sec, iterations=svc.last_iterations)
    for name, kw in (("bfs", {"source": 0}), ("sssp", {"source": 0}),
                     ("cc", {})):
        res, sec = timer.wall(lambda: svc.analytics(name, **kw))
        warm[f"{name}_warm"] = dict(seconds=sec,
                                    iterations=svc.last_iterations)
        if name == "bfs":
            check(int(res[0]) == 0 and bool((res >= -1).all()),
                  "bfs levels malformed")
        if name == "sssp":
            check(float(res[0]) == 0.0 and not bool(torch.isnan(res).any()),
                  "sssp distances malformed")
    out.update(warm)
    say("service.warm", **{k: f"{v['seconds']:.3f}s/{v['iterations']}it"
                           for k, v in warm.items()})
    out["launches"] = dict(backend.LAUNCHES)
    report["service"] = out
    return ranks, ranks_warm


def run(scale: float = 1.0, seed: int = 0, profile: bool = False) -> dict:
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from repro_torch import backend
    from repro_torch.data.synthetic import rmat_edges
    from repro_torch.graph.algorithms import pagerank
    from repro_torch.stream.service import GraphService

    dev = torch.device("cuda")
    timer = Timer(torch)
    report = {}
    card = smi_line()
    print(card, flush=True)
    report["card"] = card
    t0 = time.perf_counter()
    backend.load_kernels()
    say("setup.build", seconds=f"{time.perf_counter() - t0:.2f}",
        nvcc_seconds=f"{backend.last_build_seconds:.2f}")
    report["build_seconds"] = backend.last_build_seconds

    nv, ne = int(LJ_VERTICES * scale), int(LJ_EDGES * scale)
    (src, dst), gen_s = timer.wall(lambda: rmat_edges(nv, ne, seed=seed,
                                                      device=dev))
    wgen = torch.Generator(device=dev).manual_seed(seed + 3)
    w = 0.1 + 0.9 * torch.rand(ne, generator=wgen, device=dev)
    svc, build_s = timer.wall(lambda: GraphService.from_coo(
        src, dst, w, num_vertices=nv, log_capacity=2 ** 21, device=dev))
    cbl0 = svc.snapshot.cbl
    report["graph"] = dict(vertices=nv, edges=ne, rmat_seconds=gen_s,
                           from_coo_seconds=build_s,
                           num_blocks=cbl0.store.num_blocks,
                           block_width=cbl0.block_width)
    say("setup.graph", **report["graph"])

    agreement_phase(torch, dev, seed)

    ssrc, sdst = rmat_edges(nv // 16, ne // 16, seed=seed + 5, device=dev)
    small = GraphService.from_coo(ssrc, sdst, None, num_vertices=nv // 16,
                                  device=dev).snapshot.cbl
    report["kernels"] = kernel_phase(torch, timer, dev, cbl0, small, seed)
    del small, ssrc, sdst

    torch.cuda.reset_peak_memory_stats()
    ranks, _ = service_phase(torch, timer, dev, svc, (src, dst), seed,
                             report, profile)
    launches = report["service"]["launches"]

    total = float(ranks.double().sum())
    check(abs(total - 1.0) <= 1e-3, f"PageRank ranks sum to {total}")
    # the same cold PageRank through each route, back to back
    per_it = {}
    for impl in ("cuda", "torch"):
        (ref, iters), sec = timer.wall(
            lambda: pagerank(cbl0, impl=impl, return_stats=True))
        per_it[impl] = dict(seconds=sec, iterations=iters,
                            ms_per_iteration=sec * 1e3 / max(iters, 1))
    rel = float(((ranks - ref).abs() / ref.abs().clamp(min=1e-30)).max())
    check(torch.allclose(ranks, ref, rtol=1e-4, atol=0.0),
          f"PageRank impl=torch vs cuda: max rel diff {rel:.3e}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    report["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    say("checks", ranks_sum=f"{total:.6f}", torch_vs_cuda_max_rel=f"{rel:.3e}",
        launches=launches)
    say("pagerank.routes", **{f"{k}_ms_per_it": f"{v['ms_per_iteration']:.4g}"
                              for k, v in per_it.items()})
    report["checks"] = dict(ranks_sum=total, torch_vs_cuda_max_rel=rel)
    report["pagerank_routes"] = per_it
    return report


def kernels_line(report: dict) -> dict:
    """The ``kernels`` JSON object: each kernel at the main path's dominant
    shape (the push sweep), errors over every shape checked."""
    launches = report["service"]["launches"]
    meta = {
        "segment_sum": ("src/repro_torch/csrc/segment_sum.cu",
                        "src/repro/kernels/segment_matmul/kernel.py:57"),
        "block_gather": ("src/repro_torch/csrc/block_gather.cu",
                         "src/repro/kernels/block_gather/kernel.py:29"),
    }
    out = []
    for name, (source, replaces) in meta.items():
        rows = [r for r in report["kernels"] if r["name"] == name]
        main = next(r for r in rows if r["shape"].startswith("push"))
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, launches=launches[name],
                        max_abs_err=max(r["max_abs_err"] for r in rows),
                        ms=main["ms"], plain_ms=main["plain_ms"],
                        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                        library_ms=main["library_ms"], shape=main["shape"]))
    return {"kernels": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of the LiveJournal-size graph")
    ap.add_argument("--profile", action="store_true",
                    help="profile the last flush and the warm PageRank "
                         "(their times then include the profiler's cost)")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    try:
        report = run(args.scale, args.seed, args.profile)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = "chip_smoke_profile.json" if args.profile else "chip_smoke.json"
    (out_dir / name).write_text(json.dumps(report, indent=1))
    say("report", max_memory_allocated=report["max_memory_allocated"],
        file=f"chiprun_out/{name}")
    print(json.dumps(kernels_line(report)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
