"""One run of one cell: set up, warm up, measure, check, report.

Everything a cell is made of is found by name: the cell's entry in
``BENCHMARK.json`` names its configuration file and its traffic mix
(``mixes/<traffic>.json``); the mix names its loop (``loops/<loop>.py``)
and its analytics jobs, each with its reference (``reference/<job>.py``);
and each metric the cell reports has a reader ``metrics/<metric>.py`` with
``read(rec) -> float | None``.  A later cell, mix, loop, job or metric is
therefore new files, not an edit.

The run (:func:`run_cell`):

1. set-up: the initial graph of :mod:`graphbench.gen` made on the device,
   the ``GraphService`` built over it, and ``warmup_rounds`` rounds of the
   mix's own loop, so every shape the window uses has run;
2. the window: rounds of the loop until ``--seconds`` of it have passed.
   Each of the program's calls is a span that ends in a
   ``torch.cuda.synchronize``.  Between rounds, outside every span, the
   feed makes the next batch (and, as the stream needs, its next block)
   and copies it to the card; the feed's seconds are taken out of the
   window's, so the window's seconds are the program's;
3. the check: the program's answers at the last epoch read back, the
   service freed, and :mod:`graphbench.judge` against the reference.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from graphbench import devtrace, gen, judge, peaks
from repro_torch import backend
from repro_torch.stream.service import GraphService

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_PATH = ROOT / "build" / "graphbench" / "trace.json"
# top-level modules the process may not hold when it reports
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
CHECK_READS = 1 << 20         # read-back pairs of each kind (see gen)


# ---- finding a cell's parts by name --------------------------------------

def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_parts(bench: dict, name: str):
    """``(cell, configuration, mix)`` of the cell called ``name``."""
    cells = {c["name"]: c for c in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    cell = cells[name]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, config, mix


def metric_specs(bench: dict, cell: str, trace: bool) -> List[dict]:
    """The metrics the cell reports: its end-to-end metrics untraced, its
    per-layer metrics traced."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def _load(folder: str, name: str):
    """The module ``<folder>/<name>.py``, loaded from its file (a name may
    hold dots)."""
    path = HERE / folder / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"graphbench_{folder}_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    return _load("metrics", name).read


def loop(mix: dict):
    """The ``round`` function of the mix's ``loops/<loop>.py``."""
    return _load("loops", mix["loop"]).round


# ---- the closed loop ------------------------------------------------------

def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Spans:
    """Host-clock spans of the benchmark's calls, each ended by a device
    synchronise; with ``annotate`` each is also a ``record_function``
    range the device trace can place."""

    def __init__(self, device, annotate: bool = False):
        self.device = device
        self.annotate = annotate
        self.seconds: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        rng = (torch.profiler.record_function(f"graphbench.{name}")
               if self.annotate else contextlib.nullcontext())
        with rng:
            t0 = time.perf_counter()
            yield
            _sync(self.device)
            self.seconds[name].append(time.perf_counter() - t0)


class Feed:
    """Round ``j``'s batch when round ``j`` starts: taken from the stream
    (which makes its next block when it needs one) between rounds, outside
    every span, into one of two buffers on the card; ``seconds`` sums the
    time it took (on the CPU the stream's own rows)."""

    def __init__(self, stream: gen.Stream, annotate: bool):
        self.stream, self.annotate = stream, annotate
        self.cuda = torch.device(stream.device).type == "cuda"
        self.seconds = 0.0
        n = 2 * stream.d
        self.bufs = [tuple(torch.empty(n, dtype=t, device=stream.device)
                           for t in (torch.int32, torch.int32,
                                     torch.float32)) for _ in (0, 1)]

    def load(self, j: int):
        t0 = time.perf_counter()
        rng = (torch.profiler.record_function(devtrace.FEED)
               if self.annotate else contextlib.nullcontext())
        with rng:
            rows = self.stream.batch(j, out=self.bufs[j % 2])
            if self.cuda:
                torch.cuda.synchronize()
        self.seconds += time.perf_counter() - t0
        return (*rows, self.stream.op)


@dataclasses.dataclass
class Driver:
    """The mix's loop over one service: round ``j`` is the loop's
    ``round(driver, j, batch)`` on batch ``j``, which records its times,
    failures and job results here."""
    svc: GraphService
    stream: gen.Stream
    jobs: List[tuple]                 # (name, analytics keyword arguments)
    spans: Spans
    feed: Feed
    loop: Callable
    next: int = 0
    failed: int = 0
    update_s: List[float] = dataclasses.field(default_factory=list)
    refresh_s: List[float] = dataclasses.field(default_factory=list)
    job_names: List[str] = dataclasses.field(default_factory=list)
    iterations: List[int] = dataclasses.field(default_factory=list)
    last: Dict[str, tuple] = dataclasses.field(default_factory=dict)

    def round(self) -> None:
        batch = self.feed.load(self.next)
        self.loop(self, self.next, batch)
        self.next += 1

    def restart_counts(self) -> None:
        """Forget the warm-up's times and counts (not its state)."""
        self.failed = 0
        self.feed.seconds = 0.0
        for xs in (self.update_s, self.refresh_s, self.job_names,
                   self.iterations):
            xs.clear()
        self.spans.seconds.clear()


def resolve_jobs(mix: dict, init_src, nv: int, seed: int) -> List[tuple]:
    """The mix's rotation as ``(name, kwargs)``; a ``"source": "seeded"``
    becomes the run's seeded source vertex (by the initial out-degrees)."""
    jobs = []
    for job in mix.get("jobs", []):
        kw = {k: v for k, v in job.items() if k != "name"}
        if kw.get("source") == "seeded":
            kw["source"] = gen.pick_source(
                init_src, nv, int(mix["source_min_degree"]), seed)
        jobs.append((job["name"], kw))
    return jobs


def setup(config: dict, mix: dict, seed: int, device,
          spans: Spans) -> Driver:
    """The stream, the service over its initial edges (built with the
    configuration's ``service`` options) and the warm-up; the seconds of
    each part go to standard error."""
    t0 = time.perf_counter()
    d = int(mix["batch_updates"]) // 2
    stream, init = gen.make_stream(config, d, seed, device)
    _sync(device)
    t1 = time.perf_counter()
    svc = GraphService.from_coo(*init, num_vertices=stream.nv, device=device,
                                **config["service"])
    jobs = resolve_jobs(mix, init[0], stream.nv, seed)
    del init
    _sync(device)
    t2 = time.perf_counter()
    driver = Driver(svc, stream, jobs, spans,
                    Feed(stream, spans.annotate), loop(mix))
    for _ in range(int(mix["warmup_rounds"])):
        driver.round()
    _sync(device)
    print(f"setup graph_s {t1 - t0!r} store_s {t2 - t1!r} warmup_s "
          f"{time.perf_counter() - t2!r} feed_s {driver.feed.seconds!r}",
          file=sys.stderr)
    return driver


def window(driver: Driver, seconds: float, trace: bool,
           rounds: Optional[int] = None) -> dict:
    """Rounds until ``seconds`` of the program's time have passed (the
    window's less the feed's), or, with ``rounds``, that many rounds; the
    record the metric readers read."""
    driver.restart_counts()
    locate0, plans0 = (backend.LAUNCHES["chain_walk_locate"],
                       backend.PLAN_BUILDS)
    prof = devtrace.profile() if trace else contextlib.nullcontext()
    with prof:
        rng = (torch.profiler.record_function(devtrace.WINDOW) if trace
               else contextlib.nullcontext())
        with rng:
            t0 = time.perf_counter()
            while (len(driver.update_s) < rounds if rounds is not None else
                   time.perf_counter() - t0 - driver.feed.seconds < seconds):
                driver.round()
            window_s = time.perf_counter() - t0 - driver.feed.seconds
    rec = dict(
        window_s=window_s, rounds=len(driver.update_s),
        updates=len(driver.update_s) * 2 * driver.stream.d,
        update_s=list(driver.update_s), refresh_s=list(driver.refresh_s),
        jobs=len(driver.refresh_s), job_names=list(driver.job_names),
        iterations=list(driver.iterations),
        spans={k: list(v) for k, v in driver.spans.seconds.items()},
        counters={"chain_walk_locate":
                  backend.LAUNCHES["chain_walk_locate"] - locate0,
                  "plan_builds": backend.PLAN_BUILDS - plans0},
        feed_s=driver.feed.seconds, vertices=driver.stream.nv, trace=None)
    if trace:
        TRACE_PATH.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(TRACE_PATH))
    return rec


@dataclasses.dataclass
class Outputs:
    """What the program answered at the end of the window."""
    rounds: int
    qsrc: torch.Tensor
    qdst: torch.Tensor
    found: torch.Tensor
    w: torch.Tensor
    live_count: int
    results: Dict[str, torch.Tensor]
    jobs: Dict[str, tuple]            # name -> (round, kwargs)


def collect(driver: Driver, seed: int) -> Outputs:
    """Read back the final snapshot and keep each job's last result."""
    st = driver.stream
    pos = gen.sample_positions(st, driver.next, min(CHECK_READS, st.edges),
                               seed, st.op.device)
    qsrc, qdst, _ = st.gather(pos)
    found, w = driver.svc.query_edges(qsrc, qdst)
    return Outputs(rounds=driver.next, qsrc=qsrc, qdst=qdst, found=found,
                   w=w, live_count=int(driver.svc.snapshot.num_edges),
                   results={n: v[2] for n, v in driver.last.items()},
                   jobs={n: (v[0], v[1]) for n, v in driver.last.items()})


# ---- one run --------------------------------------------------------------

def run_cell(config: dict, mix: dict, specs: List[dict], *, seed: int,
             seconds: float, trace: bool, device, t0: float,
             chips: int = 1, controls: bool = False,
             rounds: Optional[int] = None) -> dict:
    """One run; the result line as a dict (``checks`` last).  With
    ``controls`` the line also carries the control's numbers; with
    ``rounds`` the window is that many rounds instead of ``seconds``."""
    spans = Spans(device, annotate=trace)
    print(f"setup begin_s {time.perf_counter() - t0!r}", file=sys.stderr)
    driver = setup(config, mix, seed, device, spans)
    setup_s = time.perf_counter() - t0
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec = window(driver, seconds, trace, rounds)
    rec["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    describe(driver, rec, cuda)
    out = collect(driver, seed)
    rec["live_edges"] = out.live_count
    stream, failed = driver.stream, driver.failed
    driver.svc = None
    del driver
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if trace:
        rec["trace"] = devtrace.read(TRACE_PATH)
        print(f"trace device_s_in {rec['trace']['device_s_in']}",
              file=sys.stderr)

    t_check = time.perf_counter()
    checks = judge.verdict(judge.numbers(stream, out))
    print(f"check_s {time.perf_counter() - t_check!r}", file=sys.stderr)
    metrics = {}
    for spec in specs:
        value = reader(spec["name"])(rec)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips, "memory_peak_bytes": peak}
    if cuda:
        dev["power_limit_w"] = peaks.power_limit_w()
    line = {"correct": judge.passed(checks), "attempted": rec["rounds"],
            "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        t = rec["trace"]
        dev["busy_s"], dev["window_s"] = t["busy_s"], t["window_s"]
        line["breakdown"] = {"device_ops": t["device_ops"],
                             "idle_gaps": t["idle_gaps"]}
    if controls:
        line["control"] = judge.control(stream, out)
    line["checks"] = checks
    return line


def describe(driver: Driver, rec: dict, cuda: bool) -> None:
    """One line on standard error about the window: batch-time quantiles
    (ms), the service's maintenance counts and the allocator's retries."""
    xs = sorted(rec["update_s"])
    q = ({f"p{p}": 1e3 * xs[min(len(xs) - 1, int(p / 100 * len(xs)))]
          for p in (10, 50, 90, 99)} if xs else {})
    q["max"] = 1e3 * xs[-1] if xs else None
    st = driver.svc.stats
    alloc = torch.cuda.memory_stats() if cuda else {}
    span_ms = {k: 1e3 * sum(v) / len(v) for k, v in rec["spans"].items()}
    print(f"window batch_ms {q} span_mean_ms {span_ms} feed_s "
          f"{rec['feed_s']!r} blocks {len(driver.stream.segments) - 1} "
          f"flushes "
          f"{st.flushes} grows {st.grows} compacts {st.compacts} rebuilds "
          f"{st.rebuilds} alloc_retries {alloc.get('num_alloc_retries')} "
          f"device_allocs {alloc.get('num_device_alloc')}", file=sys.stderr)


def forbidden_modules(names=None) -> List[str]:
    """The ``FORBIDDEN`` top-level names among ``names`` (the modules the
    process holds by default), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(args, t0: float) -> int:
    """The command line's run (see ``run.py``); the exit code."""
    if not torch.cuda.is_available():
        print("graphbench: no CUDA device", file=sys.stderr)
        return 2
    bench = load_benchmark()
    cell, config, mix = cell_parts(bench, args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"graphbench: {args.workload} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    line = run_cell(config, mix,
                    metric_specs(bench, args.workload, bool(args.trace)),
                    seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device="cuda", t0=t0,
                    chips=int(cell["chips"]))
    bad = forbidden_modules()
    if bad:
        print(f"graphbench: the process holds {bad}", file=sys.stderr)
        return 3
    report(line)
    return 0


def report(line: dict) -> None:
    """Each compared number beside its limit as the last lines of standard
    error, then the result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
