"""The readings the check's limits are set from, on the card.

    python3 graphbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds 5 [--out <file.jsonl>]

For each seed, one run of the cell as ``run.py`` makes it (a short window
at the cell's own sizes and load) with the control beside it: prints one
JSON line with the program's compared numbers (the lower readings) and the
control's (:func:`graphbench.judge.control`: the reference held in
bfloat16, and the edge set one round behind).  The benchmark's own runs do
not run it.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    from graphbench import harness
    if not torch.cuda.is_available():
        print("graphbench: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell, config, mix = harness.cell_parts(bench, args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            line = harness.run_cell(
                config, mix, harness.metric_specs(bench, args.workload,
                                                  False),
                seed=seed, seconds=args.seconds, trace=False, device="cuda",
                t0=t0, controls=True)
            row = {"workload": args.workload, "seed": seed,
                   "correct": line["correct"],
                   "program": {k: c["value"]
                               for k, c in line["checks"].items()},
                   "control": line["control"], "metrics": line["metrics"],
                   "seconds": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            if sink:
                sink.write(json.dumps(row) + "\n")
                sink.flush()
            del line
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
