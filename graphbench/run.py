"""Run one benchmark cell once and print its result line.

    python3 graphbench/run.py --workload <cell> --seed <n> \
        --seconds <window> --trace <0|1>

From the root of a checkout of this repository, on a machine with a CUDA
card: builds the cell's graph and stream from the seed, warms up, measures
for ``--seconds``, checks the outputs against the plain reference and
prints one JSON line (see ``graphbench/harness.py``).  Exits with a code
other than 0, and prints no result, without a card or the program.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the harness is the package ``graphbench``, the program ``src/repro_torch``
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# every kernel cache at a fixed path inside the checkout
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = str(ROOT / "build" / "graphbench" / sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        from graphbench import harness
    except ImportError as exc:
        print(f"graphbench: cannot load the harness or the program: {exc}",
              file=sys.stderr)
        return 2
    return harness.main(args, T0)


if __name__ == "__main__":
    sys.exit(main())
