"""Run one cell of the benchmark once and print its result line.

    python3 gpubench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a host with the cards the cell asks
for.  Set-up (imports, the rows made on the card from the seed, the
kernels built or loaded, the program's first steps) is timed from the
start of this process; then the window runs for about `--seconds` (with
``--trace 1`` its last seconds under one torch.profiler session, the
host's per-layer metrics read from the rest); then the plain reference
follows the program's first steps and decides `correct`.  The last line
of standard output is the result's JSON object; the last lines of
standard error give each number compared beside its limit.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
# the kernels are built into the checkout's own directory, not a shared one
os.environ.pop("DSGD_COMPILE_CACHE", None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from gpubench import harness, isolation, trace

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    try:
        result = harness.run_cell(harness.Registry(), args.workload, args.seed, args.seconds,
                                  bool(args.trace), T_PROCESS, log=log)
    except (isolation.Forbidden, trace.NoDeviceEvents, harness.MissingMetric) as e:
        log(f"no result: {e}")
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
