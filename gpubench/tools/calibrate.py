"""The readings that the limits of `correct` are set from, on the card.

    python3 gpubench/tools/calibrate.py --workload <name> --seeds 1,2,3 [--controls 3] [--out f.json]

For each seed, in one process: the cell's rows, the program's set-up
(its first three steps through the window's own call, as a run makes
them) and the reference's, and the numbers of the program against
the reference: the lower readings.  On the first `--controls` seeds also
the control (the reference in bfloat16 put in the program's place) and
the planted half-batch fault (the reference reading the first half of
each batch, its mean over that half): the upper readings.  A state left
unchanged reads 1 in `grad1_gap`, `change3_gap` and the two direction
numbers by their definition and needs no run.  With ``--witness 1``, on every seed also the witness
(reference/linear.py), a second sound reference against the first.  No window runs.  Prints one JSON line a seed and
writes them all to `--out`.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--witness", type=int, default=0,
                    help="1: also the witness, a second sound reference with float32 sums")
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from gpubench import harness, judge
    from gpubench.data import make_rows
    from gpubench.reference.linear import CONTROL, REFERENCE, WITNESS, fold_in

    reg = harness.Registry()
    cell = reg.cell(args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        harness.require_cards(int(cell.entry["chips"]))
        print(f"card: {harness.card_line()}", file=sys.stderr, flush=True)
    rows = []
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        train, test = make_rows(cell.config["data"], fold_in(seed, 1), dev)
        drv = reg.driver(cell.config["engine"])(cell, train, test, fold_in(seed, 2), dev)
        prog = drv.run(harness.Window(0.0, False))  # the first steps, then one unit of window
        drv.release()
        ref = drv.follow(REFERENCE)
        row = {"workload": cell.name, "seed": seed,
               "program": judge.numbers(prog, ref, drv.evaluate)}
        if args.witness:
            row["witness"] = judge.numbers(drv.follow(WITNESS), ref, drv.evaluate)
        if i < args.controls:
            row["control"] = judge.numbers(drv.follow(CONTROL), ref, drv.evaluate)
            row["half_batch"] = judge.numbers(drv.follow(REFERENCE, half_batch=True), ref,
                                              drv.evaluate)
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del drv, train, test
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
