"""Time and check ``worker_grads`` of one checkout of the port on the card.

    python distributed_sgd_tpu_torch/tools/worker_grads_routes.py [--root DIR] [--label L]

Imports ``distributed_sgd_tpu_torch`` from ``--root`` (default: the
checkout this file is in), builds its ``worker_grads`` kernel and prints
one JSON line: the kernel's largest difference from its plain version,
whether 40 launches on one input gave bitwise identical outputs, and its
microseconds a call (CUDA events, 200 calls after 20 warm-up calls, in
turns with the plain version) at the RPC reply's shape (K=1, B=100) and
at the per-step path's (K=8, B=100), both at P=76, D=47,236 with
RCV1-like rows.  Run it on two checkouts in one process each, in turns
(a, b, b, a), to compare two routes of the kernel on one card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

SHAPES = ((1, 100), (8, 100))
P, D = 76, 47236
REPEATS = 40


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
    from distributed_sgd_tpu_torch.ops import worker_grads as wg

    if not torch.cuda.is_available():
        print("worker_grads_routes: no CUDA device", file=sys.stderr)
        return 1

    def time_us(fn, iters=200, warmup=20):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters * 1e3

    out = {"label": args.label or args.root, "source": wg.__file__, "shapes": []}
    rng = np.random.default_rng(0)
    for k, b in SHAPES:
        ds = rcv1_like(k * b, n_features=D, nnz=P, seed=k, idf_values=True)
        w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
        a = [torch.from_numpy(x).cuda() for x in (
            ds.indices.reshape(k, b, P), ds.values.reshape(k, b, P),
            ds.labels.reshape(k, b).astype(np.float32))]
        kernel = lambda: wg.worker_grads(w, *a, wg.HINGE)  # noqa: E731
        plain = lambda: wg.worker_grads_plain(w, *a, wg.HINGE)  # noqa: E731
        first = kernel()
        identical = all(torch.equal(first, kernel()) for _ in range(REPEATS - 1))
        err = float((first - plain()).abs().max())
        p_us = [time_us(plain)]
        k_us = [time_us(kernel), time_us(kernel)]
        p_us.append(time_us(plain))
        out["shapes"].append({"K": k, "B": b, "max_abs_err": err,
                              f"bitwise_identical_over_{REPEATS}": identical,
                              "kernel_us": min(k_us), "plain_us": min(p_us),
                              "kernel_us_runs": k_us, "plain_us_runs": p_us})
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
