"""Time the RPC sync fit of one checkout of the port on the card.

    python distributed_sgd_tpu_torch/tools/rpc_sync_routes.py [--root DIR] [--label L]
        [--rows 100000] [--fits 2] [--local-steps K] [--levers] [--straggler]

Imports ``distributed_sgd_tpu_torch`` from ``--root`` (default: the
checkout this file is in), builds its kernels, and runs `--fits` sync fits
of one epoch of a DevCluster (a master and 3 workers in one process on
loopback gRPC, the nodes on the card; `--rows` synthetic RCV1-shaped rows,
80% of them trained on; B=100, lr 0.5), every lever off unless
`--local-steps` or `--levers` (delta broadcasts, streams, 2 fan-in lanes,
a stage pool of 2) says otherwise; a checkout without the levers runs
only without them.  `--straggler` runs chip_smoke's phase 10 straggler
fit instead: 2 epochs under a quorum of 2 with a 0.1 s soft deadline,
worker 0's first 20 Gradient bodies each sleeping 1.0 s first (any
checkout since the quorum barrier).  Prints one JSON line a fit: windows, windows/s over
the epoch, the mean milliseconds of each part of a window
(``master.sync.{fanout,barrier,decode,apply}.seconds``, the workers'
``slave.grad.compute`` span and the whole window), the broadcast bytes,
the test loss and a digest of the weights.  Run it on two checkouts in one
process each, in turns (a, b, b, a), to compare them on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import threading
import time

PARTS = ("master.sync.fanout.seconds", "span.slave.grad.compute",
         "master.sync.barrier.seconds", "master.sync.decode.seconds",
         "master.sync.apply.seconds", "master.sync.batch.duration")


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--rows", type=int, default=100000)
    ap.add_argument("--fits", type=int, default=2)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--levers", action="store_true")
    ap.add_argument("--straggler", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from distributed_sgd_tpu_torch.core.cluster import DevCluster
    from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity, train_test_split
    from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
    from distributed_sgd_tpu_torch.models.linear import make_model
    from distributed_sgd_tpu_torch.ops import _build
    from distributed_sgd_tpu_torch.utils.metrics import Metrics

    if not torch.cuda.is_available():
        print("rpc_sync_routes: no CUDA device", file=sys.stderr)
        return 1
    _build.build()
    train, test = train_test_split(rcv1_like(args.rows, seed=0, idf_values=True))
    model = make_model("hinge", 1e-5, train.n_features, dim_sparsity=dim_sparsity(train),
                       device="cuda")
    kw = {}
    if args.local_steps > 1:
        kw["local_steps"] = args.local_steps
    if args.levers:
        kw.update(delta_broadcast=True, stream=True, fanin_lanes=2, stage_pool=2)
    epochs = 1
    if args.straggler:
        kw.update(quorum=2, straggler_soft_s=0.1, grad_timeout_s=60.0)
        epochs = 2
    for run in range(args.fits):
        m = Metrics()
        with DevCluster(model, train, test, n_workers=3, seed=0, metrics=m) as c:
            slow = slow_first_calls(c.workers[0], 1.0, 20) if args.straggler else None
            fit = c.master.fit_sync(epochs, 100, 0.5, **kw)
            while slow is not None and slow["sleeping"]:
                time.sleep(0.05)  # the late bodies return inside the cluster
        windows = m.counter("master.sync.rounds").value
        w = np.asarray(fit.weights)
        print(json.dumps({
            "label": args.label, "root": os.path.abspath(args.root), "run": run,
            "straggler": args.straggler, "windows": windows,
            "windows_per_s": windows / sum(fit.epoch_seconds),
            "ms": {p: m.histogram(p).mean * 1e3 for p in PARTS},
            "bcast_bytes": m.counter("master.sync.bcast.bytes").value,
            "hedges": m.counter("master.sync.quorum.hedges").value,
            "degraded": m.counter("master.sync.quorum.degraded").value,
            "test_loss": fit.test_losses[-1],
            "weights_sha256": hashlib.sha256(w.tobytes()).hexdigest()[:16],
        }), flush=True)
    return 0


def slow_first_calls(worker, seconds: float, calls: int) -> dict:
    """`worker`'s first `calls` compute_gradient bodies sleep `seconds`
    first; the returned dict's "sleeping" counts those that have started
    and not yet returned."""
    real = worker.compute_gradient
    lock = threading.Lock()
    state = {"calls": 0, "sleeping": 0}

    def slow(w, ids):
        with lock:
            state["calls"] += 1
            is_slow = state["calls"] <= calls
            state["sleeping"] += is_slow
        if not is_slow:
            return real(w, ids)
        time.sleep(seconds)
        try:
            return real(w, ids)
        finally:
            with lock:
                state["sleeping"] -= 1

    worker.compute_gradient = slow
    return state


if __name__ == "__main__":
    sys.exit(main())
