"""Tensor-parallel (dp x tp) training on a workers x shards grid of ranks:
weights feature-sharded over each rank's slice, data row-sharded over the
data ranks.

`main` starts the workers x shards ranks itself, each a process of this
file joined by a gloo process group over localhost, every one on the card
(or on the CPU with --device cpu), and returns rank 0's final test loss:

    python examples_torch/train_feature_sharded.py [n_samples] [--device cpu]

One rank alone is ``--rank R --world N --port P`` (what `main` runs).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributed_sgd_tpu_torch.core.early_stopping import no_improvement  # noqa: E402
from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity, train_test_split  # noqa: E402
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like  # noqa: E402
from distributed_sgd_tpu_torch.models.linear import make_model  # noqa: E402
from distributed_sgd_tpu_torch.parallel import multihost  # noqa: E402
from distributed_sgd_tpu_torch.parallel.feature_sharded import (  # noqa: E402
    FeatureShardedEngine,
    make_mesh_2d,
)

RANKS_TIMEOUT_S = 110.0  # every rank must have exited within this


def run_rank(rank: int, world: int, port: int, n: int, max_epochs: int, workers: int,
             shards: int, device=None) -> None:
    """One rank of the grid: rank 0 prints its result as a JSON line."""
    device = multihost.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                  device=device)
    try:
        data = rcv1_like(n, n_features=2048, nnz=12, seed=0, idf_values=True)
        train, test = train_test_split(data)
        model = make_model("hinge", 1e-5, data.n_features, dim_sparsity=dim_sparsity(train),
                           device=device)
        # each rank holds 1/shards of the weights; margins are partial sums
        # over the feature group, gradients the mean over the data group --
        # the same fit/evaluate contract as the 1-D SyncTrainer
        engine = FeatureShardedEngine(
            model, make_mesh_2d(workers, shards, device), batch_size=32, learning_rate=0.5
        )
        res = engine.fit(
            train, test, max_epochs,
            criterion=no_improvement(patience=3, min_delta=0.01),
        )
        if rank == 0:
            print(json.dumps({"epochs": res.epochs_run, "test_loss": res.test_losses[-1],
                              "test_acc": res.test_accuracies[-1]}), flush=True)
    finally:
        dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(n: int = 4_000, max_epochs: int = 4, workers: int = 2, shards: int = 4,
         device=None) -> float:
    world = workers * shards
    port = _free_port()
    cmd = [sys.executable, os.path.abspath(__file__), str(n), "--max-epochs", str(max_epochs),
           "--workers", str(workers), "--shards", str(shards), "--world", str(world),
           "--port", str(port)] + (["--device", str(device)] if device is not None else [])
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world} exited {p.returncode}:\n{out[-4000:]}")
    res = json.loads(outs[0].strip().splitlines()[-1])
    print(f"dp={workers} tp={shards}: epochs={res['epochs']} "
          f"test_loss={res['test_loss']:.4f} test_acc={res['test_acc']:.4f}")
    return res["test_loss"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=4_000)
    ap.add_argument("--max-epochs", type=int, default=4)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.rank is None:
        main(args.n, args.max_epochs, args.workers, args.shards, device=args.device)
    else:
        run_rank(args.rank, args.world, args.port, args.n, args.max_epochs, args.workers,
                 args.shards, device=args.device)
