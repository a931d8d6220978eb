"""How far two runs of the same sync fit land apart on the card.

    python -m distributed_sgd_tpu_torch.tools.sync_repeatability [--runs 8] [--launches 40]

The reference's hinge subgradient is discontinuous at a zero margin
(coefficient 0 where y * margin < 0, else y), so a sample whose margin
lies within rounding of 0 takes either side when the last bits of w
change; Adam, which scales each entry's step by that entry's own
gradient history, spreads such a flip over many weights.  A kernel that
sums in a different order on every launch (f32 atomics) therefore lands
an adam fit at more than one place; the fixed-order ``sync_epoch`` (64-bit
integer sums) must land every run at one.  At the main path's shape (the
CLI's 804,414 synthetic rows, its 80/20 split, K=3, B=100, hinge,
dim_sparsity), with sgd (lr 0.5) and adam (lr 0.001), the tool runs:

- `--runs` fits of 3 epochs from zero: the test loss after each epoch,
  the largest weight difference from the first run, how many runs end at
  each final test loss (to 7 significant digits) and how many distinct
  final weights (bit for bit) they give;
- `--launches` launches of the third epoch from one state: how many land
  at each largest weight difference from the first launch (to 1e-6), and
  how many distinct weights (bit for bit) they give.

Prints the card's name and power limit, then one JSON line per optimizer;
``landing_places`` is the larger of the two distinct counts.
Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import collections
import hashlib
import json
import subprocess
import sys

import torch

from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops import sync_epoch as se
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, fold_in

ROWS, K, B, EPOCHS, LAM = 804414, 3, 100, 3, 1e-5
LR = {"sgd": 0.5, "adam": 0.001}


def measure(kind: str, model, train, test_bound, runs: int, launches: int) -> dict:
    bound = SyncEngine(model, B, LR[kind], virtual_workers=K, optimizer=kind).bind(train)
    fits, first = [], None
    for _ in range(runs):
        bound.reset_optimizer()
        w = torch.zeros(model.n_features, device="cuda")
        losses = []
        for e in range(EPOCHS):
            w = bound.epoch(w, fold_in(0, e))
            losses.append(test_bound.evaluate(w)[0])
        first = w if first is None else first
        fits.append({"test_losses": losses, "max_w_diff": float((w - first).abs().max()),
                     "digest": hashlib.sha256(w.cpu().numpy().tobytes()).hexdigest()})
        print(f"{kind} fit: test losses {losses}; weights max |w - first run| "
              f"{fits[-1]['max_w_diff']:.3e}", flush=True)
    # the third epoch's launch, repeated from the state the second left
    bound.reset_optimizer()
    w = torch.zeros(model.n_features, device="cuda")
    for e in range(EPOCHS - 1):
        w = bound.epoch(w, fold_in(0, e))
    ids = bound._sample_ids(fold_in(fold_in(0, EPOCHS - 1), 0)).contiguous()
    d = bound.data
    kw = dict(coeff=model.coeff, reg_kind=model.reg_kind, lam=model.lam,
              dim_sparsity=model.dim_sparsity, lr=LR[kind], n_total_workers=K,
              optimizer=bound.optimizer, opt_state=bound._opt_state)
    outs = [se.sync_epoch(w, ids, d.indices, d.values, bound._labels_f32, **kw)[0]
            for _ in range(launches)]
    diffs = [round(float((o - outs[0]).abs().max()), 6) for o in outs]
    fit_places = len({f.pop("digest") for f in fits})
    launch_places = len({hashlib.sha256(o.cpu().numpy().tobytes()).hexdigest() for o in outs})
    return {
        "optimizer": kind, "lr": LR[kind], "fits": fits,
        "final_test_loss_counts": dict(collections.Counter(
            f"{f['test_losses'][-1]:.7g}" for f in fits)),
        "launch_diff_counts": dict(collections.Counter(diffs)),
        "distinct_fit_weights": fit_places, "distinct_launch_weights": launch_places,
        "landing_places": max(fit_places, launch_places),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--launches", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("sync_repeatability: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    train, test = train_test_split(rcv1_like(ROWS, seed=0, idf_values=True))
    model = make_model("hinge", LAM, train.n_features, dim_sparsity=dim_sparsity(train),
                       device="cuda")
    test_bound = SyncEngine(model, B, 0.0).bind(test)
    for kind in ("sgd", "adam"):
        print(json.dumps(measure(kind, model, train, test_bound, args.runs, args.launches)),
              flush=True)


if __name__ == "__main__":
    main()
