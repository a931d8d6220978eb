"""Time and check ``sync_epoch`` of one checkout of the port on the card.

    python distributed_sgd_tpu_torch/tools/sync_epoch_routes.py [--root DIR] [--label L]
        [--launches 40]

Imports ``distributed_sgd_tpu_torch`` from ``--root`` (default: the
checkout this file is in), builds its ``sync_epoch`` kernel and prints one
JSON line.  At the main path's shape (643,531 RCV1-shaped rows, the CLI's
train split; K=3 workers each drawing from its own third, B=100, P=76,
D=47,236, hinge, dim_sparsity) it runs each mode from the state one
kernel epoch leaves: sgd (lr 0.5), momentum (lr 0.05) and adam
(lr 0.001) over one 2,146-step epoch, and the mean mode (K=1,
``grad_divisor`` = B, one worker's third) over one 64-step dispatch in
each optimizer's mode.  For each: the milliseconds of a launch (CUDA
events, the least of 3 after a warm-up), how many distinct outputs
(w and every state vector, bit for bit) `--launches` launches from one
input gave, and the largest difference from the plain version over the
first 20 steps.  Run it on two checkouts in one process each, in turns
(a, b, b, a), to compare two routes of the kernel on one card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

N, K, B, P, D, STEPS, DISPATCH = 643531, 3, 100, 76, 47236, 2146, 64
LAM = 1e-5
LR = {"sgd": 0.5, "momentum": 0.05, "adam": 0.001}


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--launches", type=int, default=40)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity
    from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
    from distributed_sgd_tpu_torch.ops import sync_epoch as se

    if not torch.cuda.is_available():
        print("sync_epoch_routes: no CUDA device", file=sys.stderr)
        return 1

    def time_ms(fn, iters):
        fn()
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / iters)
        return min(runs), runs

    def digest(out):
        w, state = out
        h = hashlib.sha256(w.cpu().numpy().tobytes())
        for v in state.vectors:
            h.update(v.cpu().numpy().tobytes())
        return h.hexdigest()

    train = rcv1_like(N, n_features=D, nnz=P, seed=0, idf_values=True)
    data = (torch.from_numpy(train.indices).cuda(), torch.from_numpy(train.values).cuda(),
            torch.from_numpy(train.labels.astype(np.float32)).cuda())
    ds = torch.from_numpy(dim_sparsity(train)).cuda()
    rng = np.random.default_rng(3)
    sub = -(-N // K)
    thirds = np.minimum(sub, N - np.arange(K) * sub)

    def epoch_ids():
        return torch.from_numpy(rng.integers(0, sub, (STEPS, K, B)) % thirds[:, None]
                                + (np.arange(K) * sub)[:, None]).cuda()

    out = {"label": args.label or args.root, "source": se.__file__,
           "card": torch.cuda.get_device_name(0), "modes": []}
    for kind in ("sgd", "momentum", "adam"):
        opt = se.Optimizer(kind)
        kw = dict(coeff_kind=0, reg_kind="dim_sparsity", lam=LAM, dim_sparsity=ds,
                  lr=LR[kind], n_total_workers=K, optimizer=opt)
        w0 = torch.zeros(D, device="cuda")
        w1, st1 = se.sync_epoch(w0, epoch_ids(), *data, **kw,
                                opt_state=se.init_opt_state(opt, D, "cuda"))
        for label, ids, mode_kw, iters in (
                (f"{kind} K={K} epoch", epoch_ids(), {}, 1),
                (f"{kind} mean mode K=1 dispatch",
                 torch.from_numpy(rng.integers(0, sub, (DISPATCH, 1, B))).cuda(),
                 {"n_total_workers": 1, "grad_divisor": B}, 20)):
            args_kw = dict(kw, **mode_kw)
            launch = lambda: se.sync_epoch(w1, ids, *data, **args_kw, opt_state=st1)  # noqa: E731
            ms, runs = time_ms(launch, iters)
            outs = {digest(launch()) for _ in range(args.launches)}
            got = se.sync_epoch(w1, ids[:20].contiguous(), *data, **args_kw, opt_state=st1)
            want = se.sync_epoch_plain(w1, ids[:20].contiguous(), *data, **args_kw,
                                       opt_state=st1)
            err = max(float((a - b).abs().max()) for a, b in
                      zip((got[0],) + got[1].vectors, (want[0],) + want[1].vectors))
            out["modes"].append({"mode": label, "ms": ms, "ms_runs": runs,
                                 f"distinct_outputs_of_{args.launches}": len(outs),
                                 "max_abs_err_20_steps": err})
            print(json.dumps(out["modes"][-1]), file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
