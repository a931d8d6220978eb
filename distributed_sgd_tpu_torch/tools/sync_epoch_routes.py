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
input gave (and the least sha256 of them: equal digests from two
checkouts are the same bits), and the largest difference from the plain
version over the first 20 steps.  Then ``cases``: the sha256 of the
output of each of about 50 small launches (every rule and regularizer at
the main shape and in the mean mode, ``chip_smoke.py`` phase 3's edges,
the optimizers, a model's own rule where the checkout has one, a
non-finite term).  Run it on two checkouts in one process each, in turns
(a, b, b, a), to compare two routes of the kernel on one card: equal
digests are the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys

N, K, B, P, D, STEPS, DISPATCH = 643531, 3, 100, 76, 47236, 2146, 64
LAM = 1e-5
LR = {"sgd": 0.5, "momentum": 0.05, "adam": 0.001}
RULE_LR = {0: 0.5, 1: 0.5, 2: 0.05}  # hinge, logistic, least squares; a model's own 0.1
REGS = ("dim_sparsity", "l2", "none")


def case_digests(se, rule_kw, data, ds):
    """{label: sha256} of w (and the optimizer state) after each small
    launch of `se.sync_epoch` on the card (see the module's docstring)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(5)
    w_rand = torch.from_numpy(rng.normal(size=D).astype(np.float32) * 0.1).cuda()

    def on_card(*arrays):
        return tuple(torch.from_numpy(a).cuda() for a in arrays)

    def edge_rows(seed, p, n=3000, features=D):
        # a repeated id in each row and every third row all pad (chip_smoke edge_data)
        r = np.random.default_rng(seed)
        idx = r.integers(0, features, (n, p)).astype(np.int32)
        val = (r.normal(size=(n, p)) / np.sqrt(p)).astype(np.float32)
        y = r.choice([-1.0, 1.0], n).astype(np.float32)
        if p > 1:
            idx[:, 1] = idx[:, 0]
        if features == D:
            idx[::3], val[::3], y[::3] = 0, 0.0, 0.0
        return on_card(idx, val, y)

    def ids(shape, hi):
        return torch.from_numpy(rng.integers(0, hi, shape)).cuda()

    busy = (data[0][:3000].clone(), data[1][:3000].clone(), data[2][:3000])
    busy[0][:, 0], busy[1][:, 0] = 0, 0.1  # feature 0 in every row
    edge, few = edge_rows(7, P), edge_rows(20, 8, features=300)
    n = data[0].shape[0]
    cases = []  # (label, data, ids, rule, reg, extra keywords)
    for kind in (0, 1, 2):
        for reg in REGS:
            cases.append((f"main kind={kind} reg={reg}", data, ids((20, K, B), n), kind, reg, {}))
            cases.append((f"mean mode kind={kind} reg={reg}", data, ids((DISPATCH, 1, B), n), kind,
                          reg, {"n_total_workers": 1, "grad_divisor": B}))
    cases += [("K=1 B=37", data, ids((20, 1, 37), n), 0, "dim_sparsity", {}),
              ("S=1", data, ids((1, K, B), n), 1, "l2", {}),
              ("S=0", data, ids((0, K, B), n), 0, "dim_sparsity", {}),
              ("duplicate ids kind=0", edge, ids((20, K, B), 10), 0, "dim_sparsity", {}),
              ("duplicate ids kind=2", edge, ids((20, K, B), 10), 2, "dim_sparsity",
               {"lr": 0.01}),
              ("all-pad rows", edge, ids((20, K, B), 1000) * 3, 0, "l2", {}),
              ("K=4 B=150", data, ids((20, 4, 150), n), 0, "dim_sparsity", {}),
              ("P=200", edge_rows(8, 200), ids((20, K, B), 3000), 1, "dim_sparsity", {}),
              ("P=1", edge_rows(9, 1), ids((20, K, B), 3000), 0, "none", {}),
              ("one feature in every row", busy, ids((20, K, B), 3000), 0, "dim_sparsity", {}),
              ("rows over 300 features", few, ids((20, K, 20), 3000), 0, "dim_sparsity", {}),
              ("lr 0", data, ids((20, K, B), n), 0, "dim_sparsity", {"lr": 0.0}),
              ("lr -0.01", data, ids((20, K, B), n), 0, "dim_sparsity", {"lr": -0.01}),
              ("a NaN weight", data, ids((1, K, B), n), 0, "dim_sparsity", {"nan": True})]
    for kind in ("momentum", "adam"):
        for shape, extra in (((20, K, B), {}),
                             ((DISPATCH, 1, B), {"n_total_workers": 1, "grad_divisor": B})):
            cases.append((f"{kind} {shape}", data, ids(shape, n), 0, "dim_sparsity",
                           dict(extra, optimizer=se.Optimizer(kind), lr=LR[kind])))
    try:  # a model's own rule, in checkouts that have one
        from examples_torch.custom_model import SquaredHinge

        rule = SquaredHinge(LAM, D, regularizer="l2", device="cuda").coeff
        for label, shape, extra in (
                ("sgd", (20, K, B), {}), ("K=4 B=150", (20, 4, 150), {}),
                ("mean", (DISPATCH, 1, B), {"n_total_workers": 1, "grad_divisor": B}),
                ("window", (4, 1, B), {"n_total_workers": 1}),
                ("adam", (20, K, B), {"optimizer": se.Optimizer("adam"), "lr": 0.001})):
            cases.append((f"own rule {label}", data, ids(shape, n), rule, "l2", extra))
    except ImportError:
        pass
    inf = (data[0], data[1].clone(), data[2])
    first = ids((1, K, B), n)
    inf[1][int(first[0, 0, 0]), 0] = float("inf")
    cases.append(("non-finite term", inf, first, 0, "l2", {"start": "zero"}))

    out = {}
    for label, (idx, val, y), case_ids, rule, reg, extra in cases:
        extra = dict(extra)
        w = torch.zeros(D, device="cuda") if extra.pop("start", None) else w_rand
        if extra.pop("nan", False):
            w = w.clone()
            w[D - 1] = float("nan")  # no pad entry names the last feature
        kw = {rule_kw: rule, "reg_kind": reg, "lam": LAM, "dim_sparsity": ds,
              "lr": RULE_LR[rule] if isinstance(rule, int) else 0.1,
              "n_total_workers": case_ids.shape[1]}
        kw.update(extra)
        if "optimizer" in kw:
            kw["opt_state"] = se.init_opt_state(kw["optimizer"], D, "cuda")
        got = se.sync_epoch(w, case_ids, idx, val, y, **kw)
        parts = (got[0],) + tuple(got[1].vectors) if isinstance(got, tuple) else (got,)
        h = hashlib.sha256()
        for t in parts:
            h.update(t.cpu().numpy().tobytes())
        out[label] = h.hexdigest()[:16]
    return out


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

    # the rule's keyword: `coeff_kind` in checkouts older than `coeff`
    rule_kw = "coeff" if "coeff" in inspect.signature(se.sync_epoch).parameters else "coeff_kind"
    out = {"label": args.label or args.root, "source": se.__file__,
           "card": torch.cuda.get_device_name(0), "modes": []}
    for kind in ("sgd", "momentum", "adam"):
        opt = se.Optimizer(kind)
        kw = {rule_kw: 0, "reg_kind": "dim_sparsity", "lam": LAM, "dim_sparsity": ds,
              "lr": LR[kind], "n_total_workers": K, "optimizer": opt}
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
                                 "digest": min(outs),
                                 "max_abs_err_20_steps": err})
            print(json.dumps(out["modes"][-1]), file=sys.stderr, flush=True)
    out["cases"] = case_digests(se, rule_kw, data, ds)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
