"""Time and check ``worker_grads`` of one checkout of the port on the card.

    python distributed_sgd_tpu_torch/tools/worker_grads_routes.py [--root DIR] [--label L]
        [--user-rule]

Imports ``distributed_sgd_tpu_torch`` from ``--root`` (default: the
checkout this file is in), builds its ``worker_grads`` kernel and prints
one JSON line.  At the RPC reply's shape (K=1, B=100) and at the per-step
path's (K=8, B=100), both at P=76, D=47,236 with RCV1-like rows:

- ``call_us``: a call's time, CUDA events over 200 back-to-back calls
  after 20 warm-up calls, in turns with the plain version (``plain_us``):
  whichever is slower, the host's enqueue or the device;
- ``graph_us``: the device's time, 10 calls captured in one CUDA graph,
  replayed 20 times between CUDA events, over the 200 calls;
- ``kernel_us``: the device's kernel time alone, the durations
  ``torch.profiler`` gives the device events of 200 calls (the route's
  kernels: it allocates without a fill), summed;
- ``enqueue_us``: the host's time, ``time.perf_counter`` over 200 calls
  with no synchronise until after the last;

the largest difference from the plain version, and whether 40 launches
on one input gave one output.  Then ``digests``: the sha256 of the
output bytes for each input case of ``chip_smoke.py``'s phase 3
(``check_cases``, which the smoke imports from here).  Run it on two
checkouts in one process each, in turns (a, b, b, a), in one call: equal
digests mean the two kernels give the same output bit for bit.

``--user-rule`` times the shapes with the squared hinge as a model's own
rule (ops/coeff.py: the kernel's variant built from ``SQUARED_HINGE_CUDA``,
the custom-model example's body) in place of the built-in hinge; run it
in turns with a run without it to compare the two routes (a checkout
that has ops/coeff.py).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

SHAPES = ((1, 100), (8, 100))
# the built-in rules' kinds, numbered alike in every checkout (ops/coeff.py)
HINGE, LOGISTIC, LEAST_SQUARES = 0, 1, 2
COEFF_KINDS = (HINGE, LOGISTIC, LEAST_SQUARES)
SQUARED_HINGE_CUDA = "const float t = 1.f - y * m;\nreturn -2.f * y * (t < 0.f ? 0.f : t);"
K, B, P, D = 3, 100, 76, 47236  # the main path's shape
REPEATS = 40
CALLS, GRAPH_CALLS = 200, 10
WIDE_D = 100_003  # the K=2 case's features: 17 ranges a worker


def main_path_batch(seed: int):
    """[K, B, P] rows shaped like the main path's batches: RCV1-like
    Zipf ids with duplicate draws zeroed, cosine-normalised ltc values."""
    import numpy as np

    from distributed_sgd_tpu_torch.data.synthetic import rcv1_like

    ds = rcv1_like(K * B, n_features=D, nnz=P, seed=seed, idf_values=True)
    return (ds.indices.reshape(K, B, P), ds.values.reshape(K, B, P),
            ds.labels.reshape(K, B).astype(np.float32))


def edge_batch(k: int, b: int, p: int, seed: int, dups: bool = False,
               pad_rows: bool = False, d: int = D):
    import numpy as np

    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (k, b, p)).astype(np.int32)
    val = rng.normal(size=(k, b, p)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], (k, b)).astype(np.float32)
    if dups and p > 1:
        idx[:, :, 1] = idx[:, :, 0]
    if pad_rows:
        idx[:, ::3], val[:, ::3], y[:, ::3] = 0, 0.0, 0.0
    return idx, val, y


def check_cases():
    """Phase 3's ``worker_grads`` inputs: (label, w, (idx, val, y), kind),
    numpy arrays made from seeds."""
    import numpy as np

    rng = np.random.default_rng(0)
    cases = [(f"main-shape kind={kind}", main_path_batch(kind), kind) for kind in COEFF_KINDS]
    cases += [
        ("B=37", edge_batch(3, 37, P, 1), HINGE),
        ("P=1", edge_batch(3, B, 1, 2), LOGISTIC),
        ("duplicate ids", edge_batch(3, B, P, 3, dups=True), LEAST_SQUARES),
        ("all-pad rows", edge_batch(3, B, P, 4, pad_rows=True), HINGE),
        ("K=1", edge_batch(1, B, P, 5), HINGE),
        ("K=8 B=1024", edge_batch(8, 1024, P, 6), HINGE),
        ("K=8 B=1024 logistic", edge_batch(8, 1024, P, 7), LOGISTIC),
    ]
    out = [(label, (rng.normal(size=D) * 0.1).astype(np.float32), a, kind)
           for label, a, kind in cases]
    wide = (rng.normal(size=WIDE_D) * 0.1).astype(np.float32)
    out.append((f"K=2 D={WIDE_D}", wide, edge_batch(2, B, P, 8, d=WIDE_D), LOGISTIC))
    out.append(("D=1", np.array([0.1], np.float32), edge_batch(3, B, 4, 9, d=1), HINGE))
    # a non-finite term: one value inf in a sampled row, from w = 0 (a
    # margin that read the inf weight would be NaN, and the plain version
    # multiplies entries the kernel skips by it)
    idx, val, y = edge_batch(3, B, P, 10)
    val[1, 0, 0] = np.inf
    out.append(("non-finite term", np.zeros(D, np.float32), (idx, val, y), HINGE))
    return out


def card() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(here)))
    ap.add_argument("--label", default=None)
    ap.add_argument("--user-rule", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
    from distributed_sgd_tpu_torch.ops import worker_grads as wg

    if not torch.cuda.is_available():
        print("worker_grads_routes: no CUDA device", file=sys.stderr)
        return 1

    def time_us(fn, iters=CALLS, warmup=20):
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

    def graph_us(fn):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(GRAPH_CALLS):
                fn()
        replays = CALLS // GRAPH_CALLS
        return time_us(graph.replay, iters=replays, warmup=2) / GRAPH_CALLS

    def kernel_us(fn):
        from torch.profiler import ProfilerActivity, profile

        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(CALLS):
                fn()
            torch.cuda.synchronize()
        cuda = torch.autograd.DeviceType.CUDA
        total = sum(ev.time_range.elapsed_us() for ev in prof.events() if ev.device_type == cuda)
        return total / CALLS

    def enqueue_us(fn):
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / CALLS * 1e6

    rule = HINGE
    if args.user_rule:
        from distributed_sgd_tpu_torch.ops import coeff

        def squared_hinge(m, y):
            return -2.0 * y.float() * torch.clamp(1.0 - y.float() * m, min=0.0)

        rule = coeff.user(squared_hinge, SQUARED_HINGE_CUDA, "SquaredHinge")
    out = {"label": args.label or args.root, "source": wg.__file__, "card": card(),
           "device": torch.cuda.get_device_name(0),
           "rule": "SquaredHinge (a user rule)" if args.user_rule else "hinge",
           "shapes": [], "digests": {}}
    rng = np.random.default_rng(0)
    for k, b in SHAPES:
        ds = rcv1_like(k * b, n_features=D, nnz=P, seed=k, idf_values=True)
        w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
        a = [torch.from_numpy(x).cuda() for x in (
            ds.indices.reshape(k, b, P), ds.values.reshape(k, b, P),
            ds.labels.reshape(k, b).astype(np.float32))]
        kernel = lambda: wg.worker_grads(w, *a, rule)  # noqa: E731
        plain = lambda: wg.worker_grads_plain(w, *a, rule)  # noqa: E731
        first = kernel()
        identical = all(torch.equal(first, kernel()) for _ in range(REPEATS - 1))
        err = float((first - plain()).abs().max())
        p_us = [time_us(plain)]
        k_us = [time_us(kernel), time_us(kernel)]
        p_us.append(time_us(plain))
        e_us = [enqueue_us(kernel), enqueue_us(kernel)]
        try:
            g_us, refused = [graph_us(kernel), graph_us(kernel)], None
        except RuntimeError as e:  # the profiler's sums stand alone
            g_us, refused = [], str(e)
        kn_us = kernel_us(kernel)
        out["shapes"].append({
            "K": k, "B": b, "max_abs_err": err, f"bitwise_identical_over_{REPEATS}": identical,
            "call_us": min(k_us), "graph_us": min(g_us, default=None), "kernel_us": kn_us,
            "enqueue_us": min(e_us), "plain_us": min(p_us), "call_us_runs": k_us,
            "graph_us_runs": g_us, "graph_refused": refused, "enqueue_us_runs": e_us,
            "plain_us_runs": p_us})
    for label, w_np, arrays, kind in check_cases():
        w = torch.from_numpy(w_np).cuda()
        got = wg.worker_grads(w, *[torch.from_numpy(x).cuda() for x in arrays], kind)
        out["digests"][label] = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
