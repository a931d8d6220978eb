#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (an H100).

    python3 chip_smoke.py

Phases, each fatal (a traceback and a non-zero exit):

1. device: require CUDA; print the card's name and power limit;
2. build: compile every CUDA kernel of the port from csrc/ with nvcc, one
   process per source, all started together;
3. kernels: hold each kernel against its plain torch version on the same
   CUDA tensors, at the main path's shapes and at edge shapes, and time
   both (CUDA events, in turns: plain, kernel, kernel, plain) -- for
   ``sync_epoch`` over one full 2,146-step epoch;
4. engine: one epoch of the sync engine on the card against the same
   epoch on the CPU, fed the same sample ids;
5. paths: ``main()`` of the port at full width (804,414 synthetic
   RCV1-shaped rows x 47,236 features, 3 epochs), checking that the test
   loss falls, the test accuracy, and that each epoch was one
   ``sync_epoch`` launch and no step launched ``worker_grads``; then the
   per-step path (8 workers, whose state does not fit one cluster; depth
   cut to 100,000 rows and 1 epoch), checking that every step launched
   ``worker_grads``; then a 2-epoch main-path run under ``torch.profiler``
   for the device's busy share over one epoch;
6. summary: the card line, one JSON line of per-kernel numbers, and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager

import numpy as np
import torch

from distributed_sgd_tpu_torch import main as port_main
from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import sync_epoch as se
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, steps_per_epoch_for

# published H100 SXM peaks: HBM bytes/s and f32 (non-tensor-core) FLOP/s
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# the bound tests/test_pallas_kernels.py holds the Pallas kernel to
# against the blocked path; atomics reorder f32 sums the same way
RTOL, ATOL = 1e-4, 1e-5
K, B, P, D = 3, 100, 76, 47236  # the main path's worker_grads shape
MAIN_ROWS, MAIN_EPOCHS = 804414, 3
TRAIN_ROWS, STEPS = 643531, 2146  # the main path's train split and steps per epoch
LAM = 1e-5  # the CLI's default lambda
# per-rule step for the 20-step cases: least squares sums B squared-error
# gradients per worker and diverges at the CLI's 0.5
LR_FOR = {wg.HINGE: 0.5, wg.LOGISTIC: 0.5, wg.LEAST_SQUARES: 0.05}
SE_ATOL = 1e-5  # weights after 20 steps: atomics reorder the f32 sums of g
PER_STEP_TEST_ACC = 0.8080  # the main path's final test accuracy with the per-step path
PER_STEP_ROWS, PER_STEP_WORKERS = 100000, 8


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean milliseconds per call over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main_path_batch(seed: int):
    """[K, B, P] rows shaped like the main path's batches: RCV1-like
    Zipf ids with duplicate draws zeroed, cosine-normalised ltc values."""
    ds = rcv1_like(K * B, n_features=D, nnz=P, seed=seed, idf_values=True)
    return (ds.indices.reshape(K, B, P), ds.values.reshape(K, B, P),
            ds.labels.reshape(K, B).astype(np.float32))


def edge_batch(k: int, b: int, p: int, seed: int, dups: bool = False, pad_rows: bool = False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, (k, b, p)).astype(np.int32)
    val = rng.normal(size=(k, b, p)).astype(np.float32)
    y = rng.choice([-1.0, 1.0], (k, b)).astype(np.float32)
    if dups and p > 1:
        idx[:, :, 1] = idx[:, :, 0]
    if pad_rows:
        idx[:, ::3], val[:, ::3], y[:, ::3] = 0, 0.0, 0.0
    return idx, val, y


def check_worker_grads() -> dict:
    """Kernel against plain version; returns the kernel's summary row."""
    rng = np.random.default_rng(0)
    cases = [(f"main-shape kind={kind}", main_path_batch(kind), kind) for kind in wg.COEFF_KINDS]
    cases += [
        ("B=37", edge_batch(3, 37, P, 1), wg.HINGE),
        ("P=1", edge_batch(3, B, 1, 2), wg.LOGISTIC),
        ("duplicate ids", edge_batch(3, B, P, 3, dups=True), wg.LEAST_SQUARES),
        ("all-pad rows", edge_batch(3, B, P, 4, pad_rows=True), wg.HINGE),
        ("K=1", edge_batch(1, B, P, 5), wg.HINGE),
    ]
    max_err = 0.0
    for label, (idx, val, y), kind in cases:
        w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
        args = [torch.from_numpy(a).cuda() for a in (idx, val, y)]
        got = wg.worker_grads(w, *args, kind)
        want = wg.worker_grads_plain(w, *args, kind)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())
        print(f"worker_grads {label}: max_abs_err={err:.3e} nonzero={int((want != 0).sum())}",
              flush=True)
        if not ok:
            raise AssertionError(f"worker_grads {label} disagrees with its plain version "
                                 f"(max abs err {err}, rtol {RTOL}, atol {ATOL})")
        max_err = max(max_err, err)

    # timing at the main path's shape, hinge (the main path's model)
    idx, val, y = main_path_batch(0)
    w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
    args = [w] + [torch.from_numpy(a).cuda() for a in (idx, val, y)] + [wg.HINGE]
    kernel = lambda: wg.worker_grads(*args)  # noqa: E731
    plain = lambda: wg.worker_grads_plain(*args)  # noqa: E731
    plain_ms = [time_ms(plain)]
    kernel_ms = [time_ms(kernel), time_ms(kernel)]
    plain_ms.append(time_ms(plain))
    nz = val != 0
    n_nz = int(nz.sum())
    bytes_moved = idx.nbytes + val.nbytes + y.nbytes + 4 * len(np.unique(idx[nz])) + 4 * K * D
    flops = 4 * n_nz + 8 * K * B  # margin mul+add, scatter mul+add; the coefficient
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOPS * 1e3
    row = {
        "kernel": "worker_grads", "max_abs_err": max_err,
        "kernel_us": min(kernel_ms) * 1e3, "plain_us": min(plain_ms) * 1e3,
        "bound_us": max(bound_bytes_ms, bound_ops_ms) * 1e3,
        "kernel_us_runs": [t * 1e3 for t in kernel_ms],
        "plain_us_runs": [t * 1e3 for t in plain_ms],
        "bytes": bytes_moved, "flops": flops,
    }
    print(json.dumps(row), flush=True)
    return {
        "name": "worker_grads", "route": "cuda",
        "source": "distributed_sgd_tpu_torch/csrc/worker_grads.cu",
        "replaces": "distributed_sgd_tpu/ops/pallas_sparse.py:154",
        "launches": None, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        # no single PyTorch call computes the fused gather + coefficient + scatter
        "library_ms": None,
    }


def on_card(data: Dataset) -> dict:
    return {"indices": torch.from_numpy(data.indices).cuda(),
            "values": torch.from_numpy(data.values).cuda(),
            "labels_f32": torch.from_numpy(data.labels.astype(np.float32)).cuda(),
            "dim_sparsity": torch.from_numpy(dim_sparsity(data)).cuda()}


def edge_data(n: int, seed: int, p: int = P) -> Dataset:
    """Rows with a duplicate feature id in each row and every third row an
    all-pad row (idx 0, val 0, label 0)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, (n, p)).astype(np.int32)
    val = (rng.normal(size=(n, p)) / np.sqrt(p)).astype(np.float32)
    y = rng.choice([-1, 1], n).astype(np.int32)
    if p > 1:
        idx[:, 1] = idx[:, 0]
    idx[::3], val[::3], y[::3] = 0, 0.0, 0
    return Dataset(idx, val, y, D)


def sync_epoch_args(data: dict, ids: np.ndarray, kind: int, reg: str, w0=None, lr=None):
    w = torch.zeros(D, device="cuda") if w0 is None else w0
    args = (w, torch.from_numpy(ids).cuda(), data["indices"], data["values"], data["labels_f32"])
    kw = dict(coeff_kind=kind, reg_kind=reg, lam=LAM, dim_sparsity=data["dim_sparsity"],
              lr=LR_FOR[kind] if lr is None else lr, n_total_workers=ids.shape[1])
    return args, kw


def hinge_objective(w: torch.Tensor, data: dict, rows: int) -> float:
    """lam ||w||^2 + mean hinge loss over the first `rows` rows."""
    m = (w[data["indices"][:rows].long()] * data["values"][:rows]).sum(dim=1)
    y = data["labels_f32"][:rows]
    return float(LAM * (w * w).sum() + torch.clamp(1.0 + y * torch.sign(m), min=0).mean())


def check_sync_epoch() -> dict:
    """The epoch kernel against its plain version; returns its summary row."""
    t0 = time.perf_counter()
    train = rcv1_like(TRAIN_ROWS, n_features=D, nnz=P, seed=0, idf_values=True)
    main_data = on_card(train)
    edge = edge_data(3000, 7)
    edge_card = on_card(edge)
    print(f"sync_epoch data seconds: {time.perf_counter() - t0:.2f}", flush=True)
    rng = np.random.default_rng(1)
    w_rand = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
    pad_rows = np.arange(0, 3000, 3)
    cases = [(f"main-shape kind={kind} reg={reg}", main_data,
              rng.integers(0, TRAIN_ROWS, (20, K, B)), kind, reg, w_rand, None)
             for kind in wg.COEFF_KINDS for reg in se.REG_KINDS]
    cases += [
        ("K=1 B=37", main_data, rng.integers(0, TRAIN_ROWS, (20, 1, 37)), wg.HINGE,
         "dim_sparsity", None, None),
        ("S=1", main_data, rng.integers(0, TRAIN_ROWS, (1, K, B)), wg.LOGISTIC, "l2",
         w_rand, None),
        ("S=0", main_data, rng.integers(0, TRAIN_ROWS, (0, K, B)), wg.HINGE,
         "dim_sparsity", w_rand, None),
        # 10 rows, each about 30 times a step: least squares then moves each
        # margin by about 30 * lr * 2 / K of its residual, so lr 0.01 keeps
        # the iteration contracting instead of amplifying rounding
        ("duplicate ids kind=0", edge_card, rng.integers(0, 10, (20, K, B)), wg.HINGE,
         "dim_sparsity", w_rand, None),
        ("duplicate ids kind=2", edge_card, rng.integers(0, 10, (20, K, B)),
         wg.LEAST_SQUARES, "dim_sparsity", w_rand, 0.01),
        ("all-pad rows", edge_card, rng.choice(pad_rows, (20, K, B)), wg.HINGE, "l2",
         w_rand, None),
        # more samples than the cluster holds at once (512): two rounds a step
        ("K=7", main_data, rng.integers(0, TRAIN_ROWS, (20, 7, B)), wg.HINGE,
         "dim_sparsity", w_rand, None),
        # rows wider than the 128 entries the lanes hold in registers
        ("P=200", on_card(edge_data(3000, 8, p=200)), rng.integers(0, 3000, (20, K, B)),
         wg.LOGISTIC, "dim_sparsity", w_rand, None),
        ("P=1", on_card(edge_data(3000, 9, p=1)), rng.integers(0, 3000, (20, K, B)),
         wg.HINGE, "none", w_rand, None),
    ]
    max_err = 0.0
    for label, data, ids, kind, reg, w0, lr in cases:
        args, kw = sync_epoch_args(data, ids, kind, reg, w0, lr)
        w_in = args[0].clone()
        got = se.sync_epoch(*args, **kw)
        want = se.sync_epoch_plain(*args, **kw)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        moved = float((want - w_in).abs().max())
        print(f"sync_epoch {label}: max_abs_err={err:.3e} weights moved {moved:.3e}", flush=True)
        if not bool(torch.equal(args[0], w_in)):
            raise AssertionError(f"sync_epoch {label} wrote its input weights")
        if not err <= SE_ATOL:
            raise AssertionError(f"sync_epoch {label} disagrees with its plain version "
                                 f"(max abs err {err}, atol {SE_ATOL})")
        max_err = max(max_err, err)

    # one full epoch at the main path's shape: hinge, dim_sparsity, K=3
    # workers each drawing from its own third of the train rows
    sub = -(-TRAIN_ROWS // K)
    ids = (rng.integers(0, sub, (STEPS, K, B)) % np.minimum(sub, TRAIN_ROWS - np.arange(K) * sub)
           [:, None] + (np.arange(K) * sub)[:, None])
    args, kw = sync_epoch_args(main_data, ids, wg.HINGE, "dim_sparsity")
    kw["lr"] = 0.5
    kernel = lambda: se.sync_epoch(*args, **kw)  # noqa: E731
    plain = lambda: se.sync_epoch_plain(*args, **kw)  # noqa: E731
    kernel()
    se.sync_epoch_plain(args[0], args[1][:20], *args[2:], **kw)
    plain_ms = [time_ms(plain, iters=1, warmup=0)]
    kernel_ms = [time_ms(kernel, iters=1, warmup=0), time_ms(kernel, iters=1, warmup=0)]
    plain_ms.append(time_ms(plain, iters=1, warmup=0))
    w_k, w_p = kernel(), plain()
    torch.cuda.synchronize()
    obj_k, obj_p = (hinge_objective(w, main_data, 100000) for w in (w_k, w_p))
    print(f"sync_epoch full epoch: kernel vs plain weights max_abs_err="
          f"{float((w_k - w_p).abs().max()):.3e}; hinge objective on 100,000 rows "
          f"kernel {obj_k:.7f} plain {obj_p:.7f}", flush=True)
    if abs(obj_k - obj_p) > 1e-3 * abs(obj_p):
        raise AssertionError("the full-epoch objective of the kernel and plain version differ")

    # the bound: each input byte read once (the distinct rows this epoch
    # samples, its ids, w and dim_sparsity), each output byte written once
    row_nnz = (train.values != 0).sum(axis=1)
    rows = np.unique(ids)
    bytes_moved = len(rows) * (8 * P + 4) + ids.nbytes + 3 * 4 * D
    # per sampled row: the margin and the scatter, a mul and an add per
    # nonzero; per step and feature: K adds of g, K masked adds of the
    # regularizer, the mean, the update, and the w . dim_sparsity partial
    flops = 4 * int(row_nnz[ids].sum()) + STEPS * D * (2 * K + 5)
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOPS * 1e3
    row = {
        "kernel": "sync_epoch", "max_abs_err": max_err, "steps": STEPS,
        "kernel_ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "kernel_ms_runs": kernel_ms, "plain_ms_runs": plain_ms,
        "bytes": bytes_moved, "distinct_rows": len(rows), "flops": flops,
        "bytes_every_visit": ids.size * (8 * P + 4) + ids.nbytes + 3 * 4 * D,
    }
    print(json.dumps(row), flush=True)
    return {
        "name": "sync_epoch", "route": "cuda",
        "source": "distributed_sgd_tpu_torch/csrc/sync_epoch.cu",
        "replaces": "distributed_sgd_tpu/ops/pallas_sparse.py:154",
        "launches": None, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        # no single PyTorch call runs the steps of an epoch
        "library_ms": None,
    }


def check_engine() -> None:
    """One epoch on the card against the same epoch on the CPU."""
    data = rcv1_like(3000, n_features=2000, nnz=20, seed=5, idf_values=True)
    ds = dim_sparsity(data)
    bounds = {}
    for dev in ("cuda", "cpu"):
        model = make_model("hinge", 1e-4, 2000, dim_sparsity=ds, device=dev)
        bounds[dev] = SyncEngine(model, batch_size=50, learning_rate=0.5,
                                 virtual_workers=3, device=dev).bind(
            Dataset(data.indices, data.values, data.labels, data.n_features))
    gpu, cpu = bounds["cuda"], bounds["cpu"]
    sub, starts, sizes = cpu._subshards()
    sel = np.random.default_rng(0).integers(0, sub, (cpu.steps_per_epoch, 3, 50))
    ids = torch.from_numpy(sel % np.minimum(sub, sizes)[:, None] + starts[:, None])
    if not gpu.epoch_kernel:
        raise AssertionError("the engine at K=3, D=2000 did not pick the sync_epoch kernel")
    gpu._sample_ids = lambda key: ids.cuda()
    cpu._sample_ids = lambda key: ids
    w_gpu = gpu.epoch(torch.zeros(2000, device="cuda"), 0)
    w_cpu = cpu.epoch(torch.zeros(2000), 0)
    torch.cuda.synchronize()
    err = float((w_gpu.cpu() - w_cpu).abs().max())
    ev_gpu, ev_cpu = gpu.evaluate(w_gpu), cpu.evaluate(w_cpu)
    print(f"engine: weights max_abs_err={err:.3e} evaluate gpu={ev_gpu} cpu={ev_cpu}", flush=True)
    # atol 1e-5 on weights (atomic sums reorder over 20 steps); rtol 1e-5 on evaluate
    if err > 1e-5 or not np.allclose(ev_gpu, ev_cpu, rtol=1e-5, atol=0):
        raise AssertionError("sync engine on the card disagrees with the CPU run")


@contextmanager
def cli_env(**env):
    """DSGD_* settings for one CLI run, restored afterwards."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def reset_counts() -> None:
    wg.worker_grads.launches = 0
    se.sync_epoch.launches = se.sync_epoch.steps = 0


def run_main_path() -> int:
    """The port's CLI run at full width; returns the sync_epoch launches."""
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS, DSGD_MAX_EPOCHS=MAIN_EPOCHS):
        reset_counts()
        t0 = time.perf_counter()
        run = port_main.main()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches, steps_run = se.sync_epoch.launches, se.sync_epoch.steps
        wg_launches = wg.worker_grads.launches
    fit = run.fit
    steps = steps_per_epoch_for(int(MAIN_ROWS * 0.8), 1, 3, 100)
    print(f"data generation seconds: {run.data_seconds:.3f}")
    for e, s in enumerate(fit.epoch_seconds):
        print(f"epoch {e} seconds: {s:.4f} steps/s: {fit.steps_per_epoch / s:.1f}")
    print(f"main path seconds: {total_s:.3f}")
    print(f"test losses: {fit.test_losses} test accuracies: {fit.test_accuracies}")
    print(f"sync_epoch launches: {launches} steps: {steps_run}; worker_grads launches: "
          f"{wg_launches} (steps per epoch {fit.steps_per_epoch})", flush=True)
    w = fit.weights
    if w.shape != (D,) or not bool(torch.isfinite(w).all()):
        raise AssertionError(f"final weights not finite f32[{D}]: {w.shape}")
    if fit.epochs_run != MAIN_EPOCHS or fit.steps_per_epoch != steps or steps != STEPS:
        raise AssertionError(f"ran {fit.epochs_run} epochs of {fit.steps_per_epoch} steps, "
                             f"want {MAIN_EPOCHS} of {STEPS}")
    # at w = 0 every hinge prediction is 0 and the test loss is 1
    losses = [1.0] + fit.test_losses
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"test loss did not fall every epoch: {fit.test_losses}")
    acc = fit.test_accuracies[-1]
    if acc < 0.70 or abs(acc - PER_STEP_TEST_ACC) > 0.005:
        raise AssertionError(f"test accuracy {acc}: want >= 0.70 and within 0.005 of "
                             f"{PER_STEP_TEST_ACC}, the per-step path's")
    if (launches, steps_run, wg_launches) != (MAIN_EPOCHS, MAIN_EPOCHS * steps, 0):
        raise AssertionError(
            f"sync_epoch launched {launches} times over {steps_run} steps and worker_grads "
            f"{wg_launches} times; want {MAIN_EPOCHS}, {MAIN_EPOCHS * steps} and 0")
    return launches


def run_per_step_path() -> int:
    """The CLI with 8 workers, whose state does not fit one cluster: every
    step launches worker_grads.  Returns those launches."""
    if se.cluster_plan(PER_STEP_WORKERS, D) is not None:
        raise AssertionError(f"K={PER_STEP_WORKERS} at D={D} fits a cluster")
    with cli_env(DSGD_SYNTHETIC=PER_STEP_ROWS, DSGD_MAX_EPOCHS=1,
                 DSGD_NODE_COUNT=PER_STEP_WORKERS):
        reset_counts()
        run = port_main.main()
        torch.cuda.synchronize()
        launches, se_launches = wg.worker_grads.launches, se.sync_epoch.launches
    fit = run.fit
    steps = steps_per_epoch_for(int(PER_STEP_ROWS * 0.8), 1, PER_STEP_WORKERS, 100)
    print(f"per-step path: epoch seconds {fit.epoch_seconds[0]:.4f} "
          f"steps/s {fit.steps_per_epoch / fit.epoch_seconds[0]:.1f}; test loss "
          f"{fit.test_losses[0]:.6f} accuracy {fit.test_accuracies[0]:.4f}; worker_grads "
          f"launches {launches}, sync_epoch launches {se_launches}", flush=True)
    if (launches, se_launches) != (steps, 0) or fit.test_losses[0] >= 1.0:
        raise AssertionError(f"per-step path: worker_grads launched {launches} times and "
                             f"sync_epoch {se_launches}; want {steps} and 0, and a "
                             f"test loss below 1 (got {fit.test_losses[0]})")
    return launches


def busy_share() -> None:
    """Two main-path epochs under torch.profiler; prints the device's busy
    share from one sync_epoch launch to the next: one epoch's training,
    its train and test evaluation and the next epoch's id draw."""
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS, DSGD_MAX_EPOCHS=2), \
            tempfile.TemporaryDirectory() as tmp:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            port_main.main()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
           for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    starts = sorted(t0 for t0, _, name in dev if "sync_epoch" in name)
    if len(starts) < 2:
        print(f"device busy share: not measured (the trace holds {len(dev)} device "
              f"events and {len(starts)} sync_epoch kernels)", flush=True)
        return
    lo, hi = starts[0], starts[1]
    busy, kernel_us, end = 0.0, 0.0, lo
    for t0, t1, name in sorted(dev):
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 <= t0:
            continue
        if "sync_epoch" in name:
            kernel_us += t1 - t0
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
    print(f"device busy share over one epoch ({hi - lo:.1f} us from one sync_epoch launch "
          f"to the next): {busy / (hi - lo):.4f}; sync_epoch kernel {kernel_us:.1f} us, "
          f"other device work {busy - kernel_us:.1f} us, idle {hi - lo - busy:.1f} us",
          flush=True)


def main() -> None:
    phase("1 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels need one", file=sys.stderr)
        sys.exit(1)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    phase("2 build")
    t0 = time.perf_counter()
    reports = _build.build()
    print(f"build seconds: {time.perf_counter() - t0:.2f}")
    for name, report in reports.items():
        print(f"{name} nvcc report:\n{report.strip()}", flush=True)

    phase("3 kernels against their plain versions")
    wg_row = check_worker_grads()
    se_row = check_sync_epoch()

    phase("4 engine on the card against the CPU")
    check_engine()

    phase("5 main path and per-step path")
    se_row["launches"] = run_main_path()
    se_row["path"] = "main"
    wg_row["launches"] = run_per_step_path()
    wg_row["path"] = f"per-step (K={PER_STEP_WORKERS}); 0 launches on the main path"
    busy_share()

    phase("6 summary")
    print(card)
    print(json.dumps({"kernels": [wg_row, se_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
