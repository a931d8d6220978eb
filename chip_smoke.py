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
   ``sync_epoch`` over one full 2,146-step epoch, and for its mean mode
   (K = 1, grad_divisor = B, the async engines' local steps) over one
   64-step Hogwild dispatch; then ``sync_epoch``'s momentum and adam modes
   (w and every state vector held to the plain version over 64 steps, at
   K = 3 and in the mean mode, and over a full epoch by its objective,
   each timed over a full epoch beside the sgd mode);
4. engines: one epoch of the sync engine, one Hogwild dispatch and a
   short local SGD fit on the card against the same on the CPU, fed the
   same sample ids; a 3-worker Hogwild fit whose replicas, less their
   inboxes, must equal its coordinator's weights; the sync engine and the
   async local steps with momentum and with adam, card against CPU;
5. sync paths: ``main()`` of the port at full width (804,414 synthetic
   RCV1-shaped rows x 47,236 features, 3 epochs), checking that the test
   loss falls, the test accuracy, and that each epoch was one
   ``sync_epoch`` launch and no step launched ``worker_grads``; the same
   with DSGD_OPTIMIZER=adam (lr 0.001); then the per-step path (8
   workers, whose state does not fit one cluster; depth cut to 100,000
   rows and 1 epoch), with sgd and with momentum (lr 0.05), checking that
   every step launched ``worker_grads``; then a 2-epoch main-path run
   under ``torch.profiler`` for the device's busy share over one epoch;
6. async paths: ``main()`` with DSGD_ASYNC=1 at full width, Hogwild with
   3 workers and 64 steps a dispatch, then local SGD with 256 steps a
   round, each checking one ``sync_epoch`` launch per dispatch or round,
   no ``worker_grads`` launch, a falling smoothed test loss, the test
   accuracy of the returned best weights, and that no worker thread is
   left; the same two with momentum (Hogwild, lr 0.05) and adam (local
   SGD, lr 0.001); Hogwild at the reference's one step a dispatch (depth
   cut to 50,000 rows); one local SGD round and one evaluation timed at
   the default period of 16 steps; and a Hogwild run under
   ``torch.profiler`` (depth cut to 200,000 rows) for the device's busy
   share;
7. checkpoints, resume and the profile, at full width in a temporary
   directory: a sync fit of 1 epoch resumed to 3 by a new trainer on a new
   Checkpointer (2 ``sync_epoch`` launches) against 3 epochs run through,
   with sgd and with adam (lr 0.001), the run through repeated until one
   matches (an adam fit lands at one of two places), and adam resumed with
   its optimizer state zeroed, which must not match; the resume with nothing left to
   run (0 launches); Hogwild and local SGD through ``main()`` with
   DSGD_CHECKPOINT_DIR, a fit and then a second one on the same directory
   (the restored best weights, the update counter, a resume past the
   budget with 0 launches, no worker thread left); a 2-epoch main-path run
   of ``python -m distributed_sgd_tpu_torch`` with DSGD_PROFILE_DIR, in a
   process of its own, whose trace holds one ``sync_epoch`` kernel; and
   the host times of a save and a restore, and of Hogwild with and without
   a checkpointer;
8. summary: the card line, one JSON line of per-kernel numbers, and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager

import numpy as np
import torch

from distributed_sgd_tpu_torch import main as port_main
from distributed_sgd_tpu_torch.checkpoint import Checkpointer, sync_fit_extra
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.early_stopping import no_improvement
from distributed_sgd_tpu_torch.core.loss_check import LossChecker
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer, profile_trace_path
from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity, train_test_split
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import sync_epoch as se
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.parallel import hogwild as hw
from distributed_sgd_tpu_torch.parallel import sync as psync
from distributed_sgd_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distributed_sgd_tpu_torch.parallel.sync import (
    MeanSteps,
    ShardedData,
    SyncEngine,
    steps_per_epoch_for,
)
from distributed_sgd_tpu_torch.utils.metrics import Metrics, global_metrics

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
# the main path's test losses and accuracies after each of its 3 epochs, as
# the per-step path and the sync_epoch kernel both gave them (H100 80GB
# HBM3, 700 W): grad_divisor 1 must keep them to 7 digits
MAIN_PATH_LOSS_ACC = [[0.4378645, 0.4081789, 0.4020025], [0.7868265, 0.8038015, 0.8080468]]
TPU_KERNEL = "distributed_sgd_tpu/ops/pallas_sparse.py:155"  # worker_grads, pl.pallas_call at :178
HOGWILD_K = 64  # DSGD_STEPS_PER_DISPATCH of the full-width Hogwild run
HOGWILD_K1_ROWS = 50000  # the one-step-a-dispatch run: 40,000 train rows, a 40,000-step budget
LOCAL_SGD_PERIOD, LOCAL_SGD_CHECK_EVERY = 256, 65536
TRACED_HOGWILD_ROWS = 200000
ASYNC_ACC_FLOOR = 0.70  # the sync phase's floor, for the async fits' best weights
# the optimizer fits' learning rates: at the CLI's 0.5, Adam's test loss
# grows in the JAX package too, and momentum 0.9 multiplies the step by 10
OPT_LR = {"momentum": 0.05, "adam": 0.001}
# local SGD with adam at lr 0.001 can peak early and then climb (seen on
# the CPU at a reduced size): its checks come every 8,192 steps so that
# the best weights are seen
ADAM_LOCAL_CHECK_EVERY = 8192
OPT_STEPS = 64  # steps of the optimizer modes' checks: enough for Adam's bias correction to move
# extra f32 operations per feature and step over sgd's update: momentum's
# trace (a mul, an add); adam's two moments (5), two bias divisions, the
# sqrt, the eps add, the division and the scaled add
OPT_EXTRA_FLOPS = {"momentum": 2, "adam": 12}


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
        "replaces": TPU_KERNEL,
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


def check_sync_epoch(train: Dataset, main_data: dict) -> dict:
    """The epoch kernel against its plain version; returns its summary row."""
    t0 = time.perf_counter()
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
        "replaces": TPU_KERNEL,
        "launches": None, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        # no single PyTorch call runs the steps of an epoch
        "library_ms": None,
    }


def check_mean_mode(train: Dataset, main_data: dict) -> dict:
    """The epoch kernel's mean mode (K = 1, grad_divisor = B) against its
    plain version; returns its summary row."""
    rng = np.random.default_rng(2)
    w_rand = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
    max_err = 0.0
    for s in (1, HOGWILD_K):
        for kind in wg.COEFF_KINDS:
            for reg in se.REG_KINDS:
                args, kw = sync_epoch_args(main_data, rng.integers(0, TRAIN_ROWS, (s, 1, B)),
                                           kind, reg, w_rand)
                kw["grad_divisor"] = B
                got = se.sync_epoch(*args, **kw)
                want = se.sync_epoch_plain(*args, **kw)
                torch.cuda.synchronize()
                err = float((got - want).abs().max())
                moved = float((want - w_rand).abs().max())
                print(f"sync_epoch mean mode S={s} kind={kind} reg={reg}: max_abs_err={err:.3e} "
                      f"weights moved {moved:.3e}", flush=True)
                if not err <= SE_ATOL:
                    raise AssertionError(f"sync_epoch mean mode S={s} kind={kind} reg={reg} "
                                         f"disagrees with its plain version (max abs err {err}, "
                                         f"atol {SE_ATOL})")
                max_err = max(max_err, err)

    # one Hogwild dispatch at the full-width run's shape: hinge, dim_sparsity,
    # 64 steps of 100 ids drawn from one worker's third of the train rows
    ids = rng.integers(0, -(-TRAIN_ROWS // 3), (HOGWILD_K, 1, B))
    args, kw = sync_epoch_args(main_data, ids, wg.HINGE, "dim_sparsity", lr=0.5)
    kw["grad_divisor"] = B
    kernel = lambda: se.sync_epoch(*args, **kw)  # noqa: E731
    plain = lambda: se.sync_epoch_plain(*args, **kw)  # noqa: E731
    plain_ms = [time_ms(plain, iters=5, warmup=1)]
    kernel_ms = [time_ms(kernel, iters=50, warmup=5), time_ms(kernel, iters=50, warmup=5)]
    plain_ms.append(time_ms(plain, iters=5, warmup=1))
    row_nnz = (train.values != 0).sum(axis=1)
    bytes_moved = len(np.unique(ids)) * (8 * P + 4) + ids.nbytes + 3 * 4 * D
    # per sampled row: the margin and the scatter, a mul and an add per
    # nonzero; per step and feature: the mean, the masked regularizer add,
    # the sum, the mean over workers, the update and the w . dim_sparsity
    # partial
    flops = 4 * int(row_nnz[ids].sum()) + HOGWILD_K * D * (3 + 5)
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOPS * 1e3
    row = {
        "kernel": "sync_epoch mean mode", "max_abs_err": max_err, "steps": HOGWILD_K,
        "kernel_ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "kernel_ms_runs": kernel_ms, "plain_ms_runs": plain_ms,
        "bytes": bytes_moved, "flops": flops,
    }
    print(json.dumps(row), flush=True)
    return {
        "name": "sync_epoch (mean mode)", "route": "cuda",
        "source": "distributed_sgd_tpu_torch/csrc/sync_epoch.cu",
        "replaces": TPU_KERNEL,
        "launches": None, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        # no single PyTorch call runs the steps of a dispatch
        "library_ms": None,
    }


def random_state(opt: se.Optimizer, rng, count: int) -> se.OptState:
    """A state as training leaves it: a signed trace or mu, and adam's nu
    no smaller than 10 mu^2 (a step then moves an entry by under lr)."""
    vecs = [rng.normal(size=D).astype(np.float32) * 0.01 for _ in range(opt.n_state)]
    if opt.kind == "adam":
        vecs[1] = 10 * vecs[0] ** 2 + vecs[1] ** 2
    return se.OptState(tuple(torch.from_numpy(v).cuda() for v in vecs), count)


def hold_opt_launch(label: str, args, kw, state) -> float:
    """One launch in an optimizer mode against its plain version: w and
    every state vector within SE_ATOL, the inputs untouched.  Returns the
    largest difference."""
    w_in, st_in = args[0].clone(), [v.clone() for v in state.vectors]
    got_w, got = se.sync_epoch(*args, **kw, opt_state=state)
    want_w, want = se.sync_epoch_plain(*args, **kw, opt_state=state)
    torch.cuda.synchronize()
    errs = [float((got_w - want_w).abs().max())] + [
        float((a - b).abs().max()) for a, b in zip(got.vectors, want.vectors)]
    moved = float((want_w - w_in).abs().max())
    print(f"sync_epoch {label}: max_abs_err w={errs[0]:.3e} state={errs[1:]} "
          f"weights moved {moved:.3e} count {got.count}", flush=True)
    if not (torch.equal(args[0], w_in) and all(map(torch.equal, state.vectors, st_in))):
        raise AssertionError(f"sync_epoch {label} wrote its input weights or state")
    if got.count != want.count or not max(errs) <= SE_ATOL:
        raise AssertionError(f"sync_epoch {label} disagrees with its plain version "
                             f"(max abs errs {errs}, atol {SE_ATOL}; counts {got.count}, "
                             f"{want.count})")
    return max(errs)


def check_opt_modes(train: Dataset, main_data: dict, se_row: dict) -> list:
    """The momentum and adam modes against the plain version: at the main
    shape (K = 3) and in the mean mode (K = 1, grad_divisor = B) over 64
    steps, from a zero and from a trained-looking state, w and every state
    vector to SE_ATOL; a full epoch by its objective, timed in turns beside
    the sgd mode.  Returns the two modes' summary rows."""
    rng = np.random.default_rng(5)
    w_rand = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
    sub = -(-TRAIN_ROWS // K)
    epoch_ids = (rng.integers(0, sub, (STEPS, K, B))
                 % np.minimum(sub, TRAIN_ROWS - np.arange(K) * sub)[:, None]
                 + (np.arange(K) * sub)[:, None])
    row_nnz = (train.values != 0).sum(axis=1)
    rows = []
    for kind in ("momentum", "adam"):
        opt = se.Optimizer(kind)
        lr = OPT_LR[kind]
        max_err = 0.0
        for reg in se.REG_KINDS:
            for k, div in ((K, 1), (1, B)):
                ids = rng.integers(0, TRAIN_ROWS, (OPT_STEPS, k, B))
                mode = f"{kind} K={k}" + (" mean mode" if div != 1 else "")
                for w0, state, start in (
                        (None, se.init_opt_state(opt, D, "cuda"), "zero state"),
                        (w_rand, random_state(opt, rng, 100), "a random state, count 100")):
                    args, kw = sync_epoch_args(main_data, ids, wg.HINGE, reg, w0, lr=lr)
                    kw.update(optimizer=opt, grad_divisor=div)
                    max_err = max(max_err, hold_opt_launch(
                        f"{mode} reg={reg} from {start}", args, kw, state))

        # a full epoch at the main path's shape (hinge, dim_sparsity, K=3):
        # timed in turns with the sgd mode's kernel beside it; held by its
        # objective, as the sgd mode's full epoch is
        args, kw = sync_epoch_args(main_data, epoch_ids, wg.HINGE, "dim_sparsity", lr=lr)
        kw["optimizer"] = opt
        state = se.init_opt_state(opt, D, "cuda")
        sgd_kw = dict(kw, optimizer=None, lr=0.5)
        kernel = lambda: se.sync_epoch(*args, **kw, opt_state=state)  # noqa: E731
        plain = lambda: se.sync_epoch_plain(*args, **kw, opt_state=state)  # noqa: E731
        sgd = lambda: se.sync_epoch(*args, **sgd_kw)  # noqa: E731
        kernel()
        sgd()
        plain_ms = [time_ms(plain, iters=1, warmup=0)]
        kernel_ms = [time_ms(kernel, iters=1, warmup=0), time_ms(kernel, iters=1, warmup=0)]
        sgd_ms = time_ms(sgd, iters=1, warmup=0)
        plain_ms.append(time_ms(plain, iters=1, warmup=0))
        (w_k, st_k), (w_p, st_p) = kernel(), plain()
        torch.cuda.synchronize()
        obj_k, obj_p = (hinge_objective(w, main_data, 100000) for w in (w_k, w_p))
        errs = [float((w_k - w_p).abs().max())] + [
            float((a - b).abs().max()) for a, b in zip(st_k.vectors, st_p.vectors)]
        print(f"sync_epoch {kind} full epoch: kernel {min(kernel_ms):.4f} ms (runs {kernel_ms}), "
              f"plain {min(plain_ms):.4f} ms (runs {plain_ms}), the sgd mode's kernel in the "
              f"same turns {sgd_ms:.4f} ms; kernel vs plain max_abs_err w and state {errs}; "
              f"hinge objective on 100,000 rows kernel {obj_k:.7f} plain {obj_p:.7f}", flush=True)
        if st_k.count != (STEPS if kind == "adam" else 0) or abs(obj_k - obj_p) > 1e-3 * abs(obj_p):
            raise AssertionError(f"the {kind} full-epoch objective of the kernel and plain "
                                 f"version differ, or its count is wrong ({st_k.count})")

        # the bound: the sgd mode's bytes and operations, plus each state
        # vector read once and written once (and adam's [S, 2] bias table),
        # plus the update's extra operations per feature and step
        bytes_moved = (len(np.unique(epoch_ids)) * (8 * P + 4) + epoch_ids.nbytes + 3 * 4 * D
                       + 2 * opt.n_state * 4 * D + (8 * STEPS if kind == "adam" else 0))
        flops = (4 * int(row_nnz[epoch_ids].sum())
                 + STEPS * D * (2 * K + 5 + OPT_EXTRA_FLOPS[kind]))
        bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = flops / F32_FLOPS * 1e3
        print(json.dumps({
            "kernel": f"sync_epoch {kind}", "max_abs_err": max_err, "steps": STEPS,
            "kernel_ms": min(kernel_ms), "plain_ms": min(plain_ms), "sgd_kernel_ms": sgd_ms,
            "sgd_row_ms": se_row["ms"], "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "kernel_ms_runs": kernel_ms, "plain_ms_runs": plain_ms, "bytes": bytes_moved,
            "flops": flops, "full_epoch_errs": errs}), flush=True)
        rows.append({
            "name": f"sync_epoch ({kind})", "route": "cuda",
            "source": "distributed_sgd_tpu_torch/csrc/sync_epoch.cu",
            "replaces": TPU_KERNEL,
            "launches": None, "max_abs_err": max_err,
            "ms": min(kernel_ms), "plain_ms": min(plain_ms),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            # no single PyTorch call runs the steps of an epoch
            "library_ms": None,
        })

        # one 64-step Hogwild dispatch in the mean mode, timed as
        # check_mean_mode times the sgd mode's
        ids = rng.integers(0, sub, (HOGWILD_K, 1, B))
        args, kw = sync_epoch_args(main_data, ids, wg.HINGE, "dim_sparsity", lr=lr)
        kw.update(optimizer=opt, grad_divisor=B)
        state = se.init_opt_state(opt, D, "cuda")
        mean_ms = time_ms(lambda: se.sync_epoch(*args, **kw, opt_state=state), iters=50,
                          warmup=5)
        print(f"sync_epoch {kind} mean mode: {mean_ms:.4f} ms a {HOGWILD_K}-step dispatch",
              flush=True)
    return rows


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


def check_opt_engines() -> None:
    """The sync engine (two epochs, K=3) and the async local steps
    (MeanSteps, 16 steps) with momentum and with adam, on the card against
    the CPU, fed the same ids: weights and every state vector to 1e-5."""
    data = rcv1_like(3000, n_features=2000, nnz=20, seed=7, idf_values=True)
    ds = dim_sparsity(data)
    mean_ids = torch.from_numpy(np.random.default_rng(4).integers(0, 3000, (16, 1, 50)))
    for kind in ("momentum", "adam"):
        out, counts = {}, {}
        for dev in ("cuda", "cpu"):
            model = make_model("hinge", 1e-4, 2000, dim_sparsity=ds, device=dev)
            bound = SyncEngine(model, batch_size=50, learning_rate=OPT_LR[kind],
                               virtual_workers=3, optimizer=kind, device=dev).bind(
                Dataset(data.indices, data.values, data.labels, data.n_features))
            if dev == "cuda" and not bound.epoch_kernel:
                raise AssertionError(f"the {kind} engine at K=3, D=2000 did not pick sync_epoch")
            sub, starts, sizes = bound._subshards()
            sel = np.random.default_rng(0).integers(0, sub, (bound.steps_per_epoch, 3, 50))
            ids = torch.from_numpy(sel % np.minimum(sub, sizes)[:, None] + starts[:, None])
            bound._sample_ids = lambda key, ids=ids, dev=dev: ids.to(dev)
            w = bound.epoch(bound.epoch(torch.zeros(2000, device=dev), 0), 1)
            d = bound.data
            steps = MeanSteps(model, d.indices, d.values, d.labels, OPT_LR[kind],
                              se.Optimizer(kind))
            if dev == "cuda" and not steps.fused:
                raise AssertionError(f"the {kind} async steps at D=2000 did not pick sync_epoch")
            mw, mstate = steps.run(torch.full((2000,), 0.01, device=dev), mean_ids.to(dev))
            out[dev] = [x.cpu() for x in (w, *bound._opt_state.vectors, mw, *mstate.vectors)]
            counts[dev] = (bound._opt_state.count, mstate.count)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(out["cuda"], out["cpu"])]
        print(f"{kind} engines, card vs CPU: sync engine 2 epochs and MeanSteps 16 steps, "
              f"max_abs_err (w, state..., mean w, mean state...) {errs}; counts "
              f"{counts['cuda']} vs {counts['cpu']}", flush=True)
        if max(errs) > 1e-5 or counts["cuda"] != counts["cpu"]:
            raise AssertionError(f"the {kind} engines on the card disagree with the CPU run")


def check_async_engines() -> None:
    """One Hogwild dispatch and a short local SGD fit on the card against
    the same on the CPU, fed the same ids; then a Hogwild fit's replicas
    against its coordinator."""
    data = rcv1_like(3000, n_features=2000, nnz=20, seed=6, idf_values=True)
    train, test = train_test_split(data)
    ds = dim_sparsity(train)
    rng = np.random.default_rng(3)
    dispatch_ids = torch.from_numpy(rng.integers(0, 800, (16, 1, 50)))
    rounds = [torch.from_numpy(rng.integers(0, len(train), (8, 1, 50)))
              for _ in range(-(-len(train) // 8))]
    out = {}
    for dev in ("cuda", "cpu"):
        model = make_model("hinge", 1e-4, 2000, dim_sparsity=ds, device=dev)
        shard = ShardedData(*(torch.from_numpy(a[:800]).to(dev) for a in (
            train.indices, train.values, train.labels.astype(np.float32))), n_true=800)
        worker = hw._Worker(0, model, shard, 50, 0.5, 0, Metrics(), steps_per_dispatch=16)
        if dev == "cuda" and not worker._steps.fused:
            raise AssertionError("the async steps at D=2000 did not pick the sync_epoch kernel")
        delta = worker._step(torch.full((2000,), 0.01, device=dev), dispatch_ids.to(dev))
        eng = LocalSGDEngine(model, 50, 0.5, sync_period=8, check_every=400,
                             metrics=Metrics(), device=dev)
        eng._sample_ids = lambda rnd, shard_n, dev=dev: rounds[rnd].to(dev)
        res = eng.fit(train, test, 1)
        out[dev] = (delta.cpu(), res)
    torch.cuda.synchronize()
    (d_gpu, r_gpu), (d_cpu, r_cpu) = out["cuda"], out["cpu"]
    d_err = float((d_gpu - d_cpu).abs().max())
    w_err = float((r_gpu.weights.cpu() - r_cpu.weights).abs().max())
    print(f"async engines: Hogwild dispatch delta max_abs_err={d_err:.3e}; local SGD best "
          f"weights max_abs_err={w_err:.3e}, smoothed test losses gpu={r_gpu.test_losses} "
          f"cpu={r_cpu.test_losses}", flush=True)
    # atol 1e-5 on weights and deltas (atomics reorder f32 sums), rtol 1e-5 on losses
    if (d_err > 1e-5 or w_err > 1e-5
            or not np.allclose(r_gpu.test_losses, r_cpu.test_losses, rtol=1e-5, atol=0)):
        raise AssertionError("async engines on the card disagree with the CPU run")

    # a 3-worker Hogwild fit, each worker on its own stream: every delta
    # reaches every peer and the coordinator, so each replica less the
    # deltas still in its inbox is the coordinator's weights up to the
    # order of the f32 sums, unless a stream race corrupted a copy
    workers, real_worker = [], hw._Worker
    hw._Worker = lambda *a, **kw: workers.append(real_worker(*a, **kw)) or workers[-1]
    try:
        eng = hw.HogwildEngine(make_model("hinge", 1e-4, 2000, dim_sparsity=ds, device="cuda"),
                               3, 50, 0.5, check_every=400, backoff_s=0.01,
                               steps_per_dispatch=8, metrics=Metrics(), device="cuda")
        eng.fit(train, test, 4)
    finally:
        hw._Worker = real_worker
    master = eng._w_master.cpu()
    gap = max(float((w.w.cpu() - torch.from_numpy(sum(w.inbox.queue, np.zeros(2000, np.float32)))
                     - master).abs().max()) for w in workers)
    print(f"Hogwild on the card: {eng._updates} updates; largest gap between a replica (less "
          f"its inbox) and the coordinator's weights {gap:.3e}, weights up to "
          f"{float(master.abs().max()):.3e}", flush=True)
    if not gap <= 1e-5:
        raise AssertionError(f"a Hogwild replica and the coordinator differ by {gap}")


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
    se.sync_epoch.opt_launches = dict.fromkeys(se.OPT_KINDS, 0)


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
    got = np.array([fit.test_losses, fit.test_accuracies])
    if not np.allclose(got, MAIN_PATH_LOSS_ACC, rtol=0, atol=1e-6):
        raise AssertionError(f"test losses and accuracies {got.tolist()} differ from the "
                             f"main path's {MAIN_PATH_LOSS_ACC} in the 7th digit")
    if (launches, steps_run, wg_launches) != (MAIN_EPOCHS, MAIN_EPOCHS * steps, 0):
        raise AssertionError(
            f"sync_epoch launched {launches} times over {steps_run} steps and worker_grads "
            f"{wg_launches} times; want {MAIN_EPOCHS}, {MAIN_EPOCHS * steps} and 0")
    return launches


def run_main_path_optimizer(kind: str) -> int:
    """The CLI at full width with DSGD_OPTIMIZER=`kind`: 3 epochs, each one
    sync_epoch launch in that mode, no worker_grads; the test loss falls
    every epoch from 1.0 (its value at w = 0), and the test accuracy is
    >= 0.70.  Returns the launches."""
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS, DSGD_MAX_EPOCHS=MAIN_EPOCHS, DSGD_OPTIMIZER=kind,
                 DSGD_LEARNING_RATE=OPT_LR[kind]):
        reset_counts()
        t0 = time.perf_counter()
        run = port_main.main()
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches, steps_run = se.sync_epoch.launches, se.sync_epoch.steps
        mode_launches, wg_launches = se.sync_epoch.opt_launches[kind], wg.worker_grads.launches
    fit = run.fit
    print(f"main path, {kind} (lr {OPT_LR[kind]}): epoch seconds {fit.epoch_seconds}; "
          f"{total_s:.3f} s in all; test losses {fit.test_losses} accuracies "
          f"{fit.test_accuracies}; sync_epoch launches {launches} ({kind} {mode_launches}) "
          f"over {steps_run} steps; worker_grads launches {wg_launches}", flush=True)
    w = fit.weights
    if w.shape != (D,) or not bool(torch.isfinite(w).all()):
        raise AssertionError(f"{kind}: final weights not finite f32[{D}]: {w.shape}")
    losses = [1.0] + fit.test_losses
    if fit.epochs_run != MAIN_EPOCHS or not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError(f"{kind}: the test loss did not fall below 1.0 every epoch for "
                             f"{MAIN_EPOCHS} epochs: {fit.test_losses}")
    if fit.test_accuracies[-1] < 0.70:
        raise AssertionError(f"{kind}: test accuracy {fit.test_accuracies[-1]} < 0.70")
    want = (MAIN_EPOCHS, MAIN_EPOCHS, MAIN_EPOCHS * STEPS, 0)
    if (launches, mode_launches, steps_run, wg_launches) != want:
        raise AssertionError(
            f"{kind}: sync_epoch launched {launches} times ({mode_launches} in its mode) over "
            f"{steps_run} steps and worker_grads {wg_launches} times; want {want}")
    return launches


def run_per_step_path(optimizer: str = "sgd") -> int:
    """The CLI with 8 workers, whose state does not fit one cluster: every
    step launches worker_grads, and the optimizer runs in torch after it.
    Returns those launches."""
    if se.cluster_plan(PER_STEP_WORKERS, D) is not None:
        raise AssertionError(f"K={PER_STEP_WORKERS} at D={D} fits a cluster")
    env = {} if optimizer == "sgd" else {"DSGD_OPTIMIZER": optimizer,
                                         "DSGD_LEARNING_RATE": OPT_LR[optimizer]}
    with cli_env(DSGD_SYNTHETIC=PER_STEP_ROWS, DSGD_MAX_EPOCHS=1,
                 DSGD_NODE_COUNT=PER_STEP_WORKERS, **env):
        reset_counts()
        run = port_main.main()
        torch.cuda.synchronize()
        launches, se_launches = wg.worker_grads.launches, se.sync_epoch.launches
    fit = run.fit
    steps = steps_per_epoch_for(int(PER_STEP_ROWS * 0.8), 1, PER_STEP_WORKERS, 100)
    print(f"per-step path, {optimizer}: epoch seconds {fit.epoch_seconds[0]:.4f} "
          f"steps/s {fit.steps_per_epoch / fit.epoch_seconds[0]:.1f}; test loss "
          f"{fit.test_losses[0]:.6f} accuracy {fit.test_accuracies[0]:.4f}; worker_grads "
          f"launches {launches}, sync_epoch launches {se_launches}", flush=True)
    if (launches, se_launches) != (steps, 0) or fit.test_losses[0] >= 1.0:
        raise AssertionError(f"per-step path: worker_grads launched {launches} times and "
                             f"sync_epoch {se_launches}; want {steps} and 0, and a "
                             f"test loss below 1 (got {fit.test_losses[0]})")
    return launches


def device_events(fn) -> list:
    """(start us, end us, name) of every device event, sorted, while `fn`
    runs under torch.profiler."""
    with tempfile.TemporaryDirectory() as tmp:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            fn()
            torch.cuda.synchronize()
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e.get("name", ""))
                  for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))


def union_us(events, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] covered by at least one of the sorted events."""
    busy, end = 0.0, lo
    for t0, t1, _ in events:
        t0, t1 = max(t0, lo), min(t1, hi)
        if t1 > t0:
            busy += max(0.0, t1 - max(t0, end))
            end = max(end, t1)
    return busy


def busy_share() -> None:
    """Two main-path epochs under torch.profiler; prints the device's busy
    share from one sync_epoch launch to the next: one epoch's training,
    its train and test evaluation and the next epoch's id draw."""
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS, DSGD_MAX_EPOCHS=2):
        dev = device_events(port_main.main)
    starts = sorted(t0 for t0, _, name in dev if "sync_epoch" in name)
    if len(starts) < 2:
        print(f"device busy share: not measured (the trace holds {len(dev)} device "
              f"events and {len(starts)} sync_epoch kernels)", flush=True)
        return
    lo, hi = starts[0], starts[1]
    busy = union_us(dev, lo, hi)
    kernel_us = sum(max(0.0, min(t1, hi) - max(t0, lo))
                    for t0, t1, name in dev if "sync_epoch" in name)
    print(f"device busy share over one epoch ({hi - lo:.1f} us from one sync_epoch launch "
          f"to the next): {busy / (hi - lo):.4f}; sync_epoch kernel {kernel_us:.1f} us, "
          f"other device work {busy - kernel_us:.1f} us, idle {hi - lo - busy:.1f} us",
          flush=True)


def async_counts() -> dict:
    m = global_metrics()
    return {"batch": m.counter("slave.async.batch").value,
            "merged": m.counter("slave.async.grad.update").value,
            "dropped": m.counter("slave.async.grad.dropped").value,
            "rounds": m.histogram("slave.async.round.seconds").count}


def live_worker_threads() -> list:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("hogwild-") and t.is_alive()]


def run_async_path(label: str, rows: int, per_launch: int, evaluate=None, **env) -> dict:
    """``main()`` with DSGD_ASYNC=1, one epoch's budget and `env`.  Checks
    one sync_epoch launch of `per_launch` steps, in the optimizer's mode,
    per Hogwild dispatch or local SGD round and no worker_grads launch,
    that the smoothed test loss fell below 1.0 (its value at w = 0), that
    no worker thread is left, and with `evaluate` the test accuracy of the
    returned best weights.  Returns the run's numbers."""
    with cli_env(DSGD_SYNTHETIC=rows, DSGD_ASYNC=1, DSGD_MAX_EPOCHS=1, **env):
        before = async_counts()
        reset_counts()
        run = port_main.main()
        torch.cuda.synchronize()
        launches, steps_run = se.sync_epoch.launches, se.sync_epoch.steps
        mode_launches = se.sync_epoch.opt_launches[env.get("DSGD_OPTIMIZER", "sgd")]
        wg_launches = wg.worker_grads.launches
    diff = {k: v - before[k] for k, v in async_counts().items()}
    fit = run.fit
    fit_s = fit.state.duration
    hogwild = env.get("DSGD_ASYNC_MODE", "gossip") == "gossip"
    units = diff["batch"] // per_launch if hogwild else diff["rounds"]
    unit = "dispatches" if hogwild else "rounds"
    stop = "budget" if fit.state.updates >= int(rows * 0.8) else "early stop"
    losses = fit.test_losses
    out = {"updates": fit.state.updates, "fit_s": fit_s, unit: units, "launches": launches,
           "steps": steps_run, "worker_grads_launches": wg_launches, "merged": diff["merged"],
           "dropped": diff["dropped"], "stop": stop, "checks": len(losses),
           "best_smoothed_loss": fit.state.loss, "data_s": run.data_seconds}
    print(f"{label}: {fit.state.updates} updates in {fit_s:.3f} s "
          f"({fit.state.updates / fit_s:.1f} updates/s); {units} {unit} "
          f"({units / fit_s:.1f}/s); sync_epoch launches {launches} over {steps_run} steps; "
          f"worker_grads launches {wg_launches}; peer deltas merged {diff['merged']}, "
          f"dropped {diff['dropped']}; stopped by {stop}; data seconds {run.data_seconds:.3f}",
          flush=True)
    print(f"{label} smoothed test losses ({len(losses)} checks): first {losses[:3]} last "
          f"{losses[-3:]} best {fit.state.loss}; smoothed accuracies last "
          f"{fit.test_accuracies[-3:]}", flush=True)
    w = fit.weights
    if w.shape != (D,) or not bool(torch.isfinite(w).all()):
        raise AssertionError(f"{label}: best weights not finite f32[{D}]: {w.shape}")
    if units < 1 or (launches, mode_launches, steps_run, wg_launches) != (
            units, units, units * per_launch, 0):
        raise AssertionError(
            f"{label}: sync_epoch launched {launches} times ({mode_launches} in the "
            f"optimizer's mode) over {steps_run} steps and worker_grads {wg_launches} times; "
            f"want {units}, {units}, {units * per_launch} and 0")
    if hogwild and fit.state.updates != diff["batch"]:
        raise AssertionError(f"{label}: the coordinator counted {fit.state.updates} updates, "
                             f"the workers ran {diff['batch']} steps")
    if not min(losses) < 1.0:
        raise AssertionError(f"{label}: the smoothed test loss never fell below 1.0: {losses}")
    if live_worker_threads():
        raise AssertionError(f"{label}: worker threads left: {live_worker_threads()}")
    if evaluate is not None:
        loss, acc = evaluate(w)
        out.update(best_test_loss=loss, best_test_acc=acc)
        print(f"{label} best weights: raw test loss {loss:.7f} accuracy {acc:.7f}", flush=True)
        if acc < ASYNC_ACC_FLOOR:
            raise AssertionError(f"{label}: best weights reach test accuracy {acc}, "
                                 f"want >= {ASYNC_ACC_FLOOR}")
    return out


def time_local_sgd_defaults(model, train_bound, test_bound) -> None:
    """One local SGD round (the id draw and one launch) and one test
    evaluation at the default sync_period 16 and check_every 100, and the
    share of the fit the evaluation would take there."""
    eng = LocalSGDEngine(model, B, 0.5, device="cuda")
    d = train_bound.data
    steps = MeanSteps(model, d.indices, d.values, d.labels, 0.5)
    w = torch.zeros(D, device="cuda")
    round_s = []
    for r in range(40):
        t0 = time.perf_counter()
        w, _ = steps.run(w, eng._sample_ids(r, train_bound.shard_n))
        torch.cuda.synchronize()
        round_s.append(time.perf_counter() - t0)
    eval_s = []
    for _ in range(7):
        t0 = time.perf_counter()
        test_bound.evaluate(w)
        eval_s.append(time.perf_counter() - t0)
    rounds_per_check = -(-eng.check_every // eng.sync_period)
    r_s, e_s = statistics.median(round_s[5:]), statistics.median(eval_s[1:])
    print(f"local SGD at its defaults: one round of {eng.sync_period} steps {r_s * 1e3:.4f} ms "
          f"(median of 35), one test evaluation {e_s * 1e3:.4f} ms (median of 6); a check "
          f"every {rounds_per_check} rounds, so the evaluation would take "
          f"{e_s / (e_s + rounds_per_check * r_s):.4f} of the fit", flush=True)


def async_busy_share() -> None:
    """A Hogwild run (64 steps a dispatch, 3 workers) under torch.profiler;
    prints the device's busy share from the first sync_epoch launch to the
    end of the last, and how many clusters ran at once on average."""
    with cli_env(DSGD_SYNTHETIC=TRACED_HOGWILD_ROWS, DSGD_ASYNC=1, DSGD_MAX_EPOCHS=1,
                 DSGD_STEPS_PER_DISPATCH=HOGWILD_K):
        dev = device_events(port_main.main)
    kernels = [e for e in dev if "sync_epoch" in e[2]]
    if len(kernels) < 2:
        print(f"Hogwild device busy share: not measured (the trace holds {len(dev)} device "
              f"events and {len(kernels)} sync_epoch kernels)", flush=True)
        return
    lo, hi = kernels[0][0], max(t1 for _, t1, _ in kernels)
    span = hi - lo
    print(f"Hogwild device busy share ({TRACED_HOGWILD_ROWS} rows, {span:.1f} us from the "
          f"first sync_epoch launch to the end of the last): {union_us(dev, lo, hi) / span:.4f}; "
          f"sync_epoch kernels cover {union_us(kernels, lo, hi) / span:.4f}, "
          f"{len(kernels)} of them, {sum(t1 - t0 for t0, t1, _ in kernels) / span:.4f} "
          f"clusters at once on average", flush=True)


def run_async_paths(mean_row: dict, opt_rows: dict) -> None:
    t0 = time.perf_counter()
    full = rcv1_like(MAIN_ROWS, seed=0, idf_values=True)
    train, test = train_test_split(full)
    model = make_model("hinge", LAM, D, dim_sparsity=dim_sparsity(train), device="cuda")
    test_bound = SyncEngine(model, B, 0.0).bind(test)
    print(f"async evaluation data seconds: {time.perf_counter() - t0:.2f}", flush=True)

    hog = run_async_path("Hogwild", MAIN_ROWS, HOGWILD_K, evaluate=test_bound.evaluate,
                         DSGD_STEPS_PER_DISPATCH=HOGWILD_K)
    hog1 = run_async_path("Hogwild k=1", HOGWILD_K1_ROWS, 1)
    local = run_async_path("local SGD", MAIN_ROWS, LOCAL_SGD_PERIOD,
                           evaluate=test_bound.evaluate, DSGD_ASYNC_MODE="local_sgd",
                           DSGD_SYNC_PERIOD=LOCAL_SGD_PERIOD,
                           DSGD_CHECK_EVERY=LOCAL_SGD_CHECK_EVERY)
    hog_m = run_async_path("Hogwild momentum", MAIN_ROWS, HOGWILD_K, evaluate=test_bound.evaluate,
                           DSGD_STEPS_PER_DISPATCH=HOGWILD_K, DSGD_OPTIMIZER="momentum",
                           DSGD_LEARNING_RATE=OPT_LR["momentum"])
    local_a = run_async_path("local SGD adam", MAIN_ROWS, LOCAL_SGD_PERIOD,
                             evaluate=test_bound.evaluate, DSGD_ASYNC_MODE="local_sgd",
                             DSGD_SYNC_PERIOD=LOCAL_SGD_PERIOD,
                             DSGD_CHECK_EVERY=ADAM_LOCAL_CHECK_EVERY, DSGD_OPTIMIZER="adam",
                             DSGD_LEARNING_RATE=OPT_LR["adam"])
    print(json.dumps({"hogwild": hog, "hogwild_k1": hog1, "local_sgd": local,
                      "hogwild_momentum": hog_m, "local_sgd_adam": local_a}), flush=True)
    opt_rows["momentum"]["launches"] = hog_m["launches"]
    opt_rows["momentum"]["path"] = (f"async: Hogwild momentum (k={HOGWILD_K}, one launch a "
                                    f"dispatch); the per-step path (K={PER_STEP_WORKERS}) runs "
                                    f"momentum in torch after worker_grads")
    opt_rows["adam"]["path"] = (f"main path with DSGD_OPTIMIZER=adam (one launch an epoch); "
                                f"local SGD adam (one launch a round) {local_a['launches']}")
    mean_row["launches"] = hog["launches"]
    mean_row["path"] = (f"async: Hogwild (k={HOGWILD_K}, one launch a dispatch); local SGD "
                        f"(one launch a round) {local['launches']}; Hogwild k=1 "
                        f"({HOGWILD_K1_ROWS} rows) {hog1['launches']}")
    time_local_sgd_defaults(model, SyncEngine(model, B, 0.5).bind(train), test_bound)
    async_busy_share()


# -- phase 7: checkpoints, resume and the profile ------------------------------

RESUME_LOSS_RTOL = 5e-6  # test losses of a resumed fit: equal to 6 significant digits
RESUME_W_ATOL = 1e-5  # its weights: atomics may reorder f32 sums between launches
# runs through a resumed fit is held against, at most: atomics reorder the
# sums, and a hinge margin within rounding of 0 can then take either side,
# so an adam fit lands at one of two places (PERF.md: 7 of 40 launches of
# one epoch apart); 20 leave 0.2 * 0.8^20 (0.2%) to chance
RUN_THROUGHS = 20


def sync_trainer(model, kind: str, **kw) -> SyncTrainer:
    """The main path's trainer (3 virtual workers, batch 100, seed 0)."""
    return SyncTrainer(model, B, OPT_LR.get(kind, 0.5), seed=0, virtual_workers=K,
                       optimizer=kind, device="cuda", **kw)


def resume_gap(resumed, full):
    """(largest relative test-loss difference, largest weight difference)
    of a fit resumed at epoch 1 against the same fit run through."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(resumed.test_losses, full.test_losses[1:]))
    return rel, float((resumed.weights - full.weights).abs().max())


def within(gap) -> bool:
    return gap[0] <= RESUME_LOSS_RTOL and gap[1] <= RESUME_W_ATOL


def check_sync_resume(train, test, model, tmp: str, kind: str) -> dict:
    """1 epoch with a checkpointer, then a new trainer on a new Checkpointer
    resumes to 3: exactly 2 sync_epoch launches in `kind`'s mode and none of
    worker_grads, and the same fit run through to the bounds (test losses
    to 6 digits, weights to RESUME_W_ATOL), the run through repeated until
    one matches, up to RUN_THROUGHS times.  For adam, a resume with the
    optimizer state zeroed must match none of them.  Returns the numbers."""
    d = os.path.join(tmp, f"sync-{kind}")
    sync_trainer(model, kind, checkpointer=Checkpointer(d)).fit(train, test, 1)
    if kind == "adam":
        shutil.copytree(d, d + "-zeroed")
    reset_counts()
    resumed = sync_trainer(model, kind, checkpointer=Checkpointer(d)).fit(train, test, MAIN_EPOCHS)
    torch.cuda.synchronize()
    launches = (se.sync_epoch.launches, se.sync_epoch.opt_launches[kind], wg.worker_grads.launches)
    print(f"sync {kind} resumed at epoch 1 to {MAIN_EPOCHS}: sync_epoch launches {launches[0]} "
          f"({kind} {launches[1]}), worker_grads {launches[2]}; test losses "
          f"{resumed.test_losses}", flush=True)
    if launches != (MAIN_EPOCHS - 1, MAIN_EPOCHS - 1, 0) or resumed.epochs_run != MAIN_EPOCHS:
        raise AssertionError(f"sync {kind} resume: launches {launches}, epochs_run "
                             f"{resumed.epochs_run}; want ({MAIN_EPOCHS - 1}, "
                             f"{MAIN_EPOCHS - 1}, 0) and {MAIN_EPOCHS}")
    fulls, gaps = [], []
    while not (gaps and within(gaps[-1])):
        if len(fulls) == RUN_THROUGHS:
            raise AssertionError(f"sync {kind} resume matches none of {RUN_THROUGHS} runs "
                                 f"through (relative test-loss and weight gaps {gaps}; rtol "
                                 f"{RESUME_LOSS_RTOL}, atol {RESUME_W_ATOL})")
        fulls.append(sync_trainer(model, kind).fit(train, test, MAIN_EPOCHS))
        gaps.append(resume_gap(resumed, fulls[-1]))
        exact = bool(torch.equal(resumed.weights, fulls[-1].weights))
        print(f"sync {kind} run through {len(fulls)}: test losses {fulls[-1].test_losses[1:]}; "
              f"against the resumed fit: largest relative difference {gaps[-1][0]:.3e}, weights "
              f"max_abs_err {gaps[-1][1]:.3e}, bitwise equal: {exact}", flush=True)
    out = {"launches": launches[0], "loss_rel": gaps[-1][0], "w_err": gaps[-1][1],
           "runs_through": len(fulls), "gaps": gaps}
    if kind == "adam":
        real = psync.BoundSync.load_opt_state_leaves
        psync.BoundSync.load_opt_state_leaves = lambda self, leaves: self.reset_optimizer()
        try:
            zeroed = sync_trainer(model, kind, checkpointer=Checkpointer(d + "-zeroed")).fit(
                train, test, MAIN_EPOCHS)
        finally:
            psync.BoundSync.load_opt_state_leaves = real
        zgaps = [resume_gap(zeroed, f) for f in fulls]
        out["zeroed_gaps"] = zgaps
        print(f"sync adam resumed with its optimizer state zeroed: test losses "
              f"{zeroed.test_losses}; against each run through (relative, weights) {zgaps}",
              flush=True)
        if any(map(within, zgaps)):
            raise AssertionError("a resume with the adam state zeroed matched a run through: "
                                 "the check cannot see a lost state")
    return out


def check_nothing_to_run(train, test, model, tmp: str) -> None:
    """A resume with max_epochs equal to the saved epoch: no launch, and the
    restored weights evaluated."""
    d = os.path.join(tmp, "sync-sgd")
    step, state = Checkpointer(d).restore_latest()
    reset_counts()
    res = sync_trainer(model, "sgd", checkpointer=Checkpointer(d)).fit(train, test, step)
    torch.cuda.synchronize()
    want, _ = SyncEngine(model, B, 0.0).bind(train).evaluate(
        torch.from_numpy(state["weights"]).cuda())
    print(f"nothing to run (checkpoint at epoch {step}, max_epochs {step}): sync_epoch launches "
          f"{se.sync_epoch.launches}, epochs_run {res.epochs_run}, loss of the restored weights "
          f"{res.state.loss:.7f} (evaluated apart {want:.7f})", flush=True)
    if (se.sync_epoch.launches, wg.worker_grads.launches, res.epochs_run) != (0, 0, step) or (
            abs(res.state.loss - want) > 1e-6 * abs(want)):
        raise AssertionError("the resume with nothing to run launched a kernel, or did not "
                             "report the restored weights' loss")


def check_async_resume(label: str, tmp: str, per_launch: int, **env) -> dict:
    """``main()`` with DSGD_ASYNC=1 and DSGD_CHECKPOINT_DIR: a fit, then a
    second one on the same directory, then one resumed past its budget."""
    d = os.path.join(tmp, label.replace(" ", "-"))
    hogwild = env.get("DSGD_ASYNC_MODE", "gossip") == "gossip"
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS, DSGD_ASYNC=1, DSGD_MAX_EPOCHS=1,
                 DSGD_CHECKPOINT_DIR=d, **env):
        first = port_main.main().fit
        step, state = Checkpointer(d).restore_latest()
        same = bool(np.array_equal(state["weights"], first.weights.cpu().numpy()))
        restored, n_hist = int(state["updates"]), len(state["smoothed_nf"])
        before = async_counts()
        reset_counts()
        second = port_main.main().fit
        torch.cuda.synchronize()
        launches, steps_run = se.sync_epoch.launches, se.sync_epoch.steps
        diff = {k: v - before[k] for k, v in async_counts().items()}
        left = live_worker_threads()
        # a snapshot at the budget, as a fit that spent it leaves one
        ck = LossChecker(0.9, checkpointer=Checkpointer(d), save_every=1, device="cuda")
        ck.check(ck.best_loss, 0.0, ck.best_weights, step=TRAIN_ROWS)
        budget_spent = ck._updates_seen  # TRAIN_ROWS, or more if the second fit passed it
        reset_counts()
        third = port_main.main().fit
        torch.cuda.synchronize()
        past = (se.sync_epoch.launches, third.state.updates,
                bool(torch.equal(third.weights, ck.best_weights)))
    new = second.test_losses[n_hist:]
    units = diff["batch"] // per_launch if hogwild else diff["rounds"]
    out = {"first_updates": first.state.updates, "restored_updates": restored,
           "second_updates": second.state.updates, "second_launches": launches,
           "second_first_loss": new[0] if new else None, "past_budget": past}
    print(f"{label} with a checkpoint directory: first fit {first.state.updates} updates, best "
          f"{first.state.loss:.7f}; latest snapshot step {step} ({restored} updates, {n_hist} "
          f"checks), its weights equal the fit's best weights: {same}; second fit from "
          f"{restored} to {second.state.updates} updates, {launches} sync_epoch launches over "
          f"{steps_run} steps, first smoothed loss {new[:1]}, best {second.state.loss:.7f}; "
          f"resumed past the budget: {past[0]} launches, {past[1]} updates, the restored best "
          f"weights returned: {past[2]}", flush=True)
    if not same:
        raise AssertionError(f"{label}: the restored best weights differ from the fit's")
    if second.test_losses[:n_hist] != [float(x) for x in state["smoothed_nf"][::-1]]:
        raise AssertionError(f"{label}: the second fit did not go on from the restored history")
    if not new or not new[0] < 1.0:
        raise AssertionError(f"{label}: the second fit's first smoothed loss is {new[:1]}")
    if (second.state.updates - restored != steps_run or launches != units
            or wg.worker_grads.launches != 0):
        raise AssertionError(f"{label}: {second.state.updates} updates from {restored} restored, "
                             f"{steps_run} steps in {launches} launches ({units} {per_launch}-step "
                             f"units); the counter must start at the restored count")
    if left or live_worker_threads():
        raise AssertionError(f"{label}: worker threads left: {left or live_worker_threads()}")
    if past != (0, budget_spent, True):
        raise AssertionError(f"{label}: a resume past the budget gave {past}; want 0 launches, "
                             f"{budget_spent} updates and the restored best weights")
    return out


def check_profile(tmp: str, train, test, model) -> dict:
    """``python -m distributed_sgd_tpu_torch`` with DSGD_PROFILE_DIR on a
    2-epoch main-path run, in a process of its own as a user runs it (in
    this process the busy-share phases' torch.profiler sessions came first,
    and a later session can lose kernel records): the trace of epoch 1
    holds exactly one sync_epoch kernel.  Its duration is printed beside
    the same two epochs run here, each timed by CUDA events (the id draw
    and the launch)."""
    d = os.path.join(tmp, "profile")
    env = {**os.environ, "DSGD_SYNTHETIC": str(MAIN_ROWS), "DSGD_MAX_EPOCHS": "2",
           "DSGD_PROFILE_DIR": d}
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    cli = subprocess.run([sys.executable, "-m", "distributed_sgd_tpu_torch"], cwd=root, env=env,
                         capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    if cli.returncode != 0:
        raise AssertionError(f"the profiled CLI run failed ({cli.returncode}):\n"
                             f"{cli.stdout[-3000:]}\n{cli.stderr[-3000:]}")
    files = sorted(os.listdir(d))
    with open(profile_trace_path(d, 1)) as f:
        trace = json.load(f)["traceEvents"]
    kernels = [e for e in trace if e.get("ph") == "X" and e.get("cat") == "kernel"
               and "sync_epoch" in e.get("name", "")]

    events, real = [], psync.BoundSync.epoch

    def timed(self, w, key):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        w = real(self, w, key)
        end.record()
        events.append((start, end))
        return w

    psync.BoundSync.epoch = timed
    try:
        sync_trainer(model, "sgd").fit(train, test, 2)
    finally:
        psync.BoundSync.epoch = real
    torch.cuda.synchronize()
    event_ms = [s.elapsed_time(e) for s, e in events]
    out = {"files": files, "sync_epoch_kernels": len(kernels),
           "kernel_ms": float(kernels[0]["dur"]) / 1e3 if kernels else None,
           "epoch_event_ms": event_ms, "trace_events": len(trace), "cli_seconds": cli_s}
    print(f"profile: {files} in DSGD_PROFILE_DIR after a {cli_s:.1f} s CLI run, {len(trace)} "
          f"events, {len(kernels)} sync_epoch kernel(s) of {out['kernel_ms']} ms; the same epoch "
          f"here by CUDA events {event_ms[1]:.4f} ms (the id draw and the launch; epoch 0 "
          f"{event_ms[0]:.4f} ms)", flush=True)
    if files != [os.path.basename(profile_trace_path(d, 1))] or len(kernels) != 1:
        raise AssertionError(f"profile: files {files}, {len(kernels)} sync_epoch kernels; want "
                             f"the epoch-1 trace with exactly one")
    return out


def time_checkpoints(tmp: str) -> dict:
    """Host milliseconds of a save (the device-to-host copy included) and of
    restore_latest at D = 47,236: a sync sgd snapshot, an adam one and a
    LossChecker one (median of 15, after 3 unrecorded)."""
    rng = np.random.default_rng(11)
    w = torch.from_numpy(rng.normal(size=D).astype(np.float32)).cuda()
    adam = [torch.tensor(4292, dtype=torch.int32).cuda(),
            *(torch.from_numpy(rng.random(D).astype(np.float32)).cuda() for _ in range(2))]
    hist = list(rng.random(12).astype(np.float32))
    snapshots = {
        "sync sgd": sync_fit_extra(hist[:3], "sgd", []),
        "sync adam": sync_fit_extra(hist[:3], "adam", adam),
        "LossChecker": {"best_loss": 0.2646753, "smoothed_nf": np.asarray(hist, np.float32),
                        "smoothed_accs_nf": np.asarray(hist, np.float32), "updates": 207552},
    }
    out = {}
    for label, extra in snapshots.items():
        ck = Checkpointer(os.path.join(tmp, "timing-" + label.replace(" ", "-")))
        save_ms, restore_ms = [], []
        for step in range(18):
            t0 = time.perf_counter()
            ck.save(step, w, extra=extra)
            t1 = time.perf_counter()
            ck.restore_latest()
            t2 = time.perf_counter()
            if step >= 3:
                save_ms.append((t1 - t0) * 1e3)
                restore_ms.append((t2 - t1) * 1e3)
        size = os.path.getsize(os.path.join(ck.directory, f"{ck.latest_step()}.npz"))
        out[label] = {"bytes": size, "save_ms": statistics.median(save_ms),
                      "restore_ms": statistics.median(restore_ms)}
        print(f"checkpoint {label}: {size} B a snapshot; save {out[label]['save_ms']:.4f} ms, "
              f"restore_latest {out[label]['restore_ms']:.4f} ms (host clock, median of 15)",
              flush=True)
    return out


def time_hogwild_checkpointer(train, test, model, tmp: str) -> list:
    """Hogwild fits (3 workers, 64 steps a dispatch, the CLI's criterion)
    without and with a checkpointer, in turns: updates/s of each."""
    rows = []
    for i, with_ckpt in enumerate((False, True, True, False)):
        ck = Checkpointer(os.path.join(tmp, f"hogwild-timing-{i}")) if with_ckpt else None
        eng = hw.HogwildEngine(model, 3, B, 0.5, steps_per_dispatch=HOGWILD_K, checkpointer=ck,
                               metrics=Metrics(), device="cuda")
        res = eng.fit(train, test, 1, no_improvement(patience=5, min_delta=0.01))
        saves = len(os.listdir(ck.directory)) if ck else 0
        rows.append({"checkpointer": with_ckpt, "updates": res.state.updates,
                     "seconds": res.state.duration,
                     "updates_per_s": res.state.updates / res.state.duration,
                     "checks": len(res.test_losses), "snapshots_kept": saves})
        print(f"Hogwild {'with' if with_ckpt else 'without'} a checkpointer: "
              f"{res.state.updates} updates in {res.state.duration:.3f} s "
              f"({rows[-1]['updates_per_s']:.1f} updates/s), {len(res.test_losses)} checks",
              flush=True)
    return rows


def run_checkpoint_phase() -> None:
    """Phase 7.  Its rows are generated once: every ``main()`` of the phase
    gets the same synthetic rows it would generate from the same seed."""
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    t0 = time.perf_counter()
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS):
        cfg = Config.from_env()
        rows = port_main.load_data(cfg)
    real_load = port_main.load_data
    port_main.load_data = lambda cfg: rows
    try:
        train, test, model = port_main.build(cfg, "cuda")
        print(f"checkpoint phase data seconds: {time.perf_counter() - t0:.2f}", flush=True)
        out = {"sync_sgd": check_sync_resume(train, test, model, tmp, "sgd"),
               "sync_adam": check_sync_resume(train, test, model, tmp, "adam")}
        check_nothing_to_run(train, test, model, tmp)
        out["hogwild"] = check_async_resume("Hogwild", tmp, HOGWILD_K,
                                            DSGD_STEPS_PER_DISPATCH=HOGWILD_K)
        out["local_sgd"] = check_async_resume("local SGD", tmp, LOCAL_SGD_PERIOD,
                                              DSGD_ASYNC_MODE="local_sgd",
                                              DSGD_SYNC_PERIOD=LOCAL_SGD_PERIOD,
                                              DSGD_CHECK_EVERY=LOCAL_SGD_CHECK_EVERY)
        out["profile"] = check_profile(tmp, train, test, model)
        out["checkpoint_ms"] = time_checkpoints(tmp)
        out["hogwild_checkpointer"] = time_hogwild_checkpointer(train, test, model, tmp)
        print(json.dumps({"checkpoints": out}), flush=True)
    finally:
        port_main.load_data = real_load
        shutil.rmtree(tmp)


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
    t0 = time.perf_counter()
    train = rcv1_like(TRAIN_ROWS, n_features=D, nnz=P, seed=0, idf_values=True)
    main_data = on_card(train)
    print(f"kernel data seconds: {time.perf_counter() - t0:.2f}", flush=True)
    se_row = check_sync_epoch(train, main_data)
    mean_row = check_mean_mode(train, main_data)
    opt_rows = dict(zip(("momentum", "adam"), check_opt_modes(train, main_data, se_row)))
    del train, main_data

    phase("4 engines on the card against the CPU")
    check_engine()
    check_async_engines()
    check_opt_engines()

    phase("5 sync paths: main path and per-step path")
    se_row["launches"] = run_main_path()
    se_row["path"] = "main"
    opt_rows["adam"]["launches"] = run_main_path_optimizer("adam")
    wg_row["launches"] = run_per_step_path()
    momentum_launches = run_per_step_path("momentum")
    wg_row["path"] = (f"per-step (K={PER_STEP_WORKERS}); 0 launches on the main path; "
                      f"{momentum_launches} more with momentum")
    busy_share()

    phase("6 async paths: Hogwild and local SGD")
    run_async_paths(mean_row, opt_rows)

    phase("7 checkpoints, resume and the profile")
    run_checkpoint_phase()

    phase("8 summary")
    print(card)
    print(json.dumps({"kernels": [wg_row, se_row, mean_row, opt_rows["momentum"],
                                  opt_rows["adam"]]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
