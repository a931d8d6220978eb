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
   ``worker_grads`` also 40 launches on one input, bitwise identical (its
   fixed-order sum), timed at the RPC reply's shape (K=1) and at K=8; for
   ``sync_epoch`` over one full 2,146-step epoch, and for its mean mode
   (K = 1, grad_divisor = B, the async engines' local steps) over one
   64-step Hogwild dispatch; then ``sync_epoch``'s momentum and adam modes
   (w and every state vector held to the plain version over 64 steps, at
   K = 3 and in the mean mode, and over a full epoch by its objective,
   each timed over a full epoch beside the sgd mode); and 40 launches of
   ``sync_epoch`` from one input, bitwise identical (its fixed-order
   sums), at K = 3 in each optimizer's mode and in the mean mode in each;
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
   Checkpointer (2 ``sync_epoch`` launches) against 3 epochs run through
   once, bitwise, with sgd and with adam (lr 0.001), and adam resumed with
   its optimizer state zeroed, which must not match; the resume with nothing left to
   run (0 launches); Hogwild and local SGD through ``main()`` with
   DSGD_CHECKPOINT_DIR, a fit and then a second one on the same directory
   (the restored best weights, the update counter, a resume past the
   budget with 0 launches, no worker thread left); a 2-epoch main-path run
   of ``python -m distributed_sgd_tpu_torch`` with DSGD_PROFILE_DIR, in a
   process of its own, whose trace holds one ``sync_epoch`` kernel; and
   the host times of a save and a restore, and of Hogwild with and without
   a checkpointer; then a local SGD fit run twice (100,000 rows; sgd, then
   adam), bitwise equal, and ``tools/sync_repeatability.py`` in a process
   of its own, one landing place for each optimizer;
8. the RPC engine: ``grpc`` and ``protobuf`` import (their versions
   printed); a DevCluster of 3 workers on the card at full width (B=100,
   lr 0.5, 1 epoch), checking that each window launched ``worker_grads``
   once a worker and ``sync_epoch`` never ran, that the test loss fell
   from its value at w = 0 and the test accuracy is >= 0.70, printing
   windows/s and the parts of a window, and scraping the fit's registry
   through a ``PrometheusExporter``; a 100,000-row fit with the nodes on
   the card against the same on the CPU, and the card's again under
   torch.profiler for the device's busy share, which must give bitwise
   the same weights; the CLI as one master and 3 workers in processes of their own on
   loopback with DSGD_TRACE=1, all exiting 0, whose merged trace puts the
   master's windows and the workers' Gradient spans under the same trace
   ids; and two torch.profiler sessions back to back in one process of
   their own (``tools/profiler_sessions.py``), each over one
   ``sync_epoch`` launch, each holding its kernel event, and a third
   after a 12 s gap, printed whatever it holds;
9. the async fit over RPC: ``main()`` with DSGD_ENGINE=rpc DSGD_ASYNC=1,
   a DevCluster of 3 workers on the card at full width (B=100, lr 0.5, 64
   steps a dispatch, 1 epoch's budget, early stop on), checking one
   ``sync_epoch`` launch in the mean mode a dispatch and no
   ``worker_grads``, the best weights' test accuracy >= 0.70, no async
   worker thread left and StopAsync at every worker, and printing
   updates/s, dispatches/s, the gossip sent and dropped and the stop
   reason; the same at 100,000 rows (its budget run out, early stop off)
   under torch.profiler for the device's busy share, and with momentum
   (lr 0.05) and adam (lr 0.001); and
   the CLI as one master and 3 workers in processes of their own with
   DSGD_ASYNC=1 (100,000 rows), all exiting 0;
10. fault tolerance over RPC, nodes on the card at full width (B=100) on
   a 100,000-row slice: a quorum of 3 of 3 workers with no straggler,
   bitwise equal to the plain barrier; worker 0 sleeping 1.0 s in its
   first 20 Gradient bodies under a quorum of 2 with a 0.1 s soft
   deadline, 2 epochs (the loss falls, accuracy >= 0.70, rounds degrade, hedges
   are sent and win, the straggler stays a member, ``worker_grads``
   launches equal the bodies run, hedges and late ones included), and
   the plain barrier with the same straggler; the heartbeat (0.5 s, 3
   misses) evicting a worker hard-killed mid-fit, the fit completing on
   the survivors; a master that dies after its 3rd fit-state snapshot
   (every 25 windows, 2 epochs), a new master on its port, the workers
   registered again through their watch, and the resumed fit bitwise
   equal to the run through, with sgd and adam (lr 0.001), 2 tokens in
   the lineage; an elastic async fit (k=64) with a leave and a join (>= 2
   resplits, one mean-mode launch a dispatch, no ``worker_grads``,
   accuracy >= 0.70, no async thread left, StopAsync at every member);
   and the CLI as one master and 3 workers with the heartbeat, a quorum,
   DSGD_ELASTIC and fit-state snapshots, the master SIGKILLed mid-fit and
   started again, the new master and the workers exiting 0;
11. the pipelined sync RPC engine, at full width: the K-step window (one
   ``sync_epoch`` launch in the sum mode, S=4, B=100, hinge,
   dim_sparsity) against its plain version for a full window and a short
   one (330 ids: 3 steps and a tail of 30), within 1e-6 and bitwise
   repeatable over 40 launches, timed beside its bound; phase 8's fit
   again with delta broadcasts, streams, 2 fan-in lanes and a stage pool
   of 2, bitwise equal to it, with the broadcast bytes of both;
   DSGD_LOCAL_STEPS=4 with every lever on for 2 epochs (ceil(part / 400)
   rounds an epoch, one launch a worker a round, no ``worker_grads``,
   accuracy >= 0.70, windows/s and a window's parts, and one epoch under
   torch.profiler for the busy share); and the CLI as one master and 3
   workers that map a row store built from the same synthetic rows in a
   temporary directory, each holding its third of the train rows and a
   10% margin, with every lever on: after the first epoch one worker
   leaves, each survivor reloads only the rows it did not hold, and all
   exit 0;
12. summary: the card line, one JSON line of per-kernel numbers, and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
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
WG_REPEATS = 40  # launches of worker_grads on one input that must agree bit for bit
SE_REPEATS = 40  # launches of sync_epoch on one input, in each mode, that must agree
K, B, P, D = 3, 100, 76, 47236  # the main path's worker_grads shape
MAIN_ROWS, MAIN_EPOCHS = 804414, 3
TRAIN_ROWS, STEPS = 643531, 2146  # the main path's train split and steps per epoch
LAM = 1e-5  # the CLI's default lambda
# per-rule step for the 20-step cases: least squares sums B squared-error
# gradients per worker and diverges at the CLI's 0.5
LR_FOR = {wg.HINGE: 0.5, wg.LOGISTIC: 0.5, wg.LEAST_SQUARES: 0.05}
# weights after 20 steps: the kernel's integer sums of g are exact, the
# plain version's f32 sums are not, and where a feature's terms cancel the
# kernel's g is 0.0 and the plain version's a residue, so dim_sparsity's
# g != 0 mask can add one 2 lam (w . dim_sparsity) more or less there
SE_ATOL = 1e-5
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


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


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
    """Kernel against plain version, and 40 launches on one input bitwise
    identical (the fixed-order sum); times it at the RPC reply's shape
    (K=1, B=100) and at the per-step path's (K=8, B=100).  Returns the
    kernel's summary row, its time and bound at K=1."""
    rng = np.random.default_rng(0)
    cases = [(f"main-shape kind={kind}", main_path_batch(kind), kind) for kind in wg.COEFF_KINDS]
    cases += [
        ("B=37", edge_batch(3, 37, P, 1), wg.HINGE),
        ("P=1", edge_batch(3, B, 1, 2), wg.LOGISTIC),
        ("duplicate ids", edge_batch(3, B, P, 3, dups=True), wg.LEAST_SQUARES),
        ("all-pad rows", edge_batch(3, B, P, 4, pad_rows=True), wg.HINGE),
        ("K=1", edge_batch(1, B, P, 5), wg.HINGE),
        ("K=8 B=1024", edge_batch(8, 1024, P, 6), wg.HINGE),
        ("K=8 B=1024 logistic", edge_batch(8, 1024, P, 7), wg.LOGISTIC),
    ]
    max_err = 0.0
    for label, (idx, val, y), kind in cases:
        w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
        args = [torch.from_numpy(a).cuda() for a in (idx, val, y)]
        got = wg.worker_grads(w, *args, kind)
        want = wg.worker_grads_plain(w, *args, kind)
        same = all(torch.equal(got, wg.worker_grads(w, *args, kind))
                   for _ in range(WG_REPEATS - 1))
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())
        print(f"worker_grads {label}: max_abs_err={err:.3e} nonzero={int((want != 0).sum())} "
              f"bitwise identical over {WG_REPEATS} launches: {same}", flush=True)
        if not ok:
            raise AssertionError(f"worker_grads {label} disagrees with its plain version "
                                 f"(max abs err {err}, rtol {RTOL}, atol {ATOL})")
        if not same:
            raise AssertionError(f"worker_grads {label}: {WG_REPEATS} launches on one input "
                                 f"are not bitwise identical")
        max_err = max(max_err, err)

    rows = {}
    for k in (1, 8):
        # RCV1-like rows at the main path's P, hinge (the main path's model)
        ds = rcv1_like(k * B, n_features=D, nnz=P, seed=10 + k, idf_values=True)
        idx, val = ds.indices.reshape(k, B, P), ds.values.reshape(k, B, P)
        y = ds.labels.reshape(k, B).astype(np.float32)
        w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
        args = [w] + [torch.from_numpy(a).cuda() for a in (idx, val, y)] + [wg.HINGE]
        kernel = lambda: wg.worker_grads(*args)  # noqa: E731
        plain = lambda: wg.worker_grads_plain(*args)  # noqa: E731
        plain_ms = [time_ms(plain)]
        kernel_ms = [time_ms(kernel), time_ms(kernel)]
        plain_ms.append(time_ms(plain))
        nz = val != 0
        n_nz = int(nz.sum())
        bytes_moved = idx.nbytes + val.nbytes + y.nbytes + 4 * len(np.unique(idx[nz])) + 4 * k * D
        flops = 4 * n_nz + 8 * k * B  # margin mul+add, scatter mul+add; the coefficient
        bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = flops / F32_FLOPS * 1e3
        rows[k] = {
            "kernel": "worker_grads", "K": k, "B": B, "max_abs_err": max_err,
            "kernel_us": min(kernel_ms) * 1e3, "plain_us": min(plain_ms) * 1e3,
            "bound_us": max(bound_bytes_ms, bound_ops_ms) * 1e3,
            "kernel_us_runs": [t * 1e3 for t in kernel_ms],
            "plain_us_runs": [t * 1e3 for t in plain_ms],
            "bytes": bytes_moved, "flops": flops,
            "ms": min(kernel_ms), "plain_ms": min(plain_ms),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        }
        print(json.dumps({k2: v for k2, v in rows[k].items()
                          if k2 not in ("ms", "plain_ms", "bound_ms", "bound_by")}), flush=True)
    one = rows[1]
    return {
        "name": "worker_grads", "route": "cuda",
        "source": "distributed_sgd_tpu_torch/csrc/worker_grads.cu",
        "replaces": TPU_KERNEL,
        "launches": None, "max_abs_err": max_err,
        # at the RPC reply's shape, K=1 B=100: this slice's main path
        "ms": one["ms"], "plain_ms": one["plain_ms"],
        "bound_ms": one["bound_ms"], "bound_by": one["bound_by"],
        # no single PyTorch call computes the fused gather + coefficient + scatter
        "library_ms": None,
        "k8_ms": rows[8]["ms"], "k8_plain_ms": rows[8]["plain_ms"],
        "k8_bound_ms": rows[8]["bound_ms"],
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
        ("K=4 B=150", main_data, rng.integers(0, TRAIN_ROWS, (20, 4, 150)), wg.HINGE,
         "dim_sparsity", w_rand, None),
        # rows wider than the 128 entries the lanes hold in registers
        ("P=200", on_card(edge_data(3000, 8, p=200)), rng.integers(0, 3000, (20, K, B)),
         wg.LOGISTIC, "dim_sparsity", w_rand, None),
        ("P=1", on_card(edge_data(3000, 9, p=1)), rng.integers(0, 3000, (20, K, B)),
         wg.HINGE, "none", w_rand, None),
    ]
    # a non-finite term: one value inf in a sampled row, one step from w = 0
    # (later steps would read the inf weight into margins, and the plain
    # version multiplies pad entries by it where the kernel skips them)
    inf_data = dict(edge_card, values=edge_card["values"].clone())
    inf_data["values"][1, 0] = float("inf")
    args, kw = sync_epoch_args(inf_data, np.array([[[1, 2, 4, 5]] * K]).reshape(1, K, 4),
                               wg.HINGE, "l2")
    got, want = se.sync_epoch(*args, **kw), se.sync_epoch_plain(*args, **kw)
    fin = torch.isfinite(want)
    inf_err = float((got[fin] - want[fin]).abs().max())
    print(f"sync_epoch non-finite term: non-finite entries {int((~fin).sum())}, the same "
          f"as the plain version's: {bool(torch.equal(torch.isfinite(got), fin))}; finite "
          f"entries max_abs_err={inf_err:.3e}", flush=True)
    if not (torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin])
            and inf_err <= SE_ATOL and int((~fin).sum()) > 0):
        raise AssertionError("sync_epoch: a non-finite term came out other than the plain "
                             "version's")
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


def digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()


def check_sync_epoch_repeats(main_data: dict) -> dict:
    """SE_REPEATS launches from one input give one output bit for bit (w
    and every state vector): one full epoch at K = 3 in the sgd, momentum
    and adam modes, and one 64-step dispatch in the mean mode (K = 1,
    grad_divisor = B) in each, each from the state one kernel epoch leaves.
    Prints the number of distinct outputs of each; returns them."""
    rng = np.random.default_rng(6)
    sub = -(-TRAIN_ROWS // K)
    thirds = np.minimum(sub, TRAIN_ROWS - np.arange(K) * sub)[:, None]

    def epoch_ids():
        return (rng.integers(0, sub, (STEPS, K, B)) % thirds + (np.arange(K) * sub)[:, None])

    counts = {}
    for kind in se.OPT_KINDS:
        opt = se.Optimizer(kind)
        args, kw = sync_epoch_args(main_data, epoch_ids(), wg.HINGE, "dim_sparsity",
                                   lr=OPT_LR.get(kind, 0.5))
        kw["optimizer"] = opt
        w1, st1 = se.sync_epoch(*args, **kw, opt_state=se.init_opt_state(opt, D, "cuda"))
        for mode, ids, extra in (
                (f"{kind} K={K}", torch.from_numpy(epoch_ids()).cuda(), {}),
                (f"{kind} mean mode K=1 ({HOGWILD_K} steps)",
                 torch.from_numpy(rng.integers(0, sub, (HOGWILD_K, 1, B))).cuda(),
                 {"n_total_workers": 1, "grad_divisor": B})):
            outs = set()
            for _ in range(SE_REPEATS):
                w, st = se.sync_epoch(w1, ids, *args[2:], **dict(kw, **extra), opt_state=st1)
                outs.add(digest(w, *st.vectors))
            counts[mode] = len(outs)
    print(f"sync_epoch distinct outputs of {SE_REPEATS} launches from one input: "
          f"{json.dumps(counts)}", flush=True)
    if set(counts.values()) != {1}:
        raise AssertionError(f"sync_epoch is not repeatable: {counts}")
    return counts


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
            "sent": m.counter("slave.async.grad.sent").value,
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


@contextmanager
def rows_of(n: int):
    """Every ``main()`` inside gets the same `n` synthetic rows, generated
    once (the rows it would generate from the same seed); yields the
    (train, test, model) that ``main()`` builds from them, on the card."""
    with cli_env(DSGD_SYNTHETIC=n):
        cfg = Config.from_env()
        rows = port_main.load_data(cfg)
    real_load = port_main.load_data
    port_main.load_data = lambda cfg: rows
    try:
        yield port_main.build(cfg, "cuda")
    finally:
        port_main.load_data = real_load


# a resume with adam's state zeroed must land outside these of the run
# through (the resumed fit itself must equal the run through bit for bit)
RESUME_LOSS_RTOL = 5e-6
RESUME_W_ATOL = 1e-5
LOCAL_TWICE_ROWS = 100000  # the local SGD fit run twice
REPEAT_FITS = 4  # fits of sync_repeatability: each lands at one place


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
    worker_grads, and the same fit run through once: the same test losses
    and bitwise the same weights (the kernel sums in a fixed order).  For
    adam, a resume with the optimizer state zeroed must land outside the
    bounds (test losses to 6 digits, weights to RESUME_W_ATOL).  Returns
    the numbers."""
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
    full = sync_trainer(model, kind).fit(train, test, MAIN_EPOCHS)
    gap = resume_gap(resumed, full)
    exact = (bool(torch.equal(resumed.weights, full.weights))
             and resumed.test_losses == full.test_losses[1:])
    print(f"sync {kind} run through: test losses {full.test_losses[1:]}; against the resumed "
          f"fit: largest relative difference {gap[0]:.3e}, weights max_abs_err {gap[1]:.3e}, "
          f"bitwise equal: {exact}", flush=True)
    if not exact:
        raise AssertionError(f"sync {kind}: the resumed fit differs from the run through "
                             f"(relative test-loss and weight gaps {gap})")
    out = {"launches": launches[0], "loss_rel": gap[0], "w_err": gap[1], "bitwise": exact}
    if kind == "adam":
        real = psync.BoundSync.load_opt_state_leaves
        psync.BoundSync.load_opt_state_leaves = lambda self, leaves: self.reset_optimizer()
        try:
            zeroed = sync_trainer(model, kind, checkpointer=Checkpointer(d + "-zeroed")).fit(
                train, test, MAIN_EPOCHS)
        finally:
            psync.BoundSync.load_opt_state_leaves = real
        zgap = resume_gap(zeroed, full)
        out["zeroed_gap"] = zgap
        print(f"sync adam resumed with its optimizer state zeroed: test losses "
              f"{zeroed.test_losses}; against the run through (relative, weights) {zgap}",
              flush=True)
        if within(zgap):
            raise AssertionError("a resume with the adam state zeroed matched the run through: "
                                 "the check cannot see a lost state")
    return out


def check_local_sgd_twice() -> dict:
    """A local SGD fit through ``main()`` run twice (LOCAL_TWICE_ROWS rows,
    1 epoch's budget; sgd, then adam at lr 0.001): the same best weights
    bit for bit, the same update counts and smoothed losses.  Only a
    fixed-order kernel (and a repeatable evaluation and early stop) can
    pass.  Returns what each pair gave."""
    out = {}
    for kind, env in (("sgd", {}), ("adam", {"DSGD_OPTIMIZER": "adam",
                                             "DSGD_LEARNING_RATE": OPT_LR["adam"]})):
        with cli_env(DSGD_SYNTHETIC=LOCAL_TWICE_ROWS, DSGD_ASYNC=1, DSGD_MAX_EPOCHS=1,
                     DSGD_ASYNC_MODE="local_sgd", DSGD_SYNC_PERIOD=LOCAL_SGD_PERIOD, **env):
            fits = [port_main.main().fit for _ in range(2)]
        same_w = bool(torch.equal(fits[0].weights, fits[1].weights))
        same_run = (fits[0].state.updates == fits[1].state.updates
                    and fits[0].test_losses == fits[1].test_losses)
        out[kind] = {"updates": [f.state.updates for f in fits], "best_weights_equal": same_w,
                     "checks": [len(f.test_losses) for f in fits],
                     "max_abs_diff": float((fits[0].weights - fits[1].weights).abs().max())}
        print(f"local SGD {kind} run twice ({LOCAL_TWICE_ROWS} rows): updates "
              f"{out[kind]['updates']}, checks {out[kind]['checks']}, smoothed losses equal: "
              f"{same_run}; best weights bitwise equal: {same_w} (max abs diff "
              f"{out[kind]['max_abs_diff']:.3e})", flush=True)
        if not same_run:
            first = next((i for i, (a, b) in enumerate(zip(fits[0].test_losses,
                                                           fits[1].test_losses)) if a != b),
                         None)
            print(f"local SGD {kind}: the two runs part at check {first}: "
                  f"{fits[0].test_losses[first:first + 3] if first is not None else []} against "
                  f"{fits[1].test_losses[first:first + 3] if first is not None else []}",
                  flush=True)
        if not (same_w and same_run):
            raise AssertionError(f"local SGD {kind}: two runs of one fit differ")
    return out


def check_sync_repeatability() -> dict:
    """``python -m distributed_sgd_tpu_torch.tools.sync_repeatability`` in
    a process of its own: one landing place for each optimizer."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m",
                          "distributed_sgd_tpu_torch.tools.sync_repeatability",
                          "--runs", str(REPEAT_FITS), "--launches", str(SE_REPEATS)],
                         cwd=root, capture_output=True, text=True, timeout=600)
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    for line in lines:
        print("sync_repeatability: " + json.dumps(line), flush=True)
    places = {x["optimizer"]: x["landing_places"] for x in lines}
    if out.returncode != 0 or places != {"sgd": 1, "adam": 1}:
        raise AssertionError(f"sync_repeatability: landing places {places} "
                             f"({out.returncode}):\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    return places


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
    """Phase 7, on rows generated once (`rows_of`)."""
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    t0 = time.perf_counter()
    try:
        with rows_of(MAIN_ROWS) as (train, test, model):
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
        shutil.rmtree(tmp)
    print(json.dumps({"repeats": {"local_sgd_twice": check_local_sgd_twice(),
                                  "sync_repeatability": check_sync_repeatability()}}),
          flush=True)


# -- phase 8: the RPC engine ----------------------------------------------------

RPC_WORKERS = 3
RPC_LR = 0.5  # the CLI's default
RPC_SMALL_ROWS = 100000  # the card-against-CPU fit and the CLI run
RPC_ACC_FLOOR = 0.70
RPC_PART_HISTS = (  # the host-side parts of one window, as the fit records them
    ("master encode and fan-out", "master.sync.fanout.seconds"),
    ("worker slave.grad.compute", "span.slave.grad.compute"),
    ("master barrier wait", "master.sync.barrier.seconds"),
    ("master decode", "master.sync.decode.seconds"),
    ("master apply", "master.sync.apply.seconds"),
    ("window", "master.sync.batch.duration"),
)


def rpc_versions() -> None:
    """The committed check that the GPU host has the RPC plane's packages."""
    import google.protobuf
    import grpc

    print(f"grpc {grpc.__version__} protobuf {google.protobuf.__version__}", flush=True)


def rpc_fit(model, train, test, metrics=None, profile: bool = False):
    """One epoch of the sync fit of a DevCluster of RPC_WORKERS workers on
    `model`'s device; returns (fit, initial test loss, worker_grads and
    sync_epoch launches, device events or None)."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=metrics) as c:
        loss0 = c.master.local_loss(np.zeros(D, np.float32), test=True)[0]
        out = []
        reset_counts()
        fit = lambda: out.append(c.master.fit_sync(1, B, RPC_LR))  # noqa: E731
        dev = device_events(fit) if profile else fit()
        launches = (wg.worker_grads.launches, se.sync_epoch.launches)
    return out[0], loss0, launches, dev


def check_rpc_full_width() -> dict:
    """The full-width RPC fit: worker_grads launches = windows x workers, no
    sync_epoch; the loss falls, accuracy >= 0.70; windows/s and the parts
    of a window; a scrape of the fit's registry.  Returns the fit's
    launches, weights and broadcast bytes, and its data (phase 11 runs the
    levers' fit on them)."""
    from distributed_sgd_tpu_torch.utils.metrics import PrometheusExporter

    t0 = time.perf_counter()
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS):
        train, test, model = port_main.build(Config.from_env(), "cuda")
    print(f"rpc data seconds: {time.perf_counter() - t0:.2f}", flush=True)
    m = Metrics()
    exporter = PrometheusExporter(m, 0, host="127.0.0.1").start()
    try:
        fit, loss0, (launches, se_launches), _ = rpc_fit(model, train, test, m)
        with urllib.request.urlopen(f"http://127.0.0.1:{exporter.port}/metrics",
                                    timeout=30) as r:
            scrape = r.read().decode()
    finally:
        exporter.stop()
    windows = m.counter("master.sync.rounds").value
    epoch_s = fit.epoch_seconds[0]
    parts = {label: m.histogram(name).mean * 1e3 for label, name in RPC_PART_HISTS}
    print(f"rpc fit (full width, {RPC_WORKERS} workers, B={B}, lr {RPC_LR}, 1 epoch): "
          f"initial test loss {loss0:.6f}; test loss {fit.test_losses[0]:.6f} accuracy "
          f"{fit.test_accuracies[0]:.4f}; {windows} windows in {epoch_s:.3f} s = "
          f"{windows / epoch_s:.1f} windows/s; worker_grads launches {launches}, sync_epoch "
          f"launches {se_launches}", flush=True)
    print("rpc ms a window: " + json.dumps({k: round(v, 4) for k, v in parts.items()}),
          flush=True)
    counters = {}
    for line in scrape.splitlines():
        name, _, value = line.partition(" ")
        if name in ("master_sync_rounds_total", "master_sync_grad_bytes_total",
                    "master_sync_bcast_bytes_total"):
            counters[name] = float(value)
    print(f"rpc scrape: {counters}", flush=True)
    if launches != windows * RPC_WORKERS or se_launches != 0 or windows == 0:
        raise AssertionError(f"rpc: {launches} worker_grads and {se_launches} sync_epoch "
                             f"launches over {windows} windows; want {windows * RPC_WORKERS} "
                             f"and 0")
    if not fit.test_losses[0] < loss0 or fit.test_accuracies[0] < RPC_ACC_FLOOR:
        raise AssertionError(f"rpc: test loss {fit.test_losses[0]} from {loss0}, accuracy "
                             f"{fit.test_accuracies[0]} (want lower, and >= {RPC_ACC_FLOOR})")
    w = np.asarray(fit.weights)
    if w.shape != (D,) or not np.isfinite(w).all():
        raise AssertionError("rpc: final weights not finite f32[D]")
    if (counters.get("master_sync_rounds_total", 0) <= 0
            or counters.get("master_sync_grad_bytes_total", 0) <= 0):
        raise AssertionError(f"rpc: the scrape shows no rounds or gradient bytes: {counters}")

    return {"launches": launches, "weights": w, "data": (train, test, model),
            "bcast_bytes": m.counter("master.sync.bcast.bytes").value}


def check_rpc_profiled(model, train, test, w: np.ndarray) -> None:
    """The fit that gave `w` run again under torch.profiler: the device's
    busy share, and bitwise the same weights."""
    again, _, _, dev = rpc_fit(model, train, test, profile=True)
    same = np.array_equal(np.asarray(again.weights), w)
    kernels = [(t0_, t1_) for t0_, t1_, name in dev if "worker_grads" in name
               or "margins_kernel" in name or "scatter_kernel" in name
               or "convert_kernel" in name]
    if dev:
        lo, hi = dev[0][0], max(t1_ for _, t1_, _ in dev)
        busy = union_us(dev, lo, hi)
        kernel_us = sum(t1_ - t0_ for t0_, t1_ in kernels)
        print(f"rpc device busy share over the profiled fit ({(hi - lo) / 1e3:.1f} ms from its "
              f"first device event to its last): {busy / (hi - lo):.4f}; worker_grads' "
              f"{len(kernels)} kernels (3 a call) {kernel_us / 1e3:.1f} ms, other device work "
              f"{(busy - kernel_us) / 1e3:.1f} ms", flush=True)
    else:
        print("rpc device busy share: not measured (no device events in the trace)", flush=True)
    print(f"rpc: the same fit run again (under torch.profiler) gives bitwise equal weights: "
          f"{same} (max abs diff {float(np.abs(np.asarray(again.weights) - w).max()):.3e})",
          flush=True)
    if not same:
        raise AssertionError("rpc: two runs of one fit gave different weights")


def check_rpc_card_against_cpu() -> None:
    """A RPC_SMALL_ROWS-row fit with the nodes on the card and again on the
    CPU: test losses rtol 1e-5, weights atol 1e-5; then the card's fit
    again under torch.profiler for the busy share, with bitwise the same
    weights.  (The profiled fit was once phase 8's full-width one: cut to
    these rows to keep the smoke's time.)"""
    data = rcv1_like(RPC_SMALL_ROWS, seed=0, idf_values=True)
    train, test = train_test_split(data)
    ds = dim_sparsity(train)
    fits = {}
    for dev in ("cuda", "cpu"):
        model = make_model("hinge", LAM, train.n_features, dim_sparsity=ds, device=dev)
        t0 = time.perf_counter()
        fits[dev] = rpc_fit(model, train, test)[0]
        print(f"rpc {RPC_SMALL_ROWS}-row fit on {dev}: {time.perf_counter() - t0:.2f} s, test "
              f"loss {fits[dev].test_losses[0]:.7f}", flush=True)
        if dev == "cuda":
            check_rpc_profiled(model, train, test, np.asarray(fits[dev].weights))
    err = float(np.abs(np.asarray(fits["cuda"].weights) - np.asarray(fits["cpu"].weights)).max())
    print(f"rpc card against CPU: weights max_abs_err={err:.3e}", flush=True)
    if err > 1e-5 or not np.allclose(fits["cuda"].test_losses, fits["cpu"].test_losses,
                                     rtol=1e-5, atol=0):
        raise AssertionError("rpc: the fit on the card disagrees with the fit on the CPU")


def check_rpc_cli() -> None:
    """``python -m distributed_sgd_tpu_torch`` as one master and
    RPC_WORKERS workers on loopback, traced: all exit 0, the master logs
    its test losses, and the merged trace has the master's sync.window
    spans and the workers' Gradient spans under the same trace ids."""
    import socket

    from distributed_sgd_tpu_torch.trace import merge

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    tmp = tempfile.mkdtemp(prefix="chip-smoke-rpc-")
    base = {**os.environ, "DSGD_SYNTHETIC": str(RPC_SMALL_ROWS), "DSGD_MAX_EPOCHS": "1",
            "DSGD_NODE_COUNT": str(RPC_WORKERS), "DSGD_TRACE": "1", "DSGD_TRACE_DIR": tmp,
            "DSGD_MASTER_HOST": "127.0.0.1", "DSGD_MASTER_PORT": str(port),
            "DSGD_NODE_HOST": "127.0.0.1"}
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "distributed_sgd_tpu_torch"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=root, env={**base, "DSGD_NODE_PORT": str(port)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(cmd, cwd=root, env={**base, "DSGD_NODE_PORT": "0"},
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for _ in range(RPC_WORKERS)]
    outs = [None] * len(procs)
    try:
        outs[0], _ = procs[0].communicate(timeout=600)
        for p in procs[1:]:
            p.send_signal(signal.SIGTERM)
        for i, p in enumerate(procs[1:], 1):
            outs[i], _ = p.communicate(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    losses = [line for line in outs[0].splitlines() if "test losses:" in line]
    epochs = [line.split(" - ", 1)[-1] for line in outs[0].splitlines() if "epoch 0:" in line]
    print(f"rpc CLI: master and {RPC_WORKERS} workers exited {codes} after {cli_s:.1f} s; "
          f"{losses[-1].strip() if losses else 'no test losses logged'}; master "
          f"{epochs[-1] if epochs else 'logged no epoch'}", flush=True)
    if codes != [0] * len(procs) or not losses:
        tails = "\n".join(f"== process {i} ({c}):\n{(o or '')[-2000:]}"
                           for i, (c, o) in enumerate(zip(codes, outs)))
        raise AssertionError(f"rpc CLI run failed:\n{tails}")
    merged = os.path.join(tmp, "merged.json")
    if merge.main([tmp, "-o", merged]) != 0:
        raise AssertionError(f"trace.merge found no trace files in {os.listdir(tmp)}")
    with open(merged) as f:
        events = json.load(f)["traceEvents"]
    windows = {e["args"]["trace_id"] for e in events if e.get("name") == "sync.window"}
    grads = {e["args"]["trace_id"] for e in events
             if e.get("name") == "Gradient" and e.get("ph") == "X"}
    files = sorted(n for n in os.listdir(tmp) if n.startswith("trace-"))
    window_ms = [e["dur"] / 1e3 for e in events if e.get("name") == "sync.window"]
    print(f"rpc trace: {len(files)} files {files}; {len(windows)} sync.window trace ids, "
          f"{len(grads)} with worker Gradient spans, {len(windows & grads)} shared; a "
          f"window across processes {statistics.median(window_ms or [0.0]):.3f} ms "
          f"(median of {len(window_ms)} traced)", flush=True)
    shutil.rmtree(tmp)
    if not windows or windows != grads or len(files) != 1 + RPC_WORKERS:
        raise AssertionError("rpc trace: the master's windows and the workers' Gradient spans "
                             "do not share their trace ids")


def check_profiler_sessions() -> None:
    """Two torch.profiler sessions in one process, each over one sync_epoch
    launch, must each hold its kernel event: ``python -m
    distributed_sgd_tpu_torch.tools.profiler_sessions`` in a process of
    its own (here, a short session long after this process's first one
    holds no device event: the trace's kernel timestamps drift from the
    host's, and the tool's third session, run after a gap, shows it)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m", "distributed_sgd_tpu_torch.tools.profiler_sessions"],
                         cwd=root, capture_output=True, text=True, timeout=300)
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    print(f"profiler sessions in one process: {lines[-1] if lines else out.stdout[-2000:]}",
          flush=True)
    if out.returncode != 0 or not lines:
        raise AssertionError(f"a torch.profiler session lost its kernel record "
                             f"({out.returncode}):\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")


def run_rpc_phase() -> dict:
    """Phase 8; returns check_rpc_full_width's dict."""
    rpc_versions()
    full = check_rpc_full_width()
    check_rpc_card_against_cpu()
    check_rpc_cli()
    check_profiler_sessions()
    return full


# -- phase 9: the async fit over RPC ---------------------------------------------

ASYNC_RPC_SMALL_ROWS = 100000  # the profiled fit, the momentum and adam fits, the CLI run
# their early stop, off: with momentum or adam the smoothed test loss of 3
# workers gossiping swings by more than the early stop's patience between
# checks (in the JAX package's async RPC fit too, on the CPU), and a test
# evaluation at 100,000 rows is cheap enough that checks every 100 updates
# come about 2,000 updates apart, so the early stop would end these fits
# at a random point of a swing; they run their budget and return the best
# weights their checks saw
ASYNC_RPC_SMALL_PATIENCE = 10 ** 6


def async_rpc_threads() -> list:
    return [t.name for t in threading.enumerate()
            if t.name.startswith("async-") and t.is_alive()]




def run_async_rpc(label: str, n_train: int, test_bound, profile: bool = False,
                  **env) -> dict:
    """``main()`` with DSGD_ENGINE=rpc DSGD_ASYNC=1: a DevCluster of
    RPC_WORKERS workers on the card, HOGWILD_K steps a dispatch, 1 epoch's
    budget, early stop on, and `env`.  Checks one sync_epoch launch in the
    optimizer's mean mode a dispatch and no worker_grads launch, that the
    smoothed test loss fell below 1.0, the best weights' test accuracy,
    that no async worker thread is left and every worker got StopAsync.
    With `profile`, under torch.profiler: the device's busy share from the
    first sync_epoch kernel to the end of the last.  Returns the numbers."""
    from distributed_sgd_tpu_torch.core.worker import WorkerNode

    kind = env.get("DSGD_OPTIMIZER", "sgd")
    stopped = []
    real_stop = WorkerNode.stop_async

    def counted_stop(node):
        stopped.append(node.port)
        return real_stop(node)

    WorkerNode.stop_async = counted_stop
    runs, dev = [], None
    try:
        with cli_env(DSGD_ENGINE="rpc", DSGD_ASYNC=1, DSGD_MAX_EPOCHS=1,
                     DSGD_NODE_COUNT=RPC_WORKERS, DSGD_STEPS_PER_DISPATCH=HOGWILD_K, **env):
            before = async_counts()
            reset_counts()
            if profile:
                dev = device_events(lambda: runs.append(port_main.main()))
            else:
                runs.append(port_main.main())
            torch.cuda.synchronize()
            launches, steps_run = se.sync_epoch.launches, se.sync_epoch.steps
            mode_launches = se.sync_epoch.opt_launches[kind]
            wg_launches = wg.worker_grads.launches
    finally:
        WorkerNode.stop_async = real_stop
    fit = runs[0].fit
    diff = {k: v - before[k] for k, v in async_counts().items()}
    dispatches = diff["batch"] // HOGWILD_K
    fit_s = fit.state.duration
    stop = "budget" if fit.state.updates >= n_train else "early stop"
    loss, acc = test_bound.evaluate(torch.from_numpy(np.asarray(fit.weights)).cuda())
    losses = fit.test_losses
    out = {"updates": fit.state.updates, "fit_s": fit_s,
           "updates_per_s": fit.state.updates / fit_s, "dispatches": dispatches,
           "dispatches_per_s": dispatches / fit_s, "launches": launches, "steps": steps_run,
           "worker_grads_launches": wg_launches, "gossip_sent": diff["sent"],
           "gossip_dropped": diff["dropped"], "merged": diff["merged"], "stop": stop,
           "checks": len(losses), "best_smoothed_loss": fit.state.loss,
           "best_test_loss": loss, "best_test_acc": acc, "stop_async": len(set(stopped))}
    print(f"async rpc {label}: {fit.state.updates} updates in {fit_s:.3f} s "
          f"({out['updates_per_s']:.1f} updates/s); {dispatches} dispatches "
          f"({out['dispatches_per_s']:.1f}/s); sync_epoch launches {launches} ({kind} "
          f"{mode_launches}) over {steps_run} steps; worker_grads launches {wg_launches}; "
          f"gossip sent {diff['sent']}, dropped {diff['dropped']}, merged by peers "
          f"{diff['merged']}; stopped by {stop} after {len(losses)} checks; StopAsync "
          f"reached {len(set(stopped))} workers", flush=True)
    print(f"async rpc {label} smoothed test losses: first {losses[:3]} last {losses[-3:]} "
          f"best {fit.state.loss}; best weights: raw test loss {loss:.7f} accuracy {acc:.7f}",
          flush=True)
    if dev is not None:
        kernels = [e for e in dev if "sync_epoch" in e[2]]
        if len(kernels) >= 2:
            lo, hi = kernels[0][0], max(t1 for _, t1, _ in kernels)
            out["busy_share"] = union_us(dev, lo, hi) / (hi - lo)
            out["kernel_share"] = union_us(kernels, lo, hi) / (hi - lo)
            print(f"async rpc {label} device busy share ({(hi - lo) / 1e3:.1f} ms from the "
                  f"first sync_epoch kernel to the end of the last, under torch.profiler): "
                  f"{out['busy_share']:.4f}; sync_epoch kernels cover "
                  f"{out['kernel_share']:.4f}, {len(kernels)} of them", flush=True)
        else:
            print(f"async rpc {label} device busy share: not measured ({len(dev)} device "
                  f"events, {len(kernels)} sync_epoch kernels)", flush=True)
    if dispatches < 1 or (launches, mode_launches, steps_run, wg_launches) != (
            dispatches, dispatches, dispatches * HOGWILD_K, 0):
        raise AssertionError(
            f"async rpc {label}: sync_epoch launched {launches} times ({mode_launches} in "
            f"its mode) over {steps_run} steps and worker_grads {wg_launches} times; want "
            f"{dispatches}, {dispatches}, {dispatches * HOGWILD_K} and 0")
    if not fit.state.updates <= diff["batch"] or not min(losses) < 1.0:
        raise AssertionError(f"async rpc {label}: the master counted {fit.state.updates} of "
                             f"{diff['batch']} steps; smoothed losses {losses}")
    if acc < ASYNC_ACC_FLOOR:
        raise AssertionError(f"async rpc {label}: best weights reach test accuracy {acc}, "
                             f"want >= {ASYNC_ACC_FLOOR}")
    if async_rpc_threads() or len(set(stopped)) != RPC_WORKERS:
        raise AssertionError(f"async rpc {label}: threads left {async_rpc_threads()}; "
                             f"StopAsync reached {len(set(stopped))} workers")
    return out


def check_async_rpc_cli() -> dict:
    """``python -m distributed_sgd_tpu_torch`` as one master and
    RPC_WORKERS workers on loopback with DSGD_ASYNC=1 (HOGWILD_K steps a
    dispatch, ASYNC_RPC_SMALL_ROWS rows, 1 epoch's budget): all exit 0 and
    the master logs its test losses and its update count."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = {**os.environ, "DSGD_SYNTHETIC": str(ASYNC_RPC_SMALL_ROWS), "DSGD_MAX_EPOCHS": "1",
            "DSGD_ASYNC": "1", "DSGD_STEPS_PER_DISPATCH": str(HOGWILD_K),
            "DSGD_NODE_COUNT": str(RPC_WORKERS), "DSGD_MASTER_HOST": "127.0.0.1",
            "DSGD_MASTER_PORT": str(port), "DSGD_NODE_HOST": "127.0.0.1"}
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "distributed_sgd_tpu_torch"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=root, env={**base, "DSGD_NODE_PORT": str(port)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)]
    procs += [subprocess.Popen(cmd, cwd=root, env={**base, "DSGD_NODE_PORT": "0"},
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
              for _ in range(RPC_WORKERS)]
    outs = [None] * len(procs)
    try:
        outs[0], _ = procs[0].communicate(timeout=600)
        for p in procs[1:]:
            p.send_signal(signal.SIGTERM)
        for i, p in enumerate(procs[1:], 1):
            outs[i], _ = p.communicate(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    lines = outs[0].splitlines()
    losses = [x.split(" - ", 1)[-1] for x in lines if "test losses:" in x]
    done = [x.split(" - ", 1)[-1] for x in lines if "fit done:" in x]
    checks = [x for x in lines if "loss computed at" in x]
    print(f"async rpc CLI: master and {RPC_WORKERS} workers exited {codes} after {cli_s:.1f} s; "
          f"{done[-1] if done else 'no fit logged'}; {len(checks)} checks; "
          f"{losses[-1][:300] if losses else 'no test losses logged'}", flush=True)
    if codes != [0] * len(procs) or not losses or not done or not checks:
        tails = "\n".join(f"== process {i} ({c}):\n{(o or '')[-2000:]}"
                           for i, (c, o) in enumerate(zip(codes, outs)))
        raise AssertionError(f"async rpc CLI run failed:\n{tails}")
    return {"codes": codes, "seconds": cli_s, "checks": len(checks)}


def run_async_rpc_phase() -> int:
    """Phase 9; returns the full-width sgd fit's sync_epoch launches."""
    t0 = time.perf_counter()
    out = {}
    with rows_of(MAIN_ROWS) as (train, test, model):
        test_bound = SyncEngine(model, B, 0.0).bind(test)
        print(f"async rpc data seconds: {time.perf_counter() - t0:.2f}", flush=True)
        out["sgd"] = run_async_rpc("sgd (full width)", len(train), test_bound)
    with rows_of(ASYNC_RPC_SMALL_ROWS) as (train, test, model):
        test_bound = SyncEngine(model, B, 0.0).bind(test)
        small = dict(DSGD_PATIENCE=ASYNC_RPC_SMALL_PATIENCE)
        out["sgd_profiled"] = run_async_rpc(f"sgd ({ASYNC_RPC_SMALL_ROWS} rows, profiled)",
                                            len(train), test_bound, profile=True, **small)
        for kind in ("momentum", "adam"):
            out[kind] = run_async_rpc(f"{kind} ({ASYNC_RPC_SMALL_ROWS} rows)", len(train),
                                      test_bound, DSGD_OPTIMIZER=kind,
                                      DSGD_LEARNING_RATE=OPT_LR[kind], **small)
    out["cli"] = check_async_rpc_cli()
    print(json.dumps({"async_rpc": out}), flush=True)
    return out["sgd"]["launches"]


# -- phase 10: fault tolerance over RPC --------------------------------------------

FT_ROWS = 100000  # the slice phase 10 trains on (80,000 train rows)
FT_STRAGGLER_S, FT_STRAGGLER_CALLS = 1.0, 20  # worker 0's first 20 bodies sleep 1.0 s
FT_QUORUM, FT_SOFT_S = 2, 0.1  # 2 of 3; the soft deadline is about 6 healthy windows
# epochs of the straggler fits: the test accuracy at 100,000 rows is 0.683
# after 1 and 0.709 after 2 (the plain barrier's, which a quorum whose
# hedges win lands on bit for bit)
FT_STRAGGLER_EPOCHS = 2
FT_HEARTBEAT_S, FT_MAX_MISSES = 0.5, 3
FT_KILL_AT_WINDOW = 50  # the heartbeat run's victim dies after this many windows
FT_SNAPSHOT_EVERY, FT_CRASH_AT, FT_CRASH_EPOCHS = 25, 3, 2
FT_WATCH_S = 0.2  # the workers' master watch in the crash run
FT_CLI_SNAPSHOT_EVERY = 50


def ft_cluster(model, train, test, metrics, **kw):
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    return DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=metrics,
                      **kw)


def ft_parts(m: Metrics) -> dict:
    return {label: round(m.histogram(name).mean * 1e3, 4) for label, name in RPC_PART_HISTS}


def check_quorum_in_full(model, train, test) -> None:
    """A quorum of RPC_WORKERS over RPC_WORKERS workers and no straggler:
    the weights equal the plain barrier's bit for bit, no round degraded
    and no hedge sent."""
    from distributed_sgd_tpu_torch.utils import metrics as mm

    m = Metrics()
    with ft_cluster(model, train, test, m) as c:
        plain = c.master.fit_sync(1, B, RPC_LR)
        reset_counts()
        full = c.master.fit_sync(1, B, RPC_LR, quorum=RPC_WORKERS)
        launches = wg.worker_grads.launches
    diff = float(np.abs(np.asarray(full.weights) - np.asarray(plain.weights)).max())
    same = np.array_equal(np.asarray(full.weights), np.asarray(plain.weights))
    degraded, hedges = (m.counter(mm.QUORUM_DEGRADED).value, m.counter(mm.QUORUM_HEDGES).value)
    print(f"ft quorum {RPC_WORKERS} of {RPC_WORKERS} ({FT_ROWS} rows, 1 epoch, sgd): weights "
          f"bitwise equal to the plain barrier's: {same} (max abs diff {diff:.3e}); degraded "
          f"{degraded}, hedges {hedges}; worker_grads launches {launches}; test accuracy "
          f"{full.test_accuracies[-1]:.4f}", flush=True)
    if not same or degraded or hedges:
        raise AssertionError("ft: a full quorum differs from the plain barrier")


def slow_first_calls(worker, seconds: float, calls: int, on_recovered=None) -> dict:
    """Instance seam (as tests/test_quorum.py's): `worker`'s first `calls`
    compute_gradient bodies sleep `seconds` first.  `on_recovered` runs
    once the last of them has returned."""
    real = worker.compute_gradient
    lock = threading.Lock()
    state = {"calls": 0, "slow_left": calls}

    def slow(w, ids):
        with lock:
            state["calls"] += 1
            is_slow = state["calls"] <= calls
        if not is_slow:
            return real(w, ids)
        time.sleep(seconds)
        out = real(w, ids)
        with lock:
            state["slow_left"] -= 1
            last = state["slow_left"] == 0
        if last and on_recovered is not None:
            on_recovered()
        return out

    worker.compute_gradient = slow
    return state


def straggler_fit(model, train, test, **kw) -> dict:
    """FT_STRAGGLER_EPOCHS epochs with worker 0 slowed; returns the numbers."""
    from distributed_sgd_tpu_torch.utils import metrics as mm

    m = Metrics()
    names = {"degraded": mm.QUORUM_DEGRADED, "hedges": mm.QUORUM_HEDGES,
             "hedge_wins": mm.QUORUM_HEDGE_WINS, "late": mm.QUORUM_LATE,
             "stalled": mm.SYNC_STALLED, "evictions": mm.MASTER_EVICTIONS,
             "windows": mm.SYNC_ROUNDS, "bodies": "slave.sync.backward",
             "hedges_served": "slave.sync.hedge"}
    at_recovery = {}

    def recovered():
        # windows from a quarter second after the straggler's last slow
        # body returned see no straggler
        def snap():
            at_recovery.update({k: m.counter(v).value for k, v in names.items()})
        threading.Timer(0.25, snap).start()

    with ft_cluster(model, train, test, m) as c:
        slowed = slow_first_calls(c.workers[0], FT_STRAGGLER_S, FT_STRAGGLER_CALLS, recovered)
        reset_counts()
        t0 = time.perf_counter()
        fit = c.master.fit_sync(FT_STRAGGLER_EPOCHS, B, RPC_LR, grad_timeout_s=60.0, **kw)
        fit_s = time.perf_counter() - t0
        straggler_member = (c.workers[0].host, c.workers[0].port) in c.master.members
        deadline = time.monotonic() + 30
        while slowed["slow_left"] and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)  # the late bodies return; the last counters settle
        launches = wg.worker_grads.launches
        out = {k: m.counter(v).value for k, v in names.items()}
    out.update(fit_s=fit_s, windows_per_s=out["windows"] / sum(fit.epoch_seconds),
               launches=launches, straggler_member=straggler_member,
               straggler_calls=slowed["calls"], test_loss=fit.test_losses[-1],
               test_acc=fit.test_accuracies[-1], ms_a_window=ft_parts(m))
    if at_recovery:
        out["windows_after_recovery"] = out["windows"] - at_recovery["windows"]
        out["degraded_after_recovery"] = out["degraded"] - at_recovery["degraded"]
    return out


def check_straggler(model, train, test, loss0: float) -> dict:
    """Worker 0 sleeps FT_STRAGGLER_S in its first FT_STRAGGLER_CALLS
    bodies: under a quorum of FT_QUORUM with a soft deadline of FT_SOFT_S
    the fit completes, the loss falls, accuracy >= RPC_ACC_FLOOR, rounds
    degrade, hedges are sent and win, the straggler stays a member, and
    worker_grads launched once a Gradient body the workers ran (hedges and
    late bodies included).  The plain barrier with the same straggler, for
    comparison."""
    q = straggler_fit(model, train, test, quorum=FT_QUORUM, straggler_soft_s=FT_SOFT_S)
    plain = straggler_fit(model, train, test)
    for label, out in (("quorum", q), ("plain barrier", plain)):
        print(f"ft straggler, {label}: " + json.dumps(out), flush=True)
    print(f"ft straggler: windows/s {q['windows_per_s']:.2f} under the quorum, "
          f"{plain['windows_per_s']:.2f} under the plain barrier; windows degraded with no "
          f"straggler present: {q.get('degraded_after_recovery')} of "
          f"{q.get('windows_after_recovery')}", flush=True)
    if not (q["test_loss"] < loss0 and q["test_acc"] >= RPC_ACC_FLOOR):
        raise AssertionError(f"ft straggler: the quorum fit did not train: {q}")
    if not (q["degraded"] > 0 and q["hedges"] > 0 and q["hedge_wins"] > 0):
        raise AssertionError(f"ft straggler: no degraded round, hedge or hedge win: {q}")
    if not q["straggler_member"] or q["evictions"]:
        raise AssertionError("ft straggler: the straggler was evicted")
    for label, out in (("quorum", q), ("plain barrier", plain)):
        if out["launches"] != out["bodies"]:
            raise AssertionError(f"ft straggler, {label}: {out['launches']} worker_grads "
                                 f"launches for {out['bodies']} Gradient bodies")
    if q["hedges_served"] != q["hedges"]:
        raise AssertionError(f"ft straggler: {q['hedges']} hedges sent, "
                             f"{q['hedges_served']} served")
    return q


def hard_kill(worker) -> None:
    """A crash: the server goes with no unregistration."""
    worker._stopped.set()
    worker.server.stop(grace=0)


def check_heartbeat(model, train, test, loss0: float) -> dict:
    """The heartbeat (FT_HEARTBEAT_S, FT_MAX_MISSES) evicts a worker
    hard-killed mid-fit; the fit, which retries its windows and never
    evicts by itself here, completes on the survivors, its test loss
    below `loss0`, its value at w = 0."""
    from distributed_sgd_tpu_torch.utils import metrics as mm

    m = Metrics()
    box = {}
    with ft_cluster(model, train, test, m, heartbeat_s=FT_HEARTBEAT_S,
                    heartbeat_max_misses=FT_MAX_MISSES) as c:
        victim = c.workers[0]
        key = (victim.host, victim.port)

        def run():
            try:
                box["fit"] = c.master.fit_sync(1, B, RPC_LR, grad_retries=10 ** 6,
                                               grad_timeout_s=30.0)
            except Exception as e:  # noqa: BLE001 - raised below
                box["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        while m.counter(mm.SYNC_ROUNDS).value < FT_KILL_AT_WINDOW and t.is_alive():
            time.sleep(0.005)
        t_kill = time.monotonic()
        hard_kill(victim)
        while key in c.master.members and time.monotonic() - t_kill < 60:
            time.sleep(0.005)
        latency = time.monotonic() - t_kill
        t.join(timeout=600)
        c.workers = c.workers[1:]
        members = len(c.master.members)
    if "error" in box or t.is_alive():
        raise AssertionError(f"ft heartbeat: the fit did not complete: {box.get('error')}")
    fit = box["fit"]
    out = {"eviction_s": latency, "evictions": m.counter(mm.MASTER_EVICTIONS).value,
           "windows": m.counter(mm.SYNC_ROUNDS).value, "resplits": m.counter(
               mm.SYNC_RESPLITS).value, "members": members,
           "test_loss": fit.test_losses[-1], "test_acc": fit.test_accuracies[-1]}
    print(f"ft heartbeat ({FT_HEARTBEAT_S} s, {FT_MAX_MISSES} misses): worker killed after "
          f"{FT_KILL_AT_WINDOW} windows, evicted {latency:.3f} s later; " + json.dumps(out),
          flush=True)
    bound = (FT_MAX_MISSES + 2) * FT_HEARTBEAT_S + 2.0
    if out["evictions"] != 1 or members != RPC_WORKERS - 1 or latency > bound:
        raise AssertionError(f"ft heartbeat: {out} (eviction bound {bound} s)")
    if not out["test_loss"] < loss0:
        raise AssertionError(f"ft heartbeat: the survivors' fit did not train: {out}")
    return out


def rebind_master(port: int, train, test, model):
    """A new MasterNode on `port`: the OS may free it late, so retry."""
    from distributed_sgd_tpu_torch.core.master import MasterNode

    for _ in range(50):
        try:
            node = MasterNode("127.0.0.1", port, train, test, model,
                              expected_workers=RPC_WORKERS, seed=0)
        except RuntimeError:
            node = None
        if node is not None and node.server.bound_port:
            return node
        if node is not None:
            node.server.stop(grace=0)
        time.sleep(0.2)
    raise AssertionError(f"ft crash: could not bind the master's port {port} again")


def check_master_crash(model, train, test, kind: str, tmp: str) -> dict:
    """The master dies after its FT_CRASH_AT-th snapshot (every
    FT_SNAPSHOT_EVERY windows, FT_CRASH_EPOCHS epochs); a new MasterNode
    binds its port, the workers register again through their watch, and
    the fit resumes from the snapshot to weights bitwise equal to the run
    through, with 2 tokens in the lineage."""
    from distributed_sgd_tpu_torch.core import master as master_mod

    lr = OPT_LR.get(kind, RPC_LR)
    path = os.path.join(tmp, f"fit_state_{kind}.npz")
    kw = dict(optimizer=kind, grad_timeout_s=60.0)
    real_save, real_restore = master_mod.save_fit_state, master_mod.restore_fit_state
    saves, restores = [], []

    def timed_save(*a, **k):
        t0 = time.perf_counter()
        real_save(*a, **k)
        saves.append(time.perf_counter() - t0)
        if len(saves) == FT_CRASH_AT:
            raise RuntimeError("injected master crash")

    def timed_restore(*a, **k):
        t0 = time.perf_counter()
        out = real_restore(*a, **k)
        restores.append(time.perf_counter() - t0)
        return out

    m = Metrics()
    with ft_cluster(model, train, test, m, master_watch_s=FT_WATCH_S) as c:
        ref = c.master.fit_sync(FT_CRASH_EPOCHS, B, lr, **kw)
        master_mod.save_fit_state = timed_save
        try:
            c.master.fit_sync(FT_CRASH_EPOCHS, B, lr, fit_state_path=path,
                              fit_state_every=FT_SNAPSHOT_EVERY, **kw)
            raise AssertionError("ft crash: the injected crash did not happen")
        except RuntimeError as e:
            if "injected master crash" not in str(e):
                raise
        finally:
            master_mod.save_fit_state = real_save
        port = c.master.port
        c.master._hb_stop.set()
        c.master.server.stop(grace=0)  # the kill: no unregistration
        t0 = time.monotonic()
        m2 = rebind_master(port, train, test, model).start()
        try:
            if not m2.await_ready(timeout=120):
                raise AssertionError("ft crash: the workers never registered again")
            rereg_s = time.monotonic() - t0
            master_mod.save_fit_state = timed_save  # past FT_CRASH_AT: no crash
            master_mod.restore_fit_state = timed_restore
            reset_counts()
            res = m2.fit_sync(FT_CRASH_EPOCHS, B, lr, fit_state_path=path,
                              fit_state_every=FT_SNAPSHOT_EVERY, **kw)
            replay_launches = wg.worker_grads.launches
        finally:
            master_mod.save_fit_state = real_save
            master_mod.restore_fit_state = real_restore
            m2.stop()
    with np.load(path) as z:
        tokens = [int(x) for x in z["fit_tokens"]]
    same = np.array_equal(np.asarray(res.weights), np.asarray(ref.weights))
    diff = float(np.abs(np.asarray(res.weights) - np.asarray(ref.weights)).max())
    out = {"bitwise": same, "max_abs_diff": diff, "tokens": len(tokens),
           "save_ms_median": statistics.median(saves) * 1e3, "saves": len(saves),
           "restore_ms": [round(x * 1e3, 3) for x in restores], "rereg_s": rereg_s,
           "replay_launches": replay_launches, "test_acc": res.test_accuracies[-1]}
    print(f"ft crash ({kind}, lr {lr}): crash after snapshot {FT_CRASH_AT} (every "
          f"{FT_SNAPSHOT_EVERY} windows), resumed " + json.dumps(out), flush=True)
    if not same or len(tokens) != 2 or tokens[0] == tokens[1]:
        raise AssertionError(f"ft crash ({kind}): the resumed fit is not the run through: {out}")
    return out


def check_elastic_async(model, train, test) -> dict:
    """``fit_async(elastic=True)`` over RPC_WORKERS workers, HOGWILD_K steps
    a dispatch, 1 epoch's budget: mid-fit one worker leaves and a new one
    joins.  At least 2 resplits; one mean-mode sync_epoch launch a
    dispatch and no worker_grads; best accuracy >= ASYNC_ACC_FLOOR; no
    async thread left and StopAsync at every member."""
    from distributed_sgd_tpu_torch.core.worker import WorkerNode
    from distributed_sgd_tpu_torch.utils import metrics as mm

    m = Metrics()
    stopped = []
    real_stop = WorkerNode.stop_async

    def counted_stop(node):
        stopped.append(node.port)
        return real_stop(node)

    WorkerNode.stop_async = counted_stop
    box = {}
    try:
        with ft_cluster(model, train, test, m, steps_per_dispatch=HOGWILD_K) as c:
            budget = len(train)

            def run():
                try:
                    box["fit"] = c.master.fit_async(1, B, RPC_LR, check_every=1000,
                                                    elastic=True)
                except Exception as e:  # noqa: BLE001 - raised below
                    box["error"] = e

            reset_counts()
            t = threading.Thread(target=run, daemon=True)
            t0 = time.perf_counter()
            t.start()
            while c.master._updates < budget // 5 and t.is_alive():
                time.sleep(0.01)
            c.leave_worker(0)
            while m.counter(mm.ASYNC_RESPLITS).value < 1 and t.is_alive():
                time.sleep(0.01)
            joined = c.add_worker(seed=RPC_WORKERS)
            while joined._assignment is None and t.is_alive():
                time.sleep(0.01)
            t.join(timeout=600)
            fit_s = time.perf_counter() - t0
            torch.cuda.synchronize()
            members = [w.port for w in c.workers]
            launches = se.sync_epoch.opt_launches["sgd"]
            all_launches, wg_launches = se.sync_epoch.launches, wg.worker_grads.launches
    finally:
        WorkerNode.stop_async = real_stop
    if "error" in box or t.is_alive():
        raise AssertionError(f"ft elastic: the fit did not complete: {box.get('error')}")
    fit = box["fit"]
    dispatches = m.counter("slave.async.batch").value // HOGWILD_K
    loss, acc = SyncEngine(model, B, 0.0).bind(test).evaluate(
        torch.from_numpy(np.asarray(fit.weights)).to(model.device))
    out = {"updates": fit.state.updates, "fit_s": fit_s, "dispatches": dispatches,
           "sync_epoch_launches": launches, "worker_grads_launches": wg_launches,
           "resplits": m.counter(mm.ASYNC_RESPLITS).value, "best_test_loss": loss,
           "best_test_acc": acc, "stop_async": sorted(set(stopped)), "members": members,
           "threads_left": async_rpc_threads()}
    print(f"ft elastic async (k={HOGWILD_K}, a leave and a join): " + json.dumps(out),
          flush=True)
    if out["resplits"] < 2 or fit.state.updates < budget:
        raise AssertionError(f"ft elastic: {out}")
    if (launches, all_launches, wg_launches) != (dispatches, dispatches, 0) or not dispatches:
        raise AssertionError(f"ft elastic: launches {launches} ({all_launches} in all) and "
                             f"{wg_launches} worker_grads for {dispatches} dispatches")
    if acc < ASYNC_ACC_FLOOR or out["threads_left"] or not set(members) <= set(stopped):
        raise AssertionError(f"ft elastic: {out}")
    return out


def check_fault_tolerance_cli(tmp: str) -> dict:
    """``python -m distributed_sgd_tpu_torch`` as one master and
    RPC_WORKERS workers on loopback with the heartbeat, a quorum, elastic
    workers and snapshots every FT_CLI_SNAPSHOT_EVERY windows: the master
    is SIGKILLed mid-fit after its first snapshot and started again with
    the same settings; the workers register again, the fit resumes, and
    the new master and the workers exit 0, with 2 tokens in the lineage."""
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    ckpt = os.path.join(tmp, "cli")
    base = {**os.environ, "DSGD_SYNTHETIC": str(FT_ROWS), "DSGD_MAX_EPOCHS": "2",
            "DSGD_NODE_COUNT": str(RPC_WORKERS), "DSGD_HEARTBEAT_S": "1",
            "DSGD_QUORUM": str(FT_QUORUM), "DSGD_ELASTIC": "1", "DSGD_CHECKPOINT_DIR": ckpt,
            "DSGD_FIT_CKPT_EVERY": str(FT_CLI_SNAPSHOT_EVERY),
            "DSGD_MASTER_HOST": "127.0.0.1", "DSGD_MASTER_PORT": str(port),
            "DSGD_NODE_HOST": "127.0.0.1"}
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "distributed_sgd_tpu_torch"]
    state = os.path.join(ckpt, "fit_state.npz")

    def start(node_port):
        return subprocess.Popen(cmd, cwd=root, env={**base, "DSGD_NODE_PORT": str(node_port)},
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    t0 = time.perf_counter()
    first = start(port)
    workers = [start(0) for _ in range(RPC_WORKERS)]
    procs = [first] + workers
    outs = {}
    try:
        deadline = time.monotonic() + 600
        while not os.path.exists(state) and first.poll() is None and time.monotonic() < deadline:
            time.sleep(0.05)
        t_kill = time.perf_counter()
        first.kill()  # SIGKILL: no unregistration, no terminal snapshot
        outs["killed"], _ = first.communicate(timeout=60)
        while True:  # the restarted master binds the same port
            with socket.socket() as sock:
                # as gRPC binds: the killed master's connections linger in
                # TIME_WAIT for a minute, which only a plain bind waits out
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
                try:
                    sock.bind(("127.0.0.1", port))
                    break
                except OSError:
                    time.sleep(0.1)
        t_restart = time.perf_counter()
        second = start(port)
        procs.append(second)
        outs["master"], _ = second.communicate(timeout=900)
        for p in workers:
            p.send_signal(signal.SIGTERM)
        for i, p in enumerate(workers):
            outs[f"w{i}"], _ = p.communicate(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    cli_s = time.perf_counter() - t0
    codes = [second.returncode] + [p.returncode for p in workers]
    lines = outs["master"].splitlines()
    killed_epochs = [x.split(" - ", 1)[-1] for x in outs["killed"].splitlines()
                     if "epoch 0:" in x]
    epochs = [x.split(" - ", 1)[-1] for x in lines if ": loss=" in x and "epoch " in x]
    resumed = [x.split(" - ", 1)[-1] for x in lines if "resumed crash-safe fit state" in x]
    losses = [x.split(" - ", 1)[-1] for x in lines if "test losses:" in x]
    rereg = sum(outs[f"w{i}"].count("registered with master") for i in range(RPC_WORKERS))

    def stamp(line):  # the log's ISO time of day, in seconds
        hms, ms = line.split(" ", 1)[0].split("T")[1].split(".")
        h, mi, sec = (int(x) for x in hms.split(":"))
        return h * 3600 + mi * 60 + sec + int(ms) / 1e3

    up = [stamp(x) for x in lines if "master started on" in x]
    full = [stamp(x) for x in lines if f"({RPC_WORKERS}/{RPC_WORKERS})" in x]
    tokens = []
    if os.path.exists(state):
        with np.load(state) as z:
            tokens = [int(x) for x in z["fit_tokens"]]
    out = {"codes": codes, "killed_code": first.returncode, "seconds": cli_s,
           "kill_after_s": t_kill - t0, "port_free_after_s": t_restart - t_kill,
           "tokens": len(tokens), "registrations": rereg,
           "rereg_s": full[0] - up[0] if up and full else None,
           "failed_registrations": [outs[f"w{i}"].count("registration failed")
                                    for i in range(RPC_WORKERS)]}
    print(f"ft CLI: {json.dumps(out)}; master: {resumed[-1] if resumed else 'no resume line'}; "
          f"{losses[-1][:300] if losses else 'no test losses logged'}; its epochs {epochs}; "
          f"the killed master's {killed_epochs}", flush=True)
    if codes != [0] * (1 + RPC_WORKERS) or not resumed or not losses or len(tokens) != 2:
        tails = "\n".join(f"== {k}:\n{(v or '')[-2000:]}" for k, v in outs.items())
        raise AssertionError(f"ft CLI run failed: {out}\n{tails}")
    return out


def run_fault_tolerance_phase() -> dict:
    """Phase 10; returns the numbers of its paths."""
    t0 = time.perf_counter()
    out = {}
    with rows_of(FT_ROWS) as (train, test, model):
        print(f"ft data seconds: {time.perf_counter() - t0:.2f}", flush=True)
        loss0 = SyncEngine(model, B, 0.0).bind(test).evaluate(
            torch.zeros(D, device=model.device))[0]
        check_quorum_in_full(model, train, test)
        out["straggler"] = check_straggler(model, train, test, loss0)
        out["heartbeat"] = check_heartbeat(model, train, test, loss0)
        with tempfile.TemporaryDirectory(prefix="chip-smoke-ft-") as tmp:
            for kind in ("sgd", "adam"):
                out[f"crash_{kind}"] = check_master_crash(model, train, test, kind, tmp)
        out["elastic"] = check_elastic_async(model, train, test)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ft-cli-") as tmp:
        out["cli"] = check_fault_tolerance_cli(tmp)
    print(f"ft phase seconds: {time.perf_counter() - t0:.1f}", flush=True)
    return out


# -- phase 11: the pipelined sync RPC engine ---------------------------------------

WINDOW_K = 4  # DSGD_LOCAL_STEPS of the window checks and of the K-step fit
WINDOW_ATOL = 1e-6  # the window kernel against its plain version
WINDOW_ROWS = 20000  # rows the window kernel's checks draw from
WINDOW_FIT_EPOCHS = 2
PIPE_CLI_ROWS = 100000  # the row-store CLI run (80,000 train rows)
PIPE_CLI_EPOCHS = 3
PIPE_CLI_OVERPROVISION = 0.1
# every lever at once, as the fit's keywords and as the CLI's settings
PIPE_LEVERS = dict(delta_broadcast=True, stream=True, fanin_lanes=2, stage_pool=2)
PIPE_ENV = {"DSGD_DELTA_BROADCAST": "1", "DSGD_STREAM": "1", "DSGD_FANIN_LANES": "2",
            "DSGD_STAGE_POOL": "2"}
BCAST_COUNTERS = ("bytes", "full", "delta", "cached", "stale")


def window_case(data: dict, n_ids: int, seed: int):
    """(w, ids[S, 1, B], the WindowSteps) of one window of `n_ids` ids at
    full width, S = WINDOW_K: a short window's tail filled with the zero
    sentinel row, as core/worker.py's compute_local_window fills it."""
    rng = np.random.default_rng(seed)
    steps = min(-(-n_ids // B), WINDOW_K)
    ids = np.full(steps * B, WINDOW_ROWS, dtype=np.int64)  # the sentinel row
    ids[:n_ids] = rng.choice(WINDOW_ROWS, size=n_ids, replace=False)
    w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
    model = make_model("hinge", LAM, D, dim_sparsity=data["ds"], device="cuda")
    steps_ = psync.WindowSteps(model, data["indices"], data["values"], data["labels_f32"],
                               RPC_LR)
    return w, torch.from_numpy(ids.reshape(steps, 1, B)).cuda(), steps_


def check_window_kernel() -> dict:
    """The K-step window (sync_epoch in the sum mode: K = 1, grad_divisor
    1, n_total_workers 1, sgd) against its plain version at full width
    (hinge, dim_sparsity, S = 4), for a full window and a short one (330
    ids: 3 full steps and a tail of 30), each within WINDOW_ATOL and
    bitwise identical over SE_REPEATS launches; times the full window.
    Returns the summary row."""
    ds = rcv1_like(WINDOW_ROWS, n_features=D, nnz=P, seed=41, idf_values=True)
    zero = Dataset(np.zeros((1, P), np.int32), np.zeros((1, P), np.float32),
                   np.zeros(1, np.int32), D)
    data = on_card(Dataset(np.concatenate([ds.indices, zero.indices]),
                           np.concatenate([ds.values, zero.values]),
                           np.concatenate([ds.labels, zero.labels]), D))
    data["ds"] = dim_sparsity(ds)
    max_err = 0.0
    for label, n_ids in (("full", WINDOW_K * B), ("short", 330)):
        w, ids, window = window_case(data, n_ids, seed=n_ids)
        assert window.fused, "the window at D=47,236 must take the one-launch route"
        reset_counts()
        got, _ = window.run(w, ids)
        launches = se.sync_epoch.launches
        m = window.model
        want = se.sync_epoch_plain(w, ids, window.indices, window.values, window.labels_f32,
                                   coeff_kind=m.coeff_kind, reg_kind=m.reg_kind, lam=m.lam,
                                   dim_sparsity=m.dim_sparsity, lr=RPC_LR, n_total_workers=1,
                                   grad_divisor=1)
        outs = {digest(window.run(w, ids)[0]) for _ in range(SE_REPEATS)}
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        moved = float((want - w).abs().max())
        print(f"window {label} ({n_ids} ids, {ids.shape[0]} steps): max_abs_err={err:.3e} "
              f"weights moved {moved:.3e}; {launches} launch; {len(outs)} distinct output(s) "
              f"of {SE_REPEATS} launches", flush=True)
        if not err <= WINDOW_ATOL or launches != 1 or len(outs) != 1:
            raise AssertionError(f"window {label}: max abs err {err} (atol {WINDOW_ATOL}), "
                                 f"{launches} launches (want 1), {len(outs)} distinct outputs")
        max_err = max(max_err, err)

    w, ids, window = window_case(data, WINDOW_K * B, seed=7)
    m = window.model
    kernel = lambda: window.run(w, ids)  # noqa: E731
    plain = lambda: se.sync_epoch_plain(  # noqa: E731
        w, ids, window.indices, window.values, window.labels_f32, coeff_kind=m.coeff_kind,
        reg_kind=m.reg_kind, lam=m.lam, dim_sparsity=m.dim_sparsity, lr=RPC_LR,
        n_total_workers=1, grad_divisor=1)
    plain_ms = [time_ms(plain, iters=20, warmup=2)]
    kernel_ms = [time_ms(kernel, iters=100, warmup=10), time_ms(kernel, iters=100, warmup=10)]
    plain_ms.append(time_ms(plain, iters=20, warmup=2))
    flat = ids.flatten().cpu().numpy()
    row_nnz = (ds.values != 0).sum(axis=1)
    # each sampled row read once (ids, values, label), the ids, w and
    # dim_sparsity in, w out
    bytes_moved = len(np.unique(flat)) * (8 * P + 4) + flat.nbytes + 3 * 4 * D
    # per sampled row: the margin and the scatter, a mul and an add per
    # nonzero; per step and feature: the masked regularizer add, the
    # update and the w . dim_sparsity partial
    flops = 4 * int(row_nnz[flat].sum()) + WINDOW_K * D * 6
    bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = flops / F32_FLOPS * 1e3
    row = {
        "name": "sync_epoch (window, sum mode)", "route": "cuda",
        "source": "distributed_sgd_tpu_torch/csrc/sync_epoch.cu", "replaces": TPU_KERNEL,
        "launches": None, "max_abs_err": max_err,
        "ms": min(kernel_ms), "plain_ms": min(plain_ms),
        "bound_ms": max(bound_bytes_ms, bound_ops_ms),
        "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
        # no single PyTorch call runs the steps of a window
        "library_ms": None,
    }
    print(f"window kernel (S={WINDOW_K}, B={B}, full width): "
          f"{min(kernel_ms) * 1e3:.2f} us a launch (runs {[round(t * 1e3, 2) for t in kernel_ms]}),"
          f" plain {min(plain_ms) * 1e3:.2f} us; bound {row['bound_ms'] * 1e3:.4f} us "
          f"({bytes_moved} B over {HBM_BYTES_PER_S:.3g} B/s, {flops} f32 operations); "
          f"{card_line()}", flush=True)
    return row


def bcast_counts(m: Metrics) -> dict:
    return {k: m.counter(f"master.sync.bcast.{k}").value for k in BCAST_COUNTERS}


def check_levers_ran(m: Metrics, epochs: int, label: str) -> None:
    """Fails unless every lever of PIPE_LEVERS acted in a fit of `epochs`
    epochs with no retry: each request went out on a stream (none replayed
    over unary), the broadcasts after each worker's first were sparse
    deltas, every round but an epoch's first was dispatched pre-staged,
    and the fan-in lanes summed every reply."""
    from distributed_sgd_tpu_torch.utils import metrics as mm

    windows = m.counter(mm.SYNC_ROUNDS).value
    got = {name: m.counter(name).value for name in (
        mm.STREAM_SENDS, mm.STREAM_FALLBACK, mm.SYNC_BCAST_DELTA, mm.SYNC_BCAST_FULL,
        mm.STAGE_HITS, mm.STAGE_DISCARDS, mm.FANIN_PARSED)}
    want = {mm.STREAM_SENDS: RPC_WORKERS * windows, mm.STREAM_FALLBACK: 0,
            mm.STAGE_HITS: windows - epochs, mm.STAGE_DISCARDS: 0,
            mm.FANIN_PARSED: RPC_WORKERS * windows}
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if not got[mm.SYNC_BCAST_DELTA] > 0:
        bad[mm.SYNC_BCAST_DELTA] = (got[mm.SYNC_BCAST_DELTA], "> 0")
    print(f"{label}: the levers acted in {windows} windows: {got}", flush=True)
    if bad:
        raise AssertionError(f"{label}: a lever did not act (counter: (got, want)): {bad}")


def check_levers_at_k1(full: dict) -> None:
    """The full-width RPC fit of phase 8 (3 workers in one process, lr 0.5,
    1 epoch, every lever off) run again with delta broadcasts, streams, 2
    fan-in lanes and a stage pool of 2: bitwise the same weights."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    train, test, model = full["data"]
    m = Metrics()
    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=m) as c:
        t0 = time.perf_counter()
        fit = c.master.fit_sync(1, B, RPC_LR, **PIPE_LEVERS)
        fit_s = time.perf_counter() - t0
    counts = bcast_counts(m)
    same = np.array_equal(np.asarray(fit.weights), full["weights"])
    windows = m.counter("master.sync.rounds").value
    print(f"levers at K=1 (delta, stream, 2 lanes, stage pool 2; full width, 1 epoch): "
          f"{windows} windows in {fit_s:.2f} s = {windows / fit_s:.1f} windows/s; weights "
          f"bitwise equal to the knobs-off fit's: {same}; broadcast bytes an epoch "
          f"{counts['bytes']} (knobs off {full['bcast_bytes']}); master.sync.bcast: {counts}; "
          f"stream sends {m.counter('master.sync.stream.sends').value}, fallbacks "
          f"{m.counter('master.sync.stream.fallback').value}; stage hits "
          f"{m.counter('master.sync.stage.hits').value}; {card_line()}", flush=True)
    if not same:
        err = float(np.abs(np.asarray(fit.weights) - full["weights"]).max())
        raise AssertionError(f"levers at K=1: the weights differ from the knobs-off fit's "
                             f"(max abs diff {err:.3e})")
    check_levers_ran(m, 1, "levers at K=1")


def check_local_steps_fit(full: dict) -> dict:
    """DSGD_LOCAL_STEPS=4 with every lever on, full width, 2 epochs: the
    rounds an epoch are ceil(part / 400), each round one sync_epoch launch a
    worker and no worker_grads; test accuracy >= 0.70; windows/s and the
    parts of a window; then one epoch under torch.profiler for the busy
    share.  Returns the sync_epoch launches of the 2-epoch fit."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    train, test, model = full["data"]
    part = -(-len(train) // RPC_WORKERS)
    rounds_want = WINDOW_FIT_EPOCHS * -(-part // (B * WINDOW_K))
    m = Metrics()
    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=m) as c:
        reset_counts()
        t0 = time.perf_counter()
        fit = c.master.fit_sync(WINDOW_FIT_EPOCHS, B, RPC_LR, local_steps=WINDOW_K,
                                **PIPE_LEVERS)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches, wg_launches = se.sync_epoch.launches, wg.worker_grads.launches
        steps = se.sync_epoch.steps
    rounds = m.counter("master.sync.rounds").value
    parts = {label: m.histogram(name).mean * 1e3 for label, name in RPC_PART_HISTS}
    epoch_s = sum(fit.epoch_seconds)
    print(f"local steps K={WINDOW_K}, every lever on (full width, {WINDOW_FIT_EPOCHS} epochs): "
          f"{rounds} rounds (want {rounds_want}) in {epoch_s:.3f} s of epochs = "
          f"{rounds / epoch_s:.1f} windows/s ({fit_s:.2f} s with evaluation); sync_epoch "
          f"launches {launches} ({steps} steps), worker_grads launches {wg_launches}; test "
          f"losses {fit.test_losses} accuracies {fit.test_accuracies}; broadcast "
          f"{bcast_counts(m)}; {card_line()}", flush=True)
    print("local steps ms a window: " + json.dumps({k: round(v, 4) for k, v in parts.items()}),
          flush=True)
    if rounds != rounds_want or launches != RPC_WORKERS * rounds or wg_launches != 0:
        raise AssertionError(f"local steps: {rounds} rounds (want {rounds_want}), {launches} "
                             f"sync_epoch launches (want {RPC_WORKERS * rounds}), "
                             f"{wg_launches} worker_grads (want 0)")
    if fit.test_accuracies[-1] < RPC_ACC_FLOOR or not np.isfinite(fit.weights).all():
        raise AssertionError(f"local steps: test accuracy {fit.test_accuracies[-1]} "
                             f"(want >= {RPC_ACC_FLOOR}) or weights not finite")
    check_levers_ran(m, WINDOW_FIT_EPOCHS, f"local steps K={WINDOW_K}")

    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0) as c:
        dev = device_events(lambda: c.master.fit_sync(1, B, RPC_LR, local_steps=WINDOW_K,
                                                      **PIPE_LEVERS))
    kernels = [(a, b) for a, b, name in dev if "sync_epoch" in name]
    if kernels:
        lo, hi = kernels[0][0], kernels[-1][1]
        busy = union_us(dev, lo, hi)
        kernel_us = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in kernels)
        print(f"local steps device busy share over one profiled epoch ({(hi - lo) / 1e3:.1f} ms "
              f"from its first window kernel to its last): {busy / (hi - lo):.4f}; "
              f"{len(kernels)} sync_epoch kernels {kernel_us / 1e3:.1f} ms, other device work "
              f"{(busy - kernel_us) / 1e3:.1f} ms", flush=True)
    else:
        print(f"local steps device busy share: not measured (the trace holds {len(dev)} device "
              f"events and no sync_epoch kernel)", flush=True)
    return launches


def check_row_store_cli(tmp: str) -> dict:
    """``python -m distributed_sgd_tpu_torch`` as a master (DSGD_SYNTHETIC)
    and RPC_WORKERS workers that map a row store built from the same rows,
    each with DSGD_HOST_INDEX (+ DSGD_HOST_OVERPROVISION) and every lever on
    (DSGD_LOCAL_STEPS=4), started one after another so that registration
    order is host order: each worker holds its third of the train rows and
    its margin; after the master's first epoch the last worker leaves
    (SIGTERM), the survivors' next windows fall outside their slices and
    each reload reads only the rows it did not hold; all exit 0."""
    import re
    import socket

    from distributed_sgd_tpu_torch.data.row_store import build_row_store

    data = rcv1_like(PIPE_CLI_ROWS, seed=0, idf_values=True)  # the CLI's synthetic rows
    train, _ = train_test_split(data)
    store = os.path.join(tmp, "rows.bin")
    t0 = time.perf_counter()
    build_row_store(data, store, train_rows=len(train), dim_sparsity=dim_sparsity(train))
    print(f"row store: {PIPE_CLI_ROWS} rows, {os.path.getsize(store)} B, built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = {**os.environ, **PIPE_ENV, "DSGD_LOCAL_STEPS": str(WINDOW_K),
            "DSGD_NODE_COUNT": str(RPC_WORKERS), "DSGD_MAX_EPOCHS": str(PIPE_CLI_EPOCHS),
            "DSGD_PATIENCE": "1000", "DSGD_MASTER_HOST": "127.0.0.1",
            "DSGD_MASTER_PORT": str(port), "DSGD_NODE_HOST": "127.0.0.1"}
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "distributed_sgd_tpu_torch"]
    master_env = {**base, "DSGD_SYNTHETIC": str(PIPE_CLI_ROWS), "DSGD_NODE_PORT": str(port)}
    lines: list = []
    left_at: list = []
    registered = threading.Event()

    def read(i, proc):
        # the master splits the rows in registration order, so the
        # workers start one after another, each once the last registered
        for line in proc.stdout:
            lines[i].append(line)
            if i and "registered with master" in line:
                registered.set()
            if i == 0 and "epoch 0:" in line and not left_at:
                left_at.append(time.perf_counter() - t0)
                procs[-1].send_signal(signal.SIGTERM)  # the last worker leaves

    procs, readers = [], []

    def start(env):
        procs.append(subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        lines.append([])
        readers.append(threading.Thread(target=read, args=(len(procs) - 1, procs[-1]),
                                        daemon=True))
        readers[-1].start()

    t0 = time.perf_counter()
    try:
        start(master_env)
        for i in range(RPC_WORKERS):
            registered.clear()
            start({**base, "DSGD_NODE_PORT": "0", "DSGD_ROW_STORE": store,
                   "DSGD_HOST_INDEX": str(i),
                   "DSGD_HOST_OVERPROVISION": str(PIPE_CLI_OVERPROVISION)})
            if not registered.wait(timeout=180):
                raise AssertionError(f"row-store CLI: worker {i} did not register")
        procs[0].wait(timeout=600)
        for p in procs[1:]:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs[1:]:
            p.wait(timeout=120)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r in readers:
        r.join(timeout=30)
    outs = ["".join(x) for x in lines]
    master_lines = lines[0]
    cli_s = time.perf_counter() - t0
    codes = [p.returncode for p in procs]
    slices = [re.findall(r"rows \[(\d+), (\d+)\) resident", o or "") for o in outs[1:]]
    reloads = [re.findall(r"re-sharded: \[(\d+), (\d+)\) -> \[(\d+), (\d+)\), (\d+) row",
                          o or "") for o in outs[1:]]
    held = [int(s[0][1]) - int(s[0][0]) if s else None for s in slices]
    read = [sum(int(r[4]) for r in rs) for rs in reloads]
    epochs = [line.split(" - ", 1)[-1].strip() for line in master_lines if "epoch " in line
              and "test_acc" in line]
    print(f"row-store CLI: master and {RPC_WORKERS} workers exited {codes} after {cli_s:.1f} s; "
          f"the last worker left at {left_at[0] if left_at else float('nan'):.1f} s; rows held "
          f"{held} of {len(train)} train rows (a third is {-(-len(train) // RPC_WORKERS)}, margin "
          f"{PIPE_CLI_OVERPROVISION}); reloads {[len(r) for r in reloads]} reading {read} rows "
          f"({reloads}); master {epochs[-1] if epochs else 'logged no epoch'}", flush=True)
    if codes != [0] * len(procs) or not left_at or len(epochs) != PIPE_CLI_EPOCHS:
        tails = "\n".join(f"== process {i} ({c}):\n{(o or '')[-3000:]}"
                           for i, (c, o) in enumerate(zip(codes, outs)))
        raise AssertionError(f"row-store CLI run failed:\n{tails}")
    third = -(-len(train) // RPC_WORKERS)
    margin = int(np.ceil(PIPE_CLI_OVERPROVISION * third))
    if any(h is None or not third <= h <= third + 2 * margin for h in held):
        raise AssertionError(f"row-store CLI: workers hold {held} rows, want a third "
                             f"({third}) plus at most {2 * margin}")
    survivors = reloads[:-1]

    def delta(r):  # the rows of the new slice that the old one did not hold
        old_lo, old_hi, new_lo, new_hi = (int(x) for x in r[:4])
        return (new_hi - new_lo) - max(0, min(old_hi, new_hi) - max(old_lo, new_lo))

    if not any(survivors) or any(int(r[4]) != delta(r) for rs in survivors for r in rs):
        raise AssertionError(f"row-store CLI: each of the survivors' reloads {survivors} must "
                             f"read exactly the rows it did not hold "
                             f"({[[delta(r) for r in rs] for rs in survivors]})")
    return {"held": held, "reload_rows": read}


def run_pipeline_phase(full: dict) -> dict:
    """Phase 11; returns the window kernel's summary row with its launches."""
    t0 = time.perf_counter()
    row = check_window_kernel()
    check_levers_at_k1(full)
    row["launches"] = check_local_steps_fit(full)
    row["path"] = (f"rpc K={WINDOW_K} local steps, every lever on (full width, "
                   f"{WINDOW_FIT_EPOCHS} epochs): one launch a worker a round")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-pipe-") as tmp:
        check_row_store_cli(tmp)
    print(f"pipeline phase seconds: {time.perf_counter() - t0:.1f}", flush=True)
    return row


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
    check_sync_epoch_repeats(main_data)
    del train, main_data

    phase("4 engines on the card against the CPU")
    check_engine()
    check_async_engines()
    check_opt_engines()

    phase("5 sync paths: main path and per-step path")
    se_row["launches"] = run_main_path()
    se_row["path"] = "main"
    opt_rows["adam"]["launches"] = run_main_path_optimizer("adam")
    per_step_launches = run_per_step_path()
    momentum_launches = run_per_step_path("momentum")
    busy_share()

    phase("6 async paths: Hogwild and local SGD")
    run_async_paths(mean_row, opt_rows)

    phase("7 checkpoints, resume and the profile")
    run_checkpoint_phase()

    phase("8 the RPC engine: a master and workers over gRPC")
    rpc_full = run_rpc_phase()
    wg_row["launches"] = rpc_full["launches"]
    wg_row["path"] = (f"rpc (K=1 a reply, {RPC_WORKERS} workers); 0 launches on the mesh main "
                      f"path; {per_step_launches} on the per-step path (K={PER_STEP_WORKERS}), "
                      f"{momentum_launches} more with momentum")

    phase("9 the async fit over RPC: Hogwild gossip between worker nodes")
    rpc_async_launches = run_async_rpc_phase()
    mean_row["path"] = (f"async rpc (k={HOGWILD_K}, one launch a dispatch, full width) "
                        f"{rpc_async_launches}; " + mean_row["path"])
    mean_row["launches"] = rpc_async_launches

    phase("10 fault tolerance over RPC: quorum and hedges, heartbeat, crash and resume, "
          "elastic membership")
    ft = run_fault_tolerance_phase()
    wg_row["path"] += (f"; phase 10 (100,000 rows): straggler fit under a quorum "
                       f"{ft['straggler']['launches']} ({ft['straggler']['hedges']} hedges, "
                       f"late bodies included), resumed fit's replayed windows "
                       f"{ft['crash_sgd']['replay_launches']} (sgd), "
                       f"{ft['crash_adam']['replay_launches']} (adam)")
    mean_row["path"] = (f"elastic async rpc (a leave and a join, 100,000 rows) "
                        f"{ft['elastic']['sync_epoch_launches']}; " + mean_row["path"])

    phase("11 the pipelined sync RPC engine: K-step windows, delta broadcasts, streams, "
          "fan-in lanes, the stage pool and worker-local rows")
    window_row = run_pipeline_phase(rpc_full)
    del rpc_full

    phase("12 summary")
    print(card)
    print(json.dumps({"kernels": [wg_row, se_row, mean_row, opt_rows["momentum"],
                                  opt_rows["adam"], window_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
