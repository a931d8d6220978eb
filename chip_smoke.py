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
   ``worker_grads`` (one launch a call) on each input of
   ``tools/worker_grads_routes.py`` ``check_cases`` (with K=2 over 17
   ranges a worker, D=1 and a non-finite term) and 40
   launches on one input, bitwise identical (its fixed-order sum), timed
   at the RPC reply's shape (K=1) and at K=8; for
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
   cut to 6,250 rows); one local SGD round and one evaluation timed at
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
   budget with 0 launches, no worker thread left); a 2-epoch run of the
   main path's shape at 100,000 rows of ``python -m
   distributed_sgd_tpu_torch`` with DSGD_PROFILE_DIR, in a process of its
   own, whose trace holds one ``sync_epoch`` kernel; and
   the host times of a save and a restore (Hogwild's with and without a
   checkpointer is no longer run: a depth cut); then a local SGD fit run
   twice (100,000 rows; sgd, then adam), bitwise equal, and
   ``tools/sync_repeatability.py`` in a process of its own, one landing
   place for each optimizer (the two processes of their own run beside
   the phase's other checks, started after the host times);
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
   ``sync_epoch`` launch, each holding its kernel event (a third after a
   12 s gap, which checked nothing, is no longer run: a depth cut);
9. the async fit over RPC: ``main()`` with DSGD_ENGINE=rpc DSGD_ASYNC=1,
   a DevCluster of 3 workers on the card at full width (B=100, lr 0.5, 64
   steps a dispatch, 1 epoch's budget, early stop on), checking one
   ``sync_epoch`` launch in the mean mode a dispatch and no
   ``worker_grads``, the best weights' test accuracy >= 0.70, no async
   worker thread left and StopAsync at every worker, and printing
   updates/s, dispatches/s, the gossip sent and dropped and the stop
   reason; the same at 100,000 rows (its budget run out, early stop off)
   with momentum (lr 0.05), and with adam (lr 0.001) under
   torch.profiler for the device's busy share; and
   the CLI as one master and 3 workers in processes of their own with
   DSGD_ASYNC=1 (100,000 rows), all exiting 0 (run beside phase 8's
   traced CLI, its result printed there);
10. fault tolerance over RPC, nodes on the card at full width (B=100) on
   a 100,000-row slice: a quorum of 3 of 3 workers with no straggler,
   bitwise equal to the plain barrier (over the first 40,000 train rows,
   a depth cut); worker 0 sleeping 1.0 s in its
   first 20 Gradient bodies under a quorum of 2 with a 0.1 s soft
   deadline, 2 epochs (the loss falls, accuracy >= 0.70, rounds degrade, hedges
   are sent and win, the straggler stays a member, ``worker_grads``
   launches equal the bodies run, hedges and late ones included; the
   plain barrier's fit with it, for the windows/s and its launches
   against bodies while bodies are slow, is no longer run: a depth cut);
   the heartbeat (0.5 s, 3
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
   repeatable over 40 launches, timed beside its bound; phase 8's
   100,000-row fit again with delta broadcasts, streams, 2 fan-in lanes
   and a stage pool of 2, bitwise equal to it, with the broadcast bytes
   of both; DSGD_LOCAL_STEPS=4 with every lever on for 1 epoch at full
   width (ceil(part / 400) rounds an epoch, one launch a worker a round,
   no ``worker_grads``, accuracy >= 0.70, windows/s and a window's parts,
   and one epoch at 100,000 rows under torch.profiler for the busy
   share); and the CLI as one master and 3
   workers that map a row store built from the same synthetic rows in a
   temporary directory, each holding its third of the train rows and a
   10% margin, with every lever on: after the first epoch one worker
   leaves, each survivor reloads only the rows it did not hold, and all
   exit 0;
12. online serving, at full width on phase 5's weights (D = 47,236)
   saved as a ``<step>.npz``: a ``ServingServer`` with the weights on the
   card answers held-out rows of phase 5's test split (about 76 nonzeros
   a row) from 1 client and from 64 concurrent ones, each margin within
   1e-5 of a float64 numpy oracle and each prediction the model's wherever
   |margin| >= 1e-4, printing requests/s, p50/p99 latency and the mean
   flush size; one row in one bucket asked 50 times gives one margin; the
   forward's time a flush at buckets B=4 (one row) and B=64, P=128 (CUDA
   events); a checkpoint hot-swapped under 8 clients with no failed
   request; a full push then a delta push, the card's weights bitwise the
   numpy-applied delta; a ``ServingFleet`` of 2 replicas with the canary
   at 0.5 promoting the trained weights and rolling back the negated
   ones; and the CLI's ``DSGD_ROLE=serve`` (on the card) and
   ``DSGD_ROLE=route`` as processes, 200 requests through the router, then
   SIGTERM and both exit 0.  The path launches neither kernel;
13. the aggregation tree and the sharded master (3 workers, B=100, lr
   0.5, 1 epoch each): on phase 8's full-width data DSGD_AGG_TREE=fanout:2
   with DSGD_LOCAL_STEPS=4 (one ``sync_epoch`` sum launch a worker a
   round), accuracy >= 0.70; then on phase 8's 100,000 rows (depth cuts:
   the shard fits and the K=1 tree were once full width)
   DSGD_AGG_TREE=fanout:2, bitwise phase 8's knobs-off fit there (each
   tree fit with its busy share: the same fit over 25,000 rows under
   torch.profiler), DSGD_MASTER_SHARDS=2 (one
   ``worker_grads`` launch a worker a round for both lanes), and shards
   with the tree; each K=1 fit within 1e-5 of the knobs-off weights
   (printed: bitwise or not), no eviction, windows/s and a window's parts,
   the tree's and the lanes' counters and bytes, the launches; then at
   100,000 rows ``kill_shard(1)`` mid-fit: one flat round, one rebuild,
   no eviction and the flat fit's weights bit for bit;
14. the telemetry scrape and the rest of the model, BASELINE configs 3
   and 5: config 5 at full width (1,000,000 x 1,024 dense least squares
   made as benches/baseline_configs.py makes it, in a thread beside phase
   13's fits, 1 worker, B=256, lr 0.05,
   2 epochs: 3,125 steps an epoch, no ``sync_epoch`` or ``worker_grads``
   launch, a test MSE falling to <= 2e-4 and then rising by 1% at most,
   f32 matmul precision throughout, the epoch seconds and the kernel
   launches a step printed), then the same fit on its first 100,000 rows
   on the card and on the CPU from the same ids (weights within 1e-5
   relative); config 3 at full width on phase 5's rows (logistic, l2, 3
   workers, B=100, lr 0.5, 2 epochs: one ``sync_epoch`` launch an epoch,
   no ``worker_grads``, ``SyncTrainer.evaluate`` bitwise the fit's last
   test numbers, the test accuracy rising every epoch to >= 0.70, the
   objective printed);
   ``SyncTrainer.predict`` on phase 5's weights against float64 margins;
   a knobs-off RPC sync fit at 100,000 rows with the telemetry scrape (3
   snapshots, 0 errors, each worker's ``health.grad.norm`` its last
   reply's norm, ``slave.grad.compute`` its Gradient bodies, the cluster
   ``slave.sync.backward`` the sum, an HTTP GET of the exporter), the
   windows/s of the same fit at 25,000 rows with telemetry off and on in
   turns, split by part (a registry a node, the scrape, the health gauges),
   and the host time of one call of each part; ``flat_sparse`` on the card
   against the CPU;
15. the process group (torch.distributed): (a) the main path at full
   width for 1 epoch through the CLI inside an NCCL group of one rank
   (torchrun's environment), bitwise the fit without a group, one
   ``sync_epoch`` launch, the NCCL version printed; (b) two gloo ranks on
   the one card (tools/process_group_ranks.py, each with a limit of its
   own), each mapping phase 5's train rows written once as ``.npy`` files
   and binding its half host-local, K=3 workers a rank, B=100, lr 0.5, 1
   epoch on the per-step path: the ranks' weights bitwise equal,
   ``worker_grads`` launches = steps a rank and no ``sync_epoch``,
   accuracy >= 0.70, within 1e-5 after 100 steps of one process's K=6
   per-step fit driven by the same real rows for each worker and step and
   within 0.01 of its accuracy after the epoch, the epoch seconds and a
   step's µs split into ``worker_grads``, the all_reduce and the update
   (CUDA events); (c) ``HostMeshEngine`` on [cuda:0, cuda:0] over a
   worker's full-width rows: a Gradient body and a K=4 window within 1e-6
   relative of the flat worker's, 2 ``worker_grads`` launches a body; (d)
   the dp x tp engine at W=1 x F=2 on two gloo ranks at full width, the
   first third of an epoch (2,146 of 6,436 steps), no kernel, within 1e-5
   after 100 steps of the 1-D sync fit at one worker from the same ids and
   within 0.01 of its accuracy at the end, >= 0.70;
16. gradient compression and the training-health monitor: (a) ops/topk.py's
   selection on the card against the CPU on planted ties, a sparse delta
   with fewer nonzeros than k and one repeated magnitude (the index lists
   equal, and equal to torch.topk with its boundary repaired), one
   selection at D, k = 472 timed by CUDA events beside the repaired
   torch.topk and torch.topk alone, and a compressor's whole call; (b)
   Hogwild at full width with phase 6's settings (3 workers, 64 steps a
   dispatch) with compress none, topk (1%, EF) and qint8, each for one
   budget of 130,000 updates, checked every 10,000: one mean-mode ``sync_epoch``
   launch a dispatch, updates/s, the bytes on the wire against their dense
   equivalent, the best weights' accuracy >= 0.70, qint8's no more than
   0.02 below the uncompressed fit's and top-k's within 0.02 of the JAX
   engine's at the same settings (it settles ~0.05 below uncompressed
   there too); (c) the RPC sync fit at full width (1 epoch) with
   topk 1% + EF against phase 8's knobs-off fit: one ``worker_grads``
   launch a body, windows/s, the reply bytes, accuracy >= 0.70 and no more
   than 0.02 below, and at 100,000 rows the compressed fit on the card within 1e-5 of
   the same on the CPU; (d) DSGD_HEALTH_ACTION=halt on the RPC sync fit at
   100,000 rows with one NaN reply: the trip, the flight-*-health.json dump,
   the fit-state snapshot at the tripped window and the stop, then a
   restart that resumes from it and completes the epoch;
17. fault injection, the autopilot and the spin-up fast path: (a) the RPC
   sync fit at full width (3 workers, B=100, lr 0.5, quorum 2, a 0.4 s soft
   deadline, 2 s Gradient deadlines) over the first 162,000 train rows
   (540 windows), clear-sky and then under DSGD_CHAOS=scenario:flaky-rack:
   windows/s of both, the injected drops, delays and dups (each > 0), the
   degraded windows, hedges and late replies, no eviction, no plan left
   installed, and accuracy >= 0.70 and at most 0.02 below the clear-sky
   fit's; (b) the continual-learning flywheel (autopilot/) at the dev
   role's sizes but 4,096 features wide (8 nonzeros, a 4,096-row window, a
   12,288-row horizon, B=100, 2 workers, 2 replicas; the step shift moved
   from row 4,096 to 8,192 so that half the served rows precede it), its
   traffic from 32 clients at once, waiting for the detector's warm-up
   before it passes the shift:
   0 drops, 8,192 served, >= 1 retrain and promotion (a retrain that rolls
   back is followed by the residual rule's), state SERVING, the
   transitions with their times, the seconds from the shift to the
   promotion, no autopilot thread left; (c) spin-up: two fresh worker
   processes over 100,000 full-width rows with DSGD_COMPILE_CACHE on one
   empty directory (cold: 2 misses, both kernels built by nvcc; warm: 2
   hits, no nvcc), each timing its first Gradient reply from its start,
   then the same worker in this process with the setting unset (nothing
   written there), the three replies bitwise equal;
18. the text corpus: (a) the native RCV1 parser (data/_native/parser.cpp)
   built with g++ (its seconds and command printed), the phase failing
   unless the native route loaded; (b) after a check of the temporary
   directory's free disk, ``data/corpus.py`` writes the reference's corpus
   (seed 0: 804,414 rows, the 23,149-row train file and four test parts,
   47,236 features, the qrels with its last-topic-wins lines, ~0.96 GB),
   removed at the end; (c) on the train file the native parse at 1 thread
   and at the host's threads bitwise the python parse, and the native pack
   bitwise numpy's, lossless and at a width of 32 that truncates; (d)
   ``main()`` over the text files (DSGD_DATA_PATH, DSGD_FULL=1, 2 epochs,
   the CLI's defaults otherwise): 804,414 rows through 5 native parses and
   one pack, 2 ``sync_epoch`` launches, no ``worker_grads``, the test loss
   below 1.0 (its value at w = 0) after each epoch, the test losses and
   accuracies held to the card's to 7 digits (its 2nd epoch's loss rises
   with this draw, as the CPU's does given the same ids:
   ``tools/corpus_fit.py --witness``) and the accuracy above a floor set
   from the same run on the CPU (``--device cpu``); its data seconds
   printed beside the reference's 40 s gate, not gated; the phase's
   seconds against a 75 s budget, not gated;
19. a model's own coefficient and the examples: (a) the variants of both
   kernels for the custom-model example's ``SquaredHinge`` and for a
   ``SparseSVM`` subclass with a rule of its own (``ShiftedSVM``) built from
   the sources, every nvcc started together, their seconds and ptxas
   reports printed; (b) each ``SquaredHinge`` variant against its plain
   version at full width (643,531 rows x 47,236 features, B=100, P=76):
   ``worker_grads`` at K=1 and K=8 (RTOL, ATOL) and on a non-finite term,
   ``sync_epoch`` over 20 steps at K=3 (sgd, momentum, adam: w and the
   state) and at K=4 B=150 (two rounds a step, the kept coefficients), a
   64-step mean-mode dispatch, a K=4 sum window
   (SE_ATOL each) and a non-finite term, 40 launches one output on each
   route and a full epoch, each route timed against its plain version;
   (c) ``SquaredHinge`` through the engines from counts of 0: a full-width
   1-epoch sync fit (one variant launch, the test loss below 1.0, its
   value at w = 0), the per-step path (8 workers, one ``worker_grads``
   variant launch a step), at 20,000 rows the RPC fit (a variant launch a
   Gradient body), its K=4 window and Hogwild (the mean mode); (d) 20
   steps of ``ShiftedSVM`` within SE_ATOL of its plain version and away
   from hinge's kernel, and its 1-epoch engine fit away from
   ``SparseSVM``'s; (e) the six ``examples_torch`` mains on the card (the
   feature-sharded one starts 1 x 2 gloo ranks), each with its example's
   check; the phase's seconds against a 60 s budget, not gated;
20. summary: the card line, one JSON line of per-kernel numbers, and last
   ``{"ok": true, "device": {...}}``.

Without a CUDA device it exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import hashlib
import json
import math
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
from distributed_sgd_tpu_torch.core.loss_check import LossChecker
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer, profile_trace_path
from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity, train_test_split
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import SparseSVM, make_model
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import coeff as co
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
from distributed_sgd_tpu_torch.tools.worker_grads_routes import check_cases, main_path_batch
from distributed_sgd_tpu_torch.utils.metrics import (
    AUTOPILOT_PROMOTED,
    AUTOPILOT_ROLLED_BACK,
    Metrics,
    global_metrics,
)

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
LR_FOR = {co.HINGE: 0.5, co.LOGISTIC: 0.5, co.LEAST_SQUARES: 0.05}
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
# ptxas's report of the sync_epoch design that the redesign replaced (one
# cluster with pulled partials and rows held over the sweep), as nvcc built
# it on the H100 host (tools/sync_epoch_phases.py on that checkout)
REPLACED_SE_PTXAS = ("Used 64 registers, 72 bytes stack frame, 212 bytes spill stores, 140 bytes "
                     "spill loads")
# the one-step-a-dispatch run: 5,000 train rows, a 5,000-step budget (25,000
# rows, then 12,500, before depth cuts)
HOGWILD_K1_ROWS = 6250
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


def share_synthetic_rows() -> None:
    """From here on every in-process ``main()`` and ``build()`` of this run
    gets the synthetic rows of a DSGD_SYNTHETIC size from one generation:
    the rows it would generate from the same seed (804,414 rows take ~12 s
    a generation).  The CLI's own processes generate theirs."""
    cache = {}
    load = port_main.load_data

    def shared(cfg):
        n = os.environ.get("DSGD_SYNTHETIC")
        if not n:
            return load(cfg)
        key = (int(n), cfg.seed)
        if key not in cache:
            cache[key] = load(cfg)
        return cache[key]

    port_main.load_data = shared


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


def check_worker_grads() -> dict:
    """Kernel against plain version on every input of
    ``tools/worker_grads_routes.py`` ``check_cases`` (the main shape in each
    rule, edge shapes, K=2 over 17 ranges a worker, D=1 and a non-finite
    term), and 40 launches on one input bitwise identical (the
    fixed-order sum); times it at the RPC reply's shape (K=1, B=100) and at
    the per-step path's (K=8, B=100).  Returns the kernel's summary row,
    its time and bound at K=1."""
    rng = np.random.default_rng(0)
    max_err = 0.0
    for label, w_np, arrays, kind in check_cases():
        w = torch.from_numpy(w_np).cuda()
        args = [torch.from_numpy(a).cuda() for a in arrays]
        got = wg.worker_grads(w, *args, kind)
        want = wg.worker_grads_plain(w, *args, kind)
        same = all(torch.equal(got, wg.worker_grads(w, *args, kind))
                   for _ in range(WG_REPEATS - 1))
        torch.cuda.synchronize()
        # a non-finite term gives the plain version's inf at its feature
        # and leaves the finite entries to the tolerance
        fin = torch.isfinite(want)
        err = float((got[fin] - want[fin]).abs().max())
        ok = bool(((got[fin] - want[fin]).abs() <= ATOL + RTOL * want[fin].abs()).all()
                  and torch.equal(torch.isfinite(got), fin) and torch.equal(got[~fin], want[~fin]))
        print(f"worker_grads {label}: max_abs_err={err:.3e} nonzero={int((want != 0).sum())} "
              f"non-finite={int((~fin).sum())} bitwise identical over {WG_REPEATS} launches: "
              f"{same}", flush=True)
        if not ok or (label == "non-finite term") != bool((~fin).any()):
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
        args = [w] + [torch.from_numpy(a).cuda() for a in (idx, val, y)] + [co.HINGE]
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
            "bytes": bytes_moved, "flops": flops, "plan": wg.launch_plan(k, B, P, D)._asdict(),
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
        "design": "one launch a call: K x R blocks, each a range of its worker's 64-bit "
                  "integer sums in shared memory (it replaced three kernels and an HBM "
                  "accumulator)",
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
    kw = dict(coeff=kind, reg_kind=reg, lam=LAM, dim_sparsity=data["dim_sparsity"],
              lr=LR_FOR[kind] if lr is None else lr, n_total_workers=ids.shape[1])
    return args, kw


def sweep_edge_data(data: dict, n: int = 3000) -> tuple:
    """Data for the scatter's and the sweep's edges, on the card: `data`'s
    first n rows with feature 0 put into every row (every sample adds into
    one address a worker), and n rows of 8 entries over 300 features, the
    first id repeated in each row (a step updates few entries).  Feature
    0's value is 0.1, of the size of a row's values: at 0.5 the squared
    hinge's step at lr 0.1 over 300 rows multiplies the error in w[0] by
    about 4 a step, so 20 steps carry the plain version's f32 sums past
    SE_ATOL from the kernel's exact ones."""
    busy = {key: t[:n].clone() for key, t in data.items() if key != "dim_sparsity"}
    busy["indices"][:, 0] = 0
    busy["values"][:, 0] = 0.1
    busy["dim_sparsity"] = data.get("dim_sparsity")
    rng = np.random.default_rng(20)
    idx = rng.integers(0, 300, (n, 8)).astype(np.int32)
    idx[:, 1] = idx[:, 0]
    val = (rng.normal(size=(n, 8)) / np.sqrt(8)).astype(np.float32)
    few = on_card(Dataset(idx, val, rng.choice([-1, 1], n).astype(np.int32), D))
    return busy, few


def check_sweep_cases(label: str, full: dict, shape: tuple, launch_args,
                      flat=lambda out: out, steps: int = 20) -> float:
    """The edges of the redesigned step at `shape` (K, B), each against the
    plain version within SE_ATOL: one feature in every sampled row, rows
    over 300 features, duplicate ids, lr 0 and a negative lr (the sparse
    sgd sweep keeps an untouched entry only where lr is finite with its
    sign bit clear) and a NaN weight (one step: the same NaN entries as
    the plain version).  `launch_args(data, ids) -> (args, kw)`.  Returns the
    largest error."""
    rng = np.random.default_rng(21)
    busy, few = sweep_edge_data(full)
    k, b = shape
    n, n_full = busy["indices"].shape[0], full["indices"].shape[0]
    cases = [("one feature in every row", busy, rng.integers(0, n, (steps, k, b)), {}),
             ("rows over 300 features", few, rng.integers(0, n, (steps, k, b // 5)), {}),
             ("duplicate ids", few, rng.integers(0, 10, (steps, k, b)), {}),
             ("lr 0", full, rng.integers(0, n_full, (steps, k, b)), {"lr": 0.0}),
             ("lr -0.01", full, rng.integers(0, n_full, (steps, k, b)), {"lr": -0.01}),
             ("a NaN weight", full, rng.integers(0, n_full, (1, k, b)), {"nan": True})]
    # one step, the NaN on a feature no pad entry names: the plain version
    # multiplies pad entries (value 0) by their weight, where the kernel
    # skips them, so margins that read a NaN weight of a step before differ
    padded = torch.zeros(D, dtype=torch.bool, device=full["indices"].device)
    padded[full["indices"][full["values"] == 0].long()] = True
    nan_at = int(torch.nonzero(~padded).max())
    max_err = 0.0
    for case, data, ids, extra in cases:
        args, kw = launch_args(data, ids)
        kw.update({key: v for key, v in extra.items() if key == "lr"})
        if "nan" in extra:
            w0 = args[0].clone()
            w0[nan_at] = float("nan")
            args = (w0,) + tuple(args[1:])
        got = flat(se.sync_epoch(*args, **kw))
        want = flat(se.sync_epoch_plain(*args, **kw))
        torch.cuda.synchronize()
        nan = torch.isnan(want)
        err = float((got[~nan] - want[~nan]).abs().max()) if bool((~nan).any()) else 0.0
        same_nan = bool(torch.equal(torch.isnan(got), nan))
        print(f"sync_epoch {label} {case} (K={k} B={ids.shape[2]}): max_abs_err={err:.3e}, "
              f"NaN entries {int(nan.sum())} as the plain version's: {same_nan}", flush=True)
        if not (err <= SE_ATOL and same_nan) or ("nan" in extra) != bool(nan.any()):
            raise AssertionError(f"sync_epoch {label} {case}: max abs err {err} (atol "
                                 f"{SE_ATOL}), NaN entries as the plain version's: {same_nan}")
        max_err = max(max_err, err)
    return max_err


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
             for kind in co.COEFF_KINDS for reg in se.REG_KINDS]
    cases += [
        ("K=1 B=37", main_data, rng.integers(0, TRAIN_ROWS, (20, 1, 37)), co.HINGE,
         "dim_sparsity", None, None),
        ("S=1", main_data, rng.integers(0, TRAIN_ROWS, (1, K, B)), co.LOGISTIC, "l2",
         w_rand, None),
        ("S=0", main_data, rng.integers(0, TRAIN_ROWS, (0, K, B)), co.HINGE,
         "dim_sparsity", w_rand, None),
        # 10 rows, each about 30 times a step: least squares then moves each
        # margin by about 30 * lr * 2 / K of its residual, so lr 0.01 keeps
        # the iteration contracting instead of amplifying rounding
        ("duplicate ids kind=0", edge_card, rng.integers(0, 10, (20, K, B)), co.HINGE,
         "dim_sparsity", w_rand, None),
        ("duplicate ids kind=2", edge_card, rng.integers(0, 10, (20, K, B)),
         co.LEAST_SQUARES, "dim_sparsity", w_rand, 0.01),
        ("all-pad rows", edge_card, rng.choice(pad_rows, (20, K, B)), co.HINGE, "l2",
         w_rand, None),
        # more samples than the cluster holds at once (512): two rounds a step
        ("K=4 B=150", main_data, rng.integers(0, TRAIN_ROWS, (20, 4, 150)), co.HINGE,
         "dim_sparsity", w_rand, None),
        # rows wider than the 128 entries the lanes hold in registers
        ("P=200", on_card(edge_data(3000, 8, p=200)), rng.integers(0, 3000, (20, K, B)),
         co.LOGISTIC, "dim_sparsity", w_rand, None),
        ("P=1", on_card(edge_data(3000, 9, p=1)), rng.integers(0, 3000, (20, K, B)),
         co.HINGE, "none", w_rand, None),
    ]
    # a non-finite term: one value inf in a sampled row, one step from w = 0
    # (later steps would read the inf weight into margins, and the plain
    # version multiplies pad entries by it where the kernel skips them)
    inf_data = dict(edge_card, values=edge_card["values"].clone())
    inf_data["values"][1, 0] = float("inf")
    args, kw = sync_epoch_args(inf_data, np.array([[[1, 2, 4, 5]] * K]).reshape(1, K, 4),
                               co.HINGE, "l2")
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
    max_err = max(max_err, check_sweep_cases(
        "sync", main_data, (K, B),
        lambda data, ids: sync_epoch_args(data, ids, co.HINGE, "dim_sparsity", w_rand)))

    # one full epoch at the main path's shape: hinge, dim_sparsity, K=3
    # workers each drawing from its own third of the train rows
    sub = -(-TRAIN_ROWS // K)
    ids = (rng.integers(0, sub, (STEPS, K, B)) % np.minimum(sub, TRAIN_ROWS - np.arange(K) * sub)
           [:, None] + (np.arange(K) * sub)[:, None])
    args, kw = sync_epoch_args(main_data, ids, co.HINGE, "dim_sparsity")
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
        "design": "one cluster of 8 blocks, 64-bit integer sums in DSMEM; pushed partials, "
                  "the next rows loaded inside the split closing barrier, the sparse sgd "
                  "sweep, dim_sparsity in shared memory (bit for bit the design it replaced)",
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
        for kind in co.COEFF_KINDS:
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

    def mean_args(data, ids):
        args, kw = sync_epoch_args(data, ids, co.LOGISTIC, "dim_sparsity", w_rand)
        return args, dict(kw, grad_divisor=B)

    max_err = max(max_err, check_sweep_cases("mean mode", main_data, (1, B), mean_args))

    # one Hogwild dispatch at the full-width run's shape: hinge, dim_sparsity,
    # 64 steps of 100 ids drawn from one worker's third of the train rows
    ids = rng.integers(0, -(-TRAIN_ROWS // 3), (HOGWILD_K, 1, B))
    args, kw = sync_epoch_args(main_data, ids, co.HINGE, "dim_sparsity", lr=0.5)
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
                    args, kw = sync_epoch_args(main_data, ids, co.HINGE, reg, w0, lr=lr)
                    kw.update(optimizer=opt, grad_divisor=div)
                    max_err = max(max_err, hold_opt_launch(
                        f"{mode} reg={reg} from {start}", args, kw, state))

        # a full epoch at the main path's shape (hinge, dim_sparsity, K=3):
        # timed in turns with the sgd mode's kernel beside it; held by its
        # objective, as the sgd mode's full epoch is
        args, kw = sync_epoch_args(main_data, epoch_ids, co.HINGE, "dim_sparsity", lr=lr)
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
        args, kw = sync_epoch_args(main_data, ids, co.HINGE, "dim_sparsity", lr=lr)
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
        args, kw = sync_epoch_args(main_data, epoch_ids(), co.HINGE, "dim_sparsity",
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


def run_main_path():
    """The port's CLI run at full width; returns the sync_epoch launches,
    the fit's weights and SERVE_ROWS rows of its held-out test split (the
    serving phase's requests and probe)."""
    held = {}
    build = port_main.build

    def keep_test(cfg, device=None):
        train, test, model = build(cfg, device)
        held["test"] = Dataset(test.indices[:SERVE_ROWS].copy(), test.values[:SERVE_ROWS].copy(),
                               test.labels[:SERVE_ROWS].copy(), test.n_features)
        return train, test, model

    port_main.build = keep_test
    try:
        with cli_env(DSGD_SYNTHETIC=MAIN_ROWS, DSGD_MAX_EPOCHS=MAIN_EPOCHS):
            reset_counts()
            t0 = time.perf_counter()
            run = port_main.main()
            torch.cuda.synchronize()
            total_s = time.perf_counter() - t0
            launches, steps_run = se.sync_epoch.launches, se.sync_epoch.steps
            wg_launches = wg.worker_grads.launches
    finally:
        port_main.build = build
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
    return launches, w.detach().cpu().numpy(), held["test"]


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
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS):  # the main path's rows, generated once
        full = port_main.load_data(Config.from_env())
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
PROFILE_ROWS = 100000  # the DSGD_PROFILE_DIR run (80,000 train rows)


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


def start_process(tmp: str, label: str, cmd: list, env=None) -> dict:
    """`cmd` started from the checkout's root with its output in files
    under `tmp`, to run beside this process's checks; `finish_process`
    waits for it."""
    root = os.path.dirname(os.path.abspath(__file__))
    files = [open(os.path.join(tmp, f"{label}.{x}"), "w+") for x in ("out", "err")]
    proc = subprocess.Popen(cmd, cwd=root, env=env, stdout=files[0], stderr=files[1],
                            text=True)
    return {"proc": proc, "files": files, "t0": time.perf_counter()}


def finish_process(started: dict, timeout: float) -> subprocess.CompletedProcess:
    """Waits for a `start_process` (kills it past `timeout` seconds from its
    start) and returns its exit code and output; `seconds` is its run."""
    proc = started["proc"]
    try:
        proc.wait(timeout=max(1.0, started["t0"] + timeout - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    started["seconds"] = time.perf_counter() - started["t0"]
    texts = []
    for f in started["files"]:
        f.seek(0)
        texts.append(f.read())
        f.close()
    return subprocess.CompletedProcess(proc.args, proc.returncode, *texts)


def start_sync_repeatability(tmp: str) -> dict:
    return start_process(tmp, "sync_repeatability", [
        sys.executable, "-m", "distributed_sgd_tpu_torch.tools.sync_repeatability",
        "--runs", str(REPEAT_FITS), "--launches", str(SE_REPEATS)])


def check_sync_repeatability(started: dict) -> dict:
    """``python -m distributed_sgd_tpu_torch.tools.sync_repeatability`` in
    a process of its own (`start_sync_repeatability`): one landing place
    for each optimizer."""
    out = finish_process(started, timeout=600)
    print(f"sync_repeatability: {started['seconds']:.1f} s beside this process's checks",
          flush=True)
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


def start_profile_cli(tmp: str) -> dict:
    d = os.path.join(tmp, "profile")
    env = {**os.environ, "DSGD_SYNTHETIC": str(PROFILE_ROWS), "DSGD_MAX_EPOCHS": "2",
           "DSGD_PROFILE_DIR": d}
    return dict(start_process(tmp, "profile", [sys.executable, "-m", "distributed_sgd_tpu_torch"],
                              env=env), dir=d)


def check_profile(started: dict, train, test, model) -> dict:
    """``python -m distributed_sgd_tpu_torch`` with DSGD_PROFILE_DIR on a
    2-epoch run of the main path's shape at PROFILE_ROWS rows (`train` and
    `test` are those rows, not full width, to keep the smoke's time),
    in a process of its own as a user runs it (`start_profile_cli`; in
    this process the busy-share phases' torch.profiler sessions came
    first, and a later session can lose kernel records): the trace of
    epoch 1 holds exactly one sync_epoch kernel.  Its duration is printed
    beside the same two epochs run here, each timed by CUDA events (the id
    draw and the launch)."""
    d = started["dir"]
    cli = finish_process(started, timeout=600)
    cli_s = started["seconds"]
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
    print(f"profile: {files} in DSGD_PROFILE_DIR after a {cli_s:.1f} s CLI run (beside this "
          f"process's checks), {len(trace)} "
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


def run_checkpoint_phase() -> None:
    """Phase 7, on rows generated once (`rows_of`).  The profiled CLI run
    and sync_repeatability run in processes of their own beside the
    phase's other checks (one after the other before a depth cut), once
    the host-clock timings of the snapshots are taken."""
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    t0 = time.perf_counter()
    started = []
    try:
        out = {"checkpoint_ms": time_checkpoints(tmp)}
        started = [start_profile_cli(tmp), start_sync_repeatability(tmp)]
        with rows_of(MAIN_ROWS) as (train, test, model):
            print(f"checkpoint phase data seconds: {time.perf_counter() - t0:.2f}", flush=True)
            out["sync_sgd"] = check_sync_resume(train, test, model, tmp, "sgd")
            out["sync_adam"] = check_sync_resume(train, test, model, tmp, "adam")
            check_nothing_to_run(train, test, model, tmp)
            out["hogwild"] = check_async_resume("Hogwild", tmp, HOGWILD_K,
                                                DSGD_STEPS_PER_DISPATCH=HOGWILD_K)
            out["local_sgd"] = check_async_resume("local SGD", tmp, LOCAL_SGD_PERIOD,
                                                  DSGD_ASYNC_MODE="local_sgd",
                                                  DSGD_SYNC_PERIOD=LOCAL_SGD_PERIOD,
                                                  DSGD_CHECK_EVERY=LOCAL_SGD_CHECK_EVERY)
        repeats = {"local_sgd_twice": check_local_sgd_twice()}
        with rows_of(PROFILE_ROWS) as (train, test, model):
            out["profile"] = check_profile(started[0], train, test, model)
        print(json.dumps({"checkpoints": out}), flush=True)
        repeats["sync_repeatability"] = check_sync_repeatability(started[1])
        print(json.dumps({"repeats": repeats}), flush=True)
    finally:
        for st in started:
            if st["proc"].poll() is None:
                st["proc"].kill()
                st["proc"].wait()
            for f in st["files"]:
                f.close()
        shutil.rmtree(tmp)


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


def rpc_fit(model, train, test, metrics=None, profile: bool = False, **cluster_kw):
    """One epoch of the sync fit of a DevCluster of RPC_WORKERS workers on
    `model`'s device (with `cluster_kw`, e.g. a compressor); returns (fit,
    initial test loss, worker_grads and sync_epoch launches, device events
    or None)."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=metrics,
                    **cluster_kw) as c:
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
            "bcast_bytes": m.counter("master.sync.bcast.bytes").value,
            "grad_bytes": m.counter("master.sync.grad.bytes").value,
            "test_acc": fit.test_accuracies[0], "windows_per_s": windows / epoch_s}


def check_rpc_profiled(model, train, test, w: np.ndarray) -> None:
    """The fit that gave `w` run again under torch.profiler: the device's
    busy share, and bitwise the same weights."""
    again, _, _, dev = rpc_fit(model, train, test, profile=True)
    same = np.array_equal(np.asarray(again.weights), w)
    kernels = [(t0_, t1_) for t0_, t1_, name in dev if "worker_grads" in name]
    if dev:
        lo, hi = dev[0][0], max(t1_ for _, t1_, _ in dev)
        busy = union_us(dev, lo, hi)
        kernel_us = sum(t1_ - t0_ for t0_, t1_ in kernels)
        print(f"rpc device busy share over the profiled fit ({(hi - lo) / 1e3:.1f} ms from its "
              f"first device event to its last): {busy / (hi - lo):.4f}; worker_grads' "
              f"{len(kernels)} kernels (one a call) {kernel_us / 1e3:.1f} ms, other device work "
              f"{(busy - kernel_us) / 1e3:.1f} ms", flush=True)
    else:
        print("rpc device busy share: not measured (no device events in the trace)", flush=True)
    print(f"rpc: the same fit run again (under torch.profiler) gives bitwise equal weights: "
          f"{same} (max abs diff {float(np.abs(np.asarray(again.weights) - w).max()):.3e})",
          flush=True)
    if not same:
        raise AssertionError("rpc: two runs of one fit gave different weights")


def check_rpc_card_against_cpu() -> dict:
    """A RPC_SMALL_ROWS-row fit with the nodes on the card and again on the
    CPU: test losses rtol 1e-5, weights atol 1e-5; then the card's fit
    again under torch.profiler for the busy share, with bitwise the same
    weights.  (The profiled fit was once phase 8's full-width one: cut to
    these rows to keep the smoke's time.)  Returns the card fit's weights,
    broadcast bytes and data: the knobs-off reference of the checks that
    phases 11 and 13 run at these rows."""
    data = rcv1_like(RPC_SMALL_ROWS, seed=0, idf_values=True)
    train, test = train_test_split(data)
    ds = dim_sparsity(train)
    fits, models, m = {}, {}, Metrics()
    for dev in ("cuda", "cpu"):
        models[dev] = model = make_model("hinge", LAM, train.n_features, dim_sparsity=ds,
                                         device=dev)
        t0 = time.perf_counter()
        fits[dev] = rpc_fit(model, train, test, metrics=m if dev == "cuda" else None)[0]
        print(f"rpc {RPC_SMALL_ROWS}-row fit on {dev}: {time.perf_counter() - t0:.2f} s, test "
              f"loss {fits[dev].test_losses[0]:.7f}", flush=True)
        if dev == "cuda":
            check_rpc_profiled(model, train, test, np.asarray(fits[dev].weights))
    err = float(np.abs(np.asarray(fits["cuda"].weights) - np.asarray(fits["cpu"].weights)).max())
    print(f"rpc card against CPU: weights max_abs_err={err:.3e}", flush=True)
    if err > 1e-5 or not np.allclose(fits["cuda"].test_losses, fits["cpu"].test_losses,
                                     rtol=1e-5, atol=0):
        raise AssertionError("rpc: the fit on the card disagrees with the fit on the CPU")
    return {"weights": np.asarray(fits["cuda"].weights), "data": (train, test, models["cuda"]),
            "bcast_bytes": m.counter("master.sync.bcast.bytes").value,
            "test_loss": fits["cuda"].test_losses[0]}


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
    distributed_sgd_tpu_torch.tools.profiler_sessions --gap 0`` in a
    process of its own (here, a short session long after this process's
    first one holds no device event: the trace's kernel timestamps drift
    from the host's; the tool's third session after a 12 s gap, which
    shows it and checks nothing, is left out: a depth cut)."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run([sys.executable, "-m", "distributed_sgd_tpu_torch.tools.profiler_sessions",
                          "--gap", "0"], cwd=root, capture_output=True, text=True, timeout=300)
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    print(f"profiler sessions in one process: {lines[-1] if lines else out.stdout[-2000:]}",
          flush=True)
    if out.returncode != 0 or not lines:
        raise AssertionError(f"a torch.profiler session lost its kernel record "
                             f"({out.returncode}):\n{out.stdout[-2000:]}\n{out.stderr[-2000:]}")


def run_rpc_phase() -> dict:
    """Phase 8; returns check_rpc_full_width's dict, with phase 9's CLI run
    (``async_cli``), which runs beside this phase's traced CLI."""
    rpc_versions()
    full = check_rpc_full_width()
    full["small"] = check_rpc_card_against_cpu()
    async_cli = start_async_rpc_cli()
    try:
        check_rpc_cli()
    except BaseException:
        for p in async_cli["procs"]:
            p.kill()
            p.wait()
        raise
    full["async_cli"] = check_async_rpc_cli(async_cli)
    check_profiler_sessions()
    return full


# -- phase 9: the async fit over RPC ---------------------------------------------

ASYNC_RPC_SMALL_ROWS = 100000  # the momentum and adam (profiled) fits, the CLI run
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


def start_async_rpc_cli() -> dict:
    """``python -m distributed_sgd_tpu_torch`` as one master and
    RPC_WORKERS workers on loopback with DSGD_ASYNC=1 (HOGWILD_K steps a
    dispatch, ASYNC_RPC_SMALL_ROWS rows, 1 epoch's budget), started to run
    beside phase 8's traced CLI (after it, before a depth cut);
    `check_async_rpc_cli` waits for it."""
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
    return {"procs": procs, "t0": t0}


def check_async_rpc_cli(started: dict) -> dict:
    """`start_async_rpc_cli`'s run: all exit 0 and the master logs its test
    losses and its update count."""
    procs, t0 = started["procs"], started["t0"]
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
    print(f"async rpc CLI: master and {RPC_WORKERS} workers exited {codes} after {cli_s:.1f} s "
          f"(beside phase 8's traced CLI); "
          f"{done[-1] if done else 'no fit logged'}; {len(checks)} checks; "
          f"{losses[-1][:300] if losses else 'no test losses logged'}", flush=True)
    if codes != [0] * len(procs) or not losses or not done or not checks:
        tails = "\n".join(f"== process {i} ({c}):\n{(o or '')[-2000:]}"
                           for i, (c, o) in enumerate(zip(codes, outs)))
        raise AssertionError(f"async rpc CLI run failed:\n{tails}")
    return {"codes": codes, "seconds": cli_s, "checks": len(checks)}


def run_async_rpc_phase(cli: dict) -> int:
    """Phase 9 (`cli`: its CLI run, which phase 8 ran); returns the
    full-width sgd fit's sync_epoch launches."""
    t0 = time.perf_counter()
    out = {"cli": cli}
    # the sgd fit is not cut to ASYNC_RPC_SMALL_ROWS: there its early stop
    # ended it at 14,144 updates and test accuracy 0.6962, on the swings
    # the comment on ASYNC_RPC_SMALL_PATIENCE describes, and it is the one
    # fit of the phase that holds the early stop's best weights to a floor
    with rows_of(MAIN_ROWS) as (train, test, model):
        test_bound = SyncEngine(model, B, 0.0).bind(test)
        print(f"async rpc data seconds: {time.perf_counter() - t0:.2f}", flush=True)
        out["sgd"] = run_async_rpc("sgd (full width)", len(train), test_bound)
    with rows_of(ASYNC_RPC_SMALL_ROWS) as (train, test, model):
        test_bound = SyncEngine(model, B, 0.0).bind(test)
        small = dict(DSGD_PATIENCE=ASYNC_RPC_SMALL_PATIENCE)
        # the busy share is read over the adam fit (a separate sgd fit of
        # these rows before a depth cut), so the momentum fit's rates stay
        # comparable with earlier, unprofiled runs
        for kind in ("momentum", "adam"):
            profile = kind == "adam"
            out[kind] = run_async_rpc(
                f"{kind} ({ASYNC_RPC_SMALL_ROWS} rows{', profiled' if profile else ''})",
                len(train), test_bound, profile=profile, DSGD_OPTIMIZER=kind,
                DSGD_LEARNING_RATE=OPT_LR[kind], **small)
    print(json.dumps({"async_rpc": out}), flush=True)
    return out["sgd"]["launches"]


# -- phase 10: fault tolerance over RPC --------------------------------------------

FT_ROWS = 100000  # the slice phase 10 trains on (80,000 train rows)
FT_STRAGGLER_S, FT_STRAGGLER_CALLS = 1.0, 20  # worker 0's first 20 bodies sleep 1.0 s
FT_QUORUM, FT_SOFT_S = 2, 0.1  # 2 of 3; the soft deadline is about 6 healthy windows
# epochs of the straggler fit under the quorum: the test accuracy at 100,000
# rows is 0.683 after 1 and 0.709 after 2 (the plain barrier's, which a
# quorum whose hedges win lands on bit for bit).  The plain barrier's fit
# with the same straggler went as a depth cut (it ran 2 epochs, then 1):
# it gave the windows/s comparison (tools/rpc_sync_routes.py --straggler
# times both) and held launches equal to bodies under the plain barrier
# while bodies were slow, a check that went with it (the quorum fit here
# and phase 8's plain barrier without a straggler still hold it)
FT_STRAGGLER_EPOCHS = 2
# the full quorum's two fits train on the first 40,000 train rows: 134
# windows (the 80,000 before a depth cut)
FT_QUORUM_ROWS = 40000
FT_HEARTBEAT_S, FT_MAX_MISSES = 0.5, 3
FT_KILL_AT_WINDOW = 50  # the heartbeat run's victim dies after this many windows
# the crash comes 75 windows into an epoch of 267: one epoch (two before a
# depth cut) runs it, the resume and the rest of the epoch
FT_SNAPSHOT_EVERY, FT_CRASH_AT, FT_CRASH_EPOCHS = 25, 3, 1
FT_WATCH_S = 0.2  # the workers' master watch in the crash run
FT_CLI_SNAPSHOT_EVERY = 50


def ft_cluster(model, train, test, metrics, **kw):
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    return DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=metrics,
                      **kw)


def ft_parts(m: Metrics) -> dict:
    return {label: round(m.histogram(name).mean * 1e3, 4) for label, name in RPC_PART_HISTS}


def check_quorum_in_full(model, train, test) -> None:
    """A quorum of RPC_WORKERS over RPC_WORKERS workers and no straggler,
    over the windows of the first FT_QUORUM_ROWS train rows: the weights
    equal the plain barrier's bit for bit, no round degraded and no hedge
    sent."""
    from distributed_sgd_tpu_torch.autopilot import window_split
    from distributed_sgd_tpu_torch.utils import metrics as mm

    m = Metrics()
    split = window_split(0, FT_QUORUM_ROWS)
    with ft_cluster(model, train, test, m) as c:
        plain = c.master.fit_sync(1, B, RPC_LR, split=split)
        reset_counts()
        full = c.master.fit_sync(1, B, RPC_LR, quorum=RPC_WORKERS, split=split)
        launches = wg.worker_grads.launches
    diff = float(np.abs(np.asarray(full.weights) - np.asarray(plain.weights)).max())
    same = np.array_equal(np.asarray(full.weights), np.asarray(plain.weights))
    degraded, hedges = (m.counter(mm.QUORUM_DEGRADED).value, m.counter(mm.QUORUM_HEDGES).value)
    print(f"ft quorum {RPC_WORKERS} of {RPC_WORKERS} ({FT_QUORUM_ROWS:,} train rows of the "
          f"{FT_ROWS:,}-row slice, 1 epoch, sgd): weights "
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


def straggler_fit(model, train, test, epochs: int, **kw) -> dict:
    """`epochs` epochs with worker 0 slowed; returns the numbers, the
    windows/s of the first epoch (which holds every slow body) among them."""
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
        fit = c.master.fit_sync(epochs, B, RPC_LR, grad_timeout_s=60.0, **kw)
        fit_s = time.perf_counter() - t0
        straggler_member = (c.workers[0].host, c.workers[0].port) in c.master.members
        deadline = time.monotonic() + 30
        while slowed["slow_left"] and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(0.5)  # the late bodies return; the last counters settle
        launches = wg.worker_grads.launches
        out = {k: m.counter(v).value for k, v in names.items()}
    out.update(fit_s=fit_s, windows_per_s=out["windows"] / sum(fit.epoch_seconds),
               epoch0_windows_per_s=out["windows"] / epochs / fit.epoch_seconds[0],
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
    late bodies included)."""
    q = straggler_fit(model, train, test, FT_STRAGGLER_EPOCHS, quorum=FT_QUORUM,
                      straggler_soft_s=FT_SOFT_S)
    print("ft straggler, quorum: " + json.dumps(q), flush=True)
    print(f"ft straggler: the first epoch's windows/s {q['epoch0_windows_per_s']:.2f} under "
          f"the quorum; windows degraded with no straggler present: "
          f"{q.get('degraded_after_recovery')} of {q.get('windows_after_recovery')}", flush=True)
    if not (q["test_loss"] < loss0 and q["test_acc"] >= RPC_ACC_FLOOR):
        raise AssertionError(f"ft straggler: the quorum fit did not train: {q}")
    if not (q["degraded"] > 0 and q["hedges"] > 0 and q["hedge_wins"] > 0):
        raise AssertionError(f"ft straggler: no degraded round, hedge or hedge win: {q}")
    if not q["straggler_member"] or q["evictions"]:
        raise AssertionError("ft straggler: the straggler was evicted")
    if q["launches"] != q["bodies"]:
        raise AssertionError(f"ft straggler: {q['launches']} worker_grads launches for "
                             f"{q['bodies']} Gradient bodies")
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
    # one epoch (two before a depth cut): the kill comes at the first
    # snapshot, 50 windows in, and the new master resumes and ends the epoch
    base = {**os.environ, "DSGD_SYNTHETIC": str(FT_ROWS), "DSGD_MAX_EPOCHS": "1",
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
WINDOW_FIT_EPOCHS = 1
PIPE_CLI_ROWS = 100000  # the row-store CLI run (80,000 train rows)
PIPE_CLI_EPOCHS = 2  # the leave comes after epoch 0 (three epochs before a depth cut)
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
                                   coeff=m.coeff_kind, reg_kind=m.reg_kind, lam=m.lam,
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
        w, ids, window.indices, window.values, window.labels_f32, coeff=m.coeff_kind,
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
    """Phase 8's knobs-off RPC fit at RPC_SMALL_ROWS rows (3 workers in one
    process, lr 0.5, 1 epoch) run again with delta broadcasts, streams, 2
    fan-in lanes and a stage pool of 2: bitwise the same weights.  (These
    rows, not full width, keep the smoke's time.)"""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    full = full["small"]
    train, test, model = full["data"]
    m = Metrics()
    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=m) as c:
        t0 = time.perf_counter()
        fit = c.master.fit_sync(1, B, RPC_LR, **PIPE_LEVERS)
        fit_s = time.perf_counter() - t0
    counts = bcast_counts(m)
    same = np.array_equal(np.asarray(fit.weights), full["weights"])
    windows = m.counter("master.sync.rounds").value
    print(f"levers at K=1 (delta, stream, 2 lanes, stage pool 2; {RPC_SMALL_ROWS:,} rows, 1 "
          f"epoch): "
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
    """DSGD_LOCAL_STEPS=4 with every lever on, full width, WINDOW_FIT_EPOCHS
    epochs: the rounds an epoch are ceil(part / 400), each round one
    sync_epoch launch a worker and no worker_grads; test accuracy >= 0.70;
    windows/s and the parts of a window; then one epoch over phase 8's
    RPC_SMALL_ROWS rows under torch.profiler for the busy share.  Returns
    the sync_epoch launches of the full-width fit."""
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
    print(f"local steps K={WINDOW_K}, every lever on (full width, {WINDOW_FIT_EPOCHS} epoch(s)): "
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

    s_train, s_test, s_model = full["small"]["data"]
    with DevCluster(s_model, s_train, s_test, n_workers=RPC_WORKERS, seed=0) as c:
        dev = device_events(lambda: c.master.fit_sync(1, B, RPC_LR, local_steps=WINDOW_K,
                                                      **PIPE_LEVERS))
    kernels = [(a, b) for a, b, name in dev if "sync_epoch" in name]
    if kernels:
        lo, hi = kernels[0][0], kernels[-1][1]
        busy = union_us(dev, lo, hi)
        kernel_us = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in kernels)
        print(f"local steps device busy share over one profiled epoch at {RPC_SMALL_ROWS:,} rows "
              f"({(hi - lo) / 1e3:.1f} ms "
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
                   f"{WINDOW_FIT_EPOCHS} epoch(s)): one launch a worker a round")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-pipe-") as tmp:
        check_row_store_cli(tmp)
    print(f"pipeline phase seconds: {time.perf_counter() - t0:.1f}", flush=True)
    return row


SERVE_ROWS = 4096  # rows of the main path's test split kept for the serving phase
SERVE_STEP = MAIN_EPOCHS  # the checkpoint step the served weights are saved under
SERVE_ATOL = 1e-5  # a served margin against the float64 numpy oracle
SERVE_PRED_MARGIN = 1e-4  # predictions must agree where |margin| is at least this
SERVE_ONE_CLIENT = 400  # sequential requests of the one-client run
SERVE_CLIENTS, SERVE_PER_CLIENT = 64, 30
SERVE_REPEATS = 50  # one row asked again and again: one margin
SERVE_CLI_REQUESTS = 200
SERVE_PROBE_ROWS = 256
# the server's own histograms of a request's parts: the decode, the wait
# for its flush (window and execute), a flush's execute, the whole request
SERVE_PARTS = ("span.serve.predict.decode", "span.serve.predict.queue",
               "span.serve.batch.execute", "serve.predict.duration")


def serve_rows(test: Dataset, lo: int, hi: int):
    """(indices, values) request rows of the held-out split, pads stripped."""
    out = []
    for i in range(lo, hi):
        nz = test.values[i] != 0
        out.append((test.indices[i][nz].astype(np.int32), test.values[i][nz].astype(np.float32)))
    return out


def serve_oracle(rows, w: np.ndarray) -> np.ndarray:
    w64 = w.astype(np.float64)
    return np.array([np.dot(v.astype(np.float64), w64[i]) for i, v in rows])


def check_answers(label: str, replies, rows, w: np.ndarray, step: int) -> float:
    """Each answer's margin within SERVE_ATOL of the float64 oracle, its
    prediction the hinge model's (-sign) wherever |margin| >= 1e-4, its
    step `step`; returns the largest margin error."""
    margins = np.array([r.margin for r in replies], np.float64)
    preds = np.array([r.prediction for r in replies])
    err = float(np.max(np.abs(margins - serve_oracle(rows, w))))
    firm = np.abs(margins) >= SERVE_PRED_MARGIN
    steps = {r.model_step for r in replies}
    if err > SERVE_ATOL or not np.array_equal(preds[firm], -np.sign(margins[firm])) \
            or steps != {step}:
        raise AssertionError(f"serving, {label}: margin error {err} (limit {SERVE_ATOL}), "
                             f"{int((preds[firm] != -np.sign(margins[firm])).sum())} wrong "
                             f"predictions, steps {steps} (want {step})")
    return err


def parts_snapshot(m: Metrics) -> dict:
    return {n: (m.histogram(n).count, m.histogram(n).sum) for n in SERVE_PARTS}


def parts_line(m: Metrics, before: dict) -> str:
    """The server-side mean ms of each part since `before`."""
    out = []
    for n in SERVE_PARTS:
        count = m.histogram(n).count - before[n][0]
        secs = m.histogram(n).sum - before[n][1]
        out.append(f"{n.replace('span.', '')} {1e3 * secs / max(count, 1):.3f} ms")
    return "; server side, mean a request (a flush for execute): " + ", ".join(out)


def latency_line(label: str, lat_s, wall_s: float) -> str:
    lat_ms = np.asarray(lat_s) * 1e3
    return (f"{label}: {len(lat_ms) / wall_s:.1f} requests/s, p50 "
            f"{np.percentile(lat_ms, 50):.3f} ms, p99 {np.percentile(lat_ms, 99):.3f} ms "
            f"({len(lat_ms)} requests in {wall_s:.3f} s)")


def predict_all(port: int, rows, clients: int, per_client: int, order_seed: int):
    """`clients` threads, each with its own channel, send `per_client` rows
    each; returns (replies, rows asked, latencies, wall seconds)."""
    from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
    from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel

    rng = np.random.default_rng(order_seed)
    picks = rng.integers(0, len(rows), (clients, per_client))
    results = [[] for _ in range(clients)]
    errors = []
    start = threading.Barrier(clients + 1)

    def client(k):
        channel = new_channel("127.0.0.1", port)
        stub = ServeStub(channel)
        start.wait()
        try:
            for j in picks[k]:
                i, v = rows[j]
                t0 = time.perf_counter()
                reply = stub.Predict(pb.PredictRequest(indices=i, values=v), timeout=30)
                results[k].append((j, reply, time.perf_counter() - t0))
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)
        finally:
            channel.close()

    threads = [threading.Thread(target=client, args=(k,)) for k in range(clients)]
    for t in threads:
        t.start()
    start.wait()
    t0 = time.perf_counter()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"serving: {len(errors)} failed requests, first {errors[0]!r}")
    flat = [r for rs in results for r in rs]
    return ([r for _, r, _ in flat], [rows[j] for j, _, _ in flat], [t for _, _, t in flat],
            wall)


def serving_busy_share(port: int, rows) -> None:
    """The device's busy share under the 64-client load, from a burst
    (64 clients x 10 requests) under torch.profiler: the union of device
    events over the span from the first to the last."""
    box = {}
    dev = device_events(lambda: box.setdefault(
        "out", predict_all(port, rows, SERVE_CLIENTS, 10, 7)))
    if len(dev) < 2:
        print(f"serving busy share: not measured (the trace holds {len(dev)} device "
              f"events)", flush=True)
        return
    lo, hi = dev[0][0], max(t1 for _, t1, _ in dev)
    share = union_us(dev, lo, hi) / (hi - lo)
    print(f"serving busy share under {SERVE_CLIENTS} clients: {share:.4f} over "
          f"{hi - lo:.1f} us ({len(dev)} device events, {len(box['out'][0])} requests)",
          flush=True)


def time_forward(server, w_dev: torch.Tensor, rows, b: int) -> float:
    """Microseconds a flush of `b` rows spends in the forward at its bucket
    (P = 128 for these rows), from CUDA events over 200 launches."""
    from distributed_sgd_tpu_torch.serving.bucketing import pack_rows

    idx, val = pack_rows([r for r in rows if len(r[0]) > 64][:b])
    i_dev, v_dev = torch.from_numpy(idx).cuda(), torch.from_numpy(val).cuda()
    us = 1e3 * time_ms(lambda: server.engine.forward(w_dev, i_dev, v_dev))
    print(f"serving forward, a flush of {b} row(s) at bucket B={idx.shape[0]} "
          f"P={idx.shape[1]}: {us:.2f} us (CUDA events, 200 launches); moves "
          f"{3 * idx.size * 4 + 2 * idx.shape[0] * 4} bytes (indices, values and the "
          f"gathered weights read, predictions and margins written)", flush=True)
    return us


def check_serving_replica(w: np.ndarray, test: Dataset, tmp: str) -> None:
    """One ServingServer on the card over `w` saved as a <step>.npz:
    answers from 1 and 64 clients against the float64 oracle, one row in
    one bucket repeated, the forward's time, a hot swap mid-traffic, then
    a full and a delta push."""
    from distributed_sgd_tpu_torch.rpc import codec
    from distributed_sgd_tpu_torch.serving.push import WeightPusher
    from distributed_sgd_tpu_torch.serving.server import ServingServer

    ckpt = os.path.join(tmp, "replica")
    Checkpointer(ckpt).save(SERVE_STEP, w)
    m = Metrics()
    server = ServingServer(ckpt, port=0, host="127.0.0.1", ckpt_poll_s=0.1, metrics=m).start()
    try:
        step, w_dev = server.store.get()
        if step != SERVE_STEP or not w_dev.is_cuda or server.engine.device.type != "cuda" \
                or w_dev.cpu().numpy().tobytes() != w.tobytes():
            raise AssertionError(f"serving: step {step} on {w_dev.device}, engine on "
                                 f"{server.engine.device}: want step {SERVE_STEP} on the card")
        rows = serve_rows(test, 0, SERVE_ROWS)
        print(f"serving: D={w.shape[0]}, {len(rows)} held-out request rows, "
              f"{np.mean([len(i) for i, _ in rows]):.1f} nonzeros a row", flush=True)
        # one client, then 64
        before = parts_snapshot(m)
        replies, asked, lat, wall = predict_all(server.bound_port, rows, 1, SERVE_ONE_CLIENT, 1)
        err1 = check_answers("1 client", replies, asked, w, SERVE_STEP)
        print(latency_line("serving, 1 client", lat, wall) + f"; max margin error {err1:.3g}"
              + parts_line(m, before), flush=True)
        flushes0 = m.histogram("serve.batch.size").count
        before = parts_snapshot(m)
        replies, asked, lat, wall = predict_all(server.bound_port, rows, SERVE_CLIENTS,
                                                SERVE_PER_CLIENT, 2)
        err64 = check_answers(f"{SERVE_CLIENTS} clients", replies, asked, w, SERVE_STEP)
        hist = m.histogram("serve.batch.size")
        flushes = hist.count - flushes0
        print(latency_line(f"serving, {SERVE_CLIENTS} clients", lat, wall)
              + f"; max margin error {err64:.3g}; mean flush size "
              f"{len(replies) / flushes:.2f} rows over {flushes} flushes; largest flush "
              f"{hist.max:.0f}" + parts_line(m, before), flush=True)
        serving_busy_share(server.bound_port, rows)
        # one row in one bucket, asked again and again: one margin
        replies, _, _, _ = predict_all(server.bound_port, rows[:1], 1, SERVE_REPEATS, 3)
        seen = {r.margin for r in replies}
        if len(seen) != 1:
            raise AssertionError(f"serving: one row in one bucket gave {len(seen)} margins")
        print(f"serving: one row asked {SERVE_REPEATS} times, one margin {seen.pop()!r}; "
              f"serve.jit.compile {m.counter('serve.jit.compile').value} buckets used",
              flush=True)
        for b in (1, 64):
            time_forward(server, w_dev, rows, b)
        check_hot_swap(server, ckpt, w, rows)
        # a full push, then a delta: the card's weights are the numpy-applied delta
        rng = np.random.default_rng(17)
        w_full = (w * np.float32(0.5)).astype(np.float32)
        w_delta = w_full.copy()
        hit = rng.choice(w.shape[0], size=500, replace=False)
        w_delta[hit] = rng.normal(size=500).astype(np.float32)
        pusher = WeightPusher([("127.0.0.1", server.bound_port)], metrics=Metrics())
        try:
            acks = [pusher.push(10, w_full), pusher.push(11, w_delta)]
        finally:
            pusher.close()
        delta = codec.encode_weight_delta(w_delta, w_full, 10)
        want = codec.apply_weight_delta(w_full, delta)
        step, w_dev = server.store.get()
        got = w_dev.cpu().numpy()
        counts = (m.counter("serve.model.push.full").value,
                  m.counter("serve.model.push.delta").value)
        print(f"serving push: acks {acks}, step {step} on {w_dev.device}; full and delta "
              f"applied {counts}; card weights equal the numpy-applied delta: "
              f"{got.tobytes() == want.tobytes()}", flush=True)
        if acks != [1, 1] or step != 11 or not w_dev.is_cuda or counts != (1, 1) \
                or got.tobytes() != want.tobytes():
            raise AssertionError("serving push: the card does not hold the pushed delta")
        replies, asked, _, _ = predict_all(server.bound_port, rows[:64], 1, 64, 4)
        check_answers("after the delta push", replies, asked, want, 11)
    finally:
        server.stop()


def check_hot_swap(server, ckpt: str, w: np.ndarray, rows) -> None:
    """8 clients keep asking while a new checkpoint lands; no request
    fails, and once the store has swapped every answer carries the new
    step and the new weights' margin."""
    from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
    from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel

    w_new = (-w).astype(np.float32)
    stop, failures, steps = threading.Event(), [], set()

    def traffic(k):
        channel = new_channel("127.0.0.1", server.bound_port)
        stub = ServeStub(channel)
        i, v = rows[k]
        while not stop.is_set():
            try:
                steps.add(stub.Predict(pb.PredictRequest(indices=i, values=v),
                                       timeout=30).model_step)
            except Exception as e:  # noqa: BLE001 - raised below
                failures.append(e)
        channel.close()

    threads = [threading.Thread(target=traffic, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    t_save = time.perf_counter()
    Checkpointer(ckpt).save(SERVE_STEP + 1, w_new)
    deadline = time.time() + 30
    while time.time() < deadline and server.store.step != SERVE_STEP + 1:
        time.sleep(0.01)
    swap_s = time.perf_counter() - t_save
    time.sleep(0.3)
    stop.set()
    for t in threads:
        t.join()
    replies, asked, _, _ = predict_all(server.bound_port, rows[:256], 1, 256, 5)
    check_answers("after the hot swap", replies, asked, w_new, SERVE_STEP + 1)
    print(f"serving hot swap: steps answered under traffic {sorted(steps)}, "
          f"{len(failures)} failed; swapped {swap_s:.3f} s after the save (0.1 s poll)",
          flush=True)
    if failures or steps != {SERVE_STEP, SERVE_STEP + 1}:
        raise AssertionError(f"serving hot swap: {len(failures)} failed requests, steps "
                             f"{sorted(steps)}")


def check_serving_fleet(w: np.ndarray, test: Dataset, tmp: str) -> None:
    """A ServingFleet of 2 replicas on the card, the canary at 0.5, probed
    on held-out rows with their labels: the trained weights promote (the
    baseline), the negated ones roll back, a good next version promotes."""
    from distributed_sgd_tpu_torch.serving.fleet import ServingFleet
    from distributed_sgd_tpu_torch.serving.push import WeightPusher
    from distributed_sgd_tpu_torch.serving.router import probe_from_dataset
    from distributed_sgd_tpu_torch.utils import metrics as mm

    ckpt = os.path.join(tmp, "fleet")
    Checkpointer(ckpt).save(SERVE_STEP, w)
    probe_set = Dataset(test.indices[-SERVE_PROBE_ROWS:], test.values[-SERVE_PROBE_ROWS:],
                        test.labels[-SERVE_PROBE_ROWS:], test.n_features)
    m = Metrics()
    w_next = (w * np.float32(1.001)).astype(np.float32)
    with ServingFleet(ckpt, n_replicas=2, canary_fraction=0.5,
                      probe=probe_from_dataset(probe_set, n=SERVE_PROBE_ROWS),
                      health_s=0.2, ckpt_poll_s=30.0, metrics=m) as fleet:
        pusher = WeightPusher([("127.0.0.1", fleet.router_port)], metrics=Metrics())
        try:
            acks, losses = [], []
            for version, wv in ((5, w), (6, -w), (7, w_next)):
                acks.append(pusher.push(version, wv))
                losses.append(m.gauge(mm.ROUTER_CANARY_LOSS).value)
        finally:
            pusher.close()
        steps = [r.store.step for r in fleet.replicas]
        on_card = all(r.store.get()[1].is_cuda for r in fleet.replicas)
        served = all(r.store.get()[1].cpu().numpy().tobytes() == w_next.tobytes()
                     for r in fleet.replicas)
        counts = (m.counter(mm.ROUTER_CANARY_PROMOTED).value,
                  m.counter(mm.ROUTER_CANARY_ROLLBACK).value)
    print(f"serving fleet (2 replicas on the card, canary 0.5, {SERVE_PROBE_ROWS} probe "
          f"rows): acks {acks} for v5 (trained), v6 (negated), v7 (trained x 1.001); "
          f"promoted probe loss after each {losses}; promoted {counts[0]}, rolled back "
          f"{counts[1]}; replica steps {steps}", flush=True)
    if acks != [1, 0, 1] or counts != (2, 1) or steps != [7, 7] or not on_card or not served:
        raise AssertionError("serving fleet: the canary did not promote the trained weights "
                             "and roll back the negated ones")


def check_serving_cli(w: np.ndarray, test: Dataset, tmp: str) -> None:
    """``python -m distributed_sgd_tpu_torch`` as DSGD_ROLE=serve on the
    card and DSGD_ROLE=route over it, in processes of their own: 200
    requests through the router (and the replica's answers checked), then
    SIGTERM, and both exit 0."""
    import socket

    from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
    from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel

    ckpt = os.path.join(tmp, "cli")
    Checkpointer(ckpt).save(SERVE_STEP, w)
    ports = []
    for _ in range(2):
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            ports.append(sock.getsockname()[1])
    serve_port, route_port = ports
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "distributed_sgd_tpu_torch"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=root, env={**os.environ, **env}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for env in ({"DSGD_ROLE": "serve", "DSGD_CHECKPOINT_DIR": ckpt,
                          "DSGD_SERVE_PORT": str(serve_port)},
                         {"DSGD_ROLE": "route", "DSGD_SERVE_PORT": str(route_port),
                          "DSGD_SERVE_TARGETS": f"127.0.0.1:{serve_port}",
                          "DSGD_SERVE_HEALTH_S": "0.2"})]
    outs = [None, None]
    try:
        channel = new_channel("127.0.0.1", route_port)
        stub = ServeStub(channel)
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                if stub.ServeHealth(pb.Empty(), timeout=1).ok:
                    break
            except Exception:  # noqa: BLE001 - not up yet
                pass
            if any(p.poll() is not None for p in procs):
                break
            time.sleep(0.2)
        channel.close()
        up_s = time.perf_counter() - t0
        rows = serve_rows(test, 0, SERVE_CLI_REQUESTS)
        replies, asked, lat, wall = predict_all(route_port, rows, 1, SERVE_CLI_REQUESTS, 6)
        check_answers("the route role over the serve role", replies, asked, w, SERVE_STEP)
        print(latency_line("serving CLI, 1 client through the router", lat, wall)
              + f"; both roles up {up_s:.1f} s after their start", flush=True)
        for p in procs:
            p.send_signal(signal.SIGTERM)
        for k, p in enumerate(procs):
            outs[k], _ = p.communicate(timeout=60)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    codes = [p.returncode for p in procs]
    print(f"serving CLI: serve and route exited {codes} after {time.perf_counter() - t0:.1f} s",
          flush=True)
    if codes != [0, 0] or "device=cuda" not in outs[0]:
        tails = "\n".join(f"== {name} ({c}):\n{(o or '')[-2000:]}"
                          for name, c, o in zip(("serve", "route"), codes, outs))
        raise AssertionError(f"serving CLI run failed:\n{tails}")


def run_serving_phase(w: np.ndarray, test: Dataset) -> None:
    """Phase 12: the serving path at full width on the main path's weights.
    It launches no kernel of the port: the forward is torch ops."""
    t0 = time.perf_counter()
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-serve-") as tmp:
        check_serving_replica(w, test, tmp)
        check_serving_fleet(w, test, tmp)
        check_serving_cli(w, test, tmp)
    launches = (wg.worker_grads.launches, se.sync_epoch.launches)
    print(f"serving path launches: worker_grads {launches[0]}, sync_epoch {launches[1]}",
          flush=True)
    if launches != (0, 0):
        raise AssertionError(f"the serving path launched a training kernel: {launches}")
    print(f"serving phase seconds: {time.perf_counter() - t0:.1f}", flush=True)


# -- phase 13: the aggregation tree and the sharded master -------------------------

TREE_SPEC = "fanout:2"  # DSGD_AGG_TREE of the phase's tree fits
TREE_SHARDS = 2  # DSGD_MASTER_SHARDS of its sharded fits
TREE_ATOL = 1e-5  # a K=1 tree or sharded fit against the knobs-off fit
SHARD_KILL_ROWS = 100000  # the kill_shard fit (80,000 train rows)
# each configuration's profiled fit, for its busy share (50,000 before a depth cut)
TREE_BUSY_ROWS = 25000
SHARD_KILL_AT = 50  # windows run before the kill
TREE_FITS = (  # (label, fit_sync arguments): full-width fits
    (f"tree K={WINDOW_K}", dict(agg_tree=TREE_SPEC, local_steps=WINDOW_K)),
)
# fits on phase 8's RPC_SMALL_ROWS rows against its knobs-off fit there
# (full width until PR 13, which cut them in depth to keep the smoke's time)
SMALL_TREE_FITS = (
    (f"shards {TREE_SHARDS}", dict(master_shards=TREE_SHARDS)),
    (f"shards {TREE_SHARDS} + tree", dict(master_shards=TREE_SHARDS, agg_tree=TREE_SPEC)),
)


def tree_counts(m: Metrics) -> dict:
    """The tree's and the shards' counters of a fit's registry, with its
    bytes and evictions."""
    from distributed_sgd_tpu_torch.utils import metrics as mm

    names = (mm.AGG_CHILDREN, mm.AGG_BYTES_IN, mm.AGG_BYTES_UP, mm.AGG_PARTIAL, mm.AGG_FLAT,
             mm.TREE_PARTIAL, mm.TREE_FLAT_FALLBACK, mm.TREE_REBUILDS, mm.SHARD_ROUNDS,
             mm.SHARD_REBUILDS, mm.SHARD_FALLBACK_ROUNDS, mm.SHARD_BCAST_BYTES,
             mm.SHARD_GRAD_BYTES, mm.SHARD_ASSEMBLED, mm.SHARD_ASM_TIMEOUTS,
             mm.SYNC_BCAST_BYTES, mm.SYNC_GRAD_BYTES, mm.MASTER_EVICTIONS)
    out = {n: m.counter(n).value for n in names}
    gauges = {g.name: g.value for g in m.gauges()}
    out.update({n: gauges[n] for n in (mm.TREE_DEPTH, mm.TREE_EDGES, mm.SHARD_COUNT)
                if n in gauges})
    return out


def tree_busy_share(model, train, test, kw: dict) -> str:
    """One epoch of the fit with `kw` over `train` under torch.profiler:
    the device's busy share from its first kernel to its last."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0) as c:
        dev = device_events(lambda: c.master.fit_sync(1, B, RPC_LR, **kw))
    kernels = [(a, b) for a, b, name in dev if any(k in name for k in (
        "worker_grads", "sync_epoch"))]
    if not kernels:
        return (f"not measured (the trace holds {len(dev)} device events and no "
                f"worker_grads or sync_epoch kernel)")
    lo, hi = kernels[0][0], kernels[-1][1]
    return (f"{union_us(dev, lo, hi) / (hi - lo):.4f} over {(hi - lo) / 1e3:.1f} ms "
            f"({len(kernels)} kernels)")


def run_tree_fit(label: str, kw: dict, full: dict, small, acc_floor: float) -> dict:
    """One fit of phase 13 (3 workers, B=100, lr 0.5, 1 epoch) with `kw` on
    the data of `full` (phase 8's full-width fit, or its RPC_SMALL_ROWS
    one): windows/s and its parts, the counters and the lanes' bytes, the
    launches, the busy share (an epoch over the rows `small`,
    TREE_BUSY_ROWS of them, under the profiler; None: not measured) and
    the test numbers.  Checks its launches, finite weights, no eviction,
    that the tree or the shards acted, at K=1 that the weights are within
    TREE_ATOL of the knobs-off fit's, and accuracy >= `acc_floor` (0.70 at
    full width; one epoch over RPC_SMALL_ROWS rows reaches less, and there
    the caller holds the weights to the knobs-off fit's bit for bit)."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    train, test, model = full["data"]
    m = Metrics()
    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=m) as c:
        reset_counts()
        fit = c.master.fit_sync(1, B, RPC_LR, **kw)
        torch.cuda.synchronize()
        launches = (wg.worker_grads.launches, se.sync_epoch.launches)
        lanes = c.master._last_shard_bytes if kw.get("master_shards") else None
    counts = tree_counts(m)
    rounds = m.counter("master.sync.rounds").value
    epoch_s = fit.epoch_seconds[0]
    parts = {k: round(m.histogram(name).mean * 1e3, 4) for k, name in RPC_PART_HISTS}
    w = np.asarray(fit.weights)
    k = kw.get("local_steps", 1)
    err = float(np.abs(w - full["weights"]).max())
    bitwise = bool(np.array_equal(w, full["weights"]))
    busy = tree_busy_share(small[2], small[0], small[1], kw) if small else "not measured"
    print(f"phase 13 {label} {kw} ({len(train) + len(test):,} rows, {RPC_WORKERS} workers, B={B}, "
          f"lr {RPC_LR}, 1 "
          f"epoch): {rounds} windows in {epoch_s:.3f} s = {rounds / epoch_s:.1f} windows/s; "
          f"test loss {fit.test_losses[0]:.7f} accuracy {fit.test_accuracies[0]:.7f}; "
          f"worker_grads launches {launches[0]}, sync_epoch launches {launches[1]}; max |dw| "
          f"against the knobs-off fit {err:.3e}, bitwise {bitwise}; busy share "
          f"({TREE_BUSY_ROWS} rows, 1 epoch) {busy}; {card_line()}", flush=True)
    print(f"phase 13 {label} ms a window: {json.dumps(parts)}", flush=True)
    print(f"phase 13 {label} counters: {json.dumps(counts)}; lanes (index, broadcast bytes, "
          f"gradient bytes): {lanes}", flush=True)
    want = ((0, RPC_WORKERS * rounds) if k > 1 else (RPC_WORKERS * rounds, 0))
    bad = []
    if launches != want:
        bad.append(f"launches (worker_grads, sync_epoch) {launches}, want {want}")
    if fit.test_accuracies[0] < acc_floor or not np.isfinite(w).all():
        bad.append(f"test accuracy {fit.test_accuracies[0]} (want >= {acc_floor}) or "
                   f"weights not finite")
    if counts["master.evictions"] != 0:
        bad.append(f"{counts['master.evictions']} evictions")
    if kw.get("agg_tree") and counts["slave.agg.children"] == 0:
        bad.append("no child was reduced in the tree")
    if kw.get("master_shards") and counts["slave.shard.assembled"] != RPC_WORKERS * rounds:
        bad.append(f"{counts['slave.shard.assembled']} rendezvous, want one a worker a round "
                   f"({RPC_WORKERS * rounds})")
    if k == 1 and not err <= TREE_ATOL:
        bad.append(f"max |dw| {err:.3e} against the knobs-off fit, limit {TREE_ATOL}")
    if bad:
        raise AssertionError(f"phase 13 {label}: " + "; ".join(bad))
    return {"weights": w, "launches": launches, "rounds": rounds, "bitwise": bitwise}


def check_shard_kill(model, train, test) -> dict:
    """At SHARD_KILL_ROWS rows: a flat fit, then the sharded one with
    kill_shard(1) after SHARD_KILL_AT windows: it finishes with one flat
    fallback round, one rebuild over the survivor, no eviction, and the
    flat fit's weights bit for bit."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    m = Metrics()
    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=m) as c:
        flat = c.master.fit_sync(1, B, RPC_LR)
        r0 = m.counter("master.sync.rounds").value
        box = {}

        def run():
            try:
                box["fit"] = c.master.fit_sync(1, B, RPC_LR, master_shards=TREE_SHARDS)
            except BaseException as e:  # noqa: BLE001 - raised below, on this thread
                box["error"] = e

        reset_counts()
        t = threading.Thread(target=run, daemon=True)
        t.start()
        t_end = time.monotonic() + 120
        while (m.counter("master.sync.rounds").value < r0 + SHARD_KILL_AT
               and time.monotonic() < t_end and t.is_alive()):
            time.sleep(0.002)
        c.master.kill_shard(1)
        t.join(timeout=300)
        if t.is_alive() or "error" in box:
            raise AssertionError(f"kill_shard: the sharded fit did not finish: "
                                 f"{box.get('error', 'still running')}")
        launches = wg.worker_grads.launches
        members = len(c.master.members)
    counts = tree_counts(m)
    same = bool(np.array_equal(np.asarray(box["fit"].weights), np.asarray(flat.weights)))
    print(f"phase 13 kill_shard(1) after {SHARD_KILL_AT} windows ({SHARD_KILL_ROWS} rows, "
          f"{TREE_SHARDS} shards): fallback rounds {counts['master.shard.fallback_rounds']}, "
          f"rebuilds {counts['master.shard.rebuilds']}, shard count now "
          f"{counts.get('master.shard.count')}, evictions {counts['master.evictions']}, members "
          f"{members}; worker_grads launches {launches}; weights bitwise the flat fit's: {same}",
          flush=True)
    if (counts["master.shard.fallback_rounds"], counts["master.shard.rebuilds"],
            counts["master.evictions"], members) != (1, 1, 0, RPC_WORKERS) or not same:
        raise AssertionError(f"kill_shard: {counts}, {members} members, bitwise {same}; want "
                             f"1 fallback round, 1 rebuild, 0 evictions, {RPC_WORKERS} members "
                             f"and the flat fit's weights")
    return {"launches": launches}


def run_tree_phase(full: dict) -> dict:
    """Phase 13 on phase 8's full-width data and knobs-off weights, then the
    K=1 tree on phase 8's RPC_SMALL_ROWS rows, which must give that fit's
    weights bit for bit (these rows, not full width, keep the smoke's
    time); returns each fit's worker_grads
    and sync_epoch launches."""
    t0 = time.perf_counter()
    launches = {}
    fits = {}
    with cli_env(DSGD_SYNTHETIC=TREE_BUSY_ROWS):
        busy_data = port_main.build(Config.from_env(), "cuda")
    for label, kw in TREE_FITS:
        fits[label] = run_tree_fit(label, kw, full, busy_data, RPC_ACC_FLOOR)
        launches[label] = fits[label]["launches"]
    # the K=1 tree at phase 8's RPC_SMALL_ROWS rows, bitwise its knobs-off
    # fit there (once at full width too: a depth cut, ~35 s)
    again = run_tree_fit("tree", dict(agg_tree=TREE_SPEC), full["small"], busy_data, 0.0)
    del busy_data
    launches["tree"] = again["launches"]
    for label, kw in SMALL_TREE_FITS:
        launches[label] = run_tree_fit(label, kw, full["small"], None, 0.0)["launches"]
    with cli_env(DSGD_SYNTHETIC=SHARD_KILL_ROWS):
        train, test, model = port_main.build(Config.from_env(), "cuda")
    launches["kill_shard"] = check_shard_kill(model, train, test)["launches"]
    print(f"phase 13: the tree ({RPC_SMALL_ROWS:,} rows) bitwise the knobs-off fit: "
          f"{again['bitwise']}", flush=True)
    if not again["bitwise"]:
        raise AssertionError("phase 13: the tree fit differs from the knobs-off fit")
    print(f"tree phase seconds: {time.perf_counter() - t0:.1f}", flush=True)
    return launches


# -- phase 14: the telemetry scrape and the rest of the model ---------------------

# BASELINE config 5 (benches/baseline_configs.py config5): dense least
# squares, 1,000,000 x 1,024, 1 worker, B=256, lr 0.05, no regularizer
DENSE_ROWS, DENSE_D = 1_000_000, 1024
DENSE_B, DENSE_LR, DENSE_EPOCHS = 256, 0.05, 2
DENSE_STEPS = 3125  # 800,000 train rows / 256
DENSE_NOISE = 0.01  # the label noise the generator plants
DENSE_MSE_MAX = 2 * DENSE_NOISE ** 2  # twice its variance: a bound from the data
# under the bound an epoch's MSE may exceed the one before by this share at
# most: there a constant-step SGD iterate moves with its last batches
DENSE_FLOOR_RTOL = 0.01
DENSE_CPU_ROWS = 100_000  # the card-against-CPU fit
DENSE_CPU_RTOL = 1e-5  # max |w_card - w_cpu| / max |w_cpu|
DENSE_LAUNCH_STEPS = 50  # steps profiled for the launches a step
# BASELINE config 3: logistic with l2 on the RCV1 shape (phase 5's rows)
CFG3_LAM, CFG3_LR, CFG3_EPOCHS = 1e-5, 0.5, 2
TEL_ROWS = 100_000  # the checked telemetry fit: 80,000 train rows, 3 workers, 1 epoch
TEL_TURN_ROWS = 25_000  # the fits in turns (100,000, then 50,000, before depth cuts)
TEL_HEARTBEAT_S = 0.5  # the scrape rides the heartbeat in every fit of the phase
TEL_NORM_RTOL = 1e-6
# telemetry's cost, split: each variant adds one part to the one before
# ("registries": a registry a node, no scrape and no health gauges;
# "scrape": the master's scrape on the heartbeat too; "on": the workers'
# health gauges too), each fit in turns from off to on and back
TEL_VARIANTS = ("off", "registries", "scrape", "on")
TEL_TIMED_CALLS = 50  # calls a median of one part's host time is taken over
PREDICT_MARGIN = 1e-5  # SyncTrainer.predict against float64 margins past this
FLAT_ATOL = 1e-5
PHASE14_BUDGET_S = 90  # printed against the phase's time, not gated


def check_precision(label: str) -> None:
    """f32 products stay f32 on the card: PyTorch's defaults, which the
    port never changes (the JAX dense path runs at Precision.HIGHEST)."""
    prec, tf32 = torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32
    if prec != "highest" or tf32:
        raise AssertionError(f"{label}: float32 matmul precision {prec!r}, allow_tf32 {tf32}; "
                             f"want 'highest' and False")


def config5_rows() -> Dataset:
    """benches/baseline_configs.py config5's rows, with numpy:
    ``normal(size=(n, d)) / sqrt(d)``, ``w_true``, ``y = x @ w_true +
    0.01 normal``.  The draws come a block of rows at a time, which gives
    the one draw's stream with no 8 GB float64 copy; sqrt(1024) = 32 is a
    power of two, so dividing the f32 draws in place gives the bench's f32
    values bit for bit; the labels are its float64 products, block by
    block."""
    rng = np.random.default_rng(0)
    blk = 100_000
    val = np.empty((DENSE_ROWS, DENSE_D), np.float32)
    for s in range(0, DENSE_ROWS, blk):
        val[s:s + blk] = rng.normal(size=(blk, DENSE_D))
        val[s:s + blk] /= np.float32(np.sqrt(DENSE_D))
    w_true = rng.normal(size=DENSE_D).astype(np.float32).astype(np.float64)
    y = np.empty(DENSE_ROWS, np.float64)
    for s in range(0, DENSE_ROWS, blk):
        y[s:s + blk] = val[s:s + blk].astype(np.float64) @ w_true
    y += DENSE_NOISE * rng.normal(size=DENSE_ROWS)
    return Dataset.dense(val, y.astype(np.float32))


def launch_counts(fn) -> tuple:
    """(kernel launch calls on the host, device kernel events) while `fn`
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
    calls = sum(1 for e in events if e.get("ph") == "X" and "LaunchKernel" in e.get("name", ""))
    kernels = sum(1 for e in events if e.get("ph") == "X" and e.get("cat") == "kernel")
    return calls, kernels


def dense_fit(train: Dataset, test: Dataset, device: str, epochs: int, ids_from=None):
    """SyncTrainer on config 5's model; with `ids_from` (a bound split on
    the card) each epoch's ids are that split's draws, copied here."""
    model = make_model("least_squares", 0.0, DENSE_D, regularizer="none", device=device)
    trainer = SyncTrainer(model, batch_size=DENSE_B, learning_rate=DENSE_LR, device=device)
    bound = {}
    bind = trainer.engine.bind

    def keep(data, *a, **kw):
        b = bind(data, *a, **kw)
        if ids_from is not None and "train" not in bound:
            b._sample_ids = lambda key: ids_from._sample_ids(key).to(device)
        bound.setdefault("train", b)
        return b

    trainer.engine.bind = keep
    fit = trainer.fit(train, test, epochs)
    return fit, bound["train"]


def start_config5_rows() -> dict:
    """`config5_rows` in a thread of its own, started before phase 13 so
    that phase 14 finds the rows made: numpy draws and multiplies without
    the interpreter lock, so the 30-odd seconds of it run beside phase
    13's fits (one core of the host's) instead of after them."""
    box = {}

    def run():
        t0 = time.perf_counter()
        try:
            box["data"] = config5_rows()
        except BaseException as e:  # re-raised by check_config5
            box["error"] = e
        box["seconds"] = time.perf_counter() - t0

    box["thread"] = threading.Thread(target=run, name="config5-rows", daemon=True)
    box["thread"].start()
    return box


def check_config5(made: dict) -> dict:
    """Config 5 at full width on the card, on `start_config5_rows`'s rows:
    3,125 steps an epoch, no sync_epoch or worker_grads launch, a test
    MSE that falls until it is <= DENSE_MSE_MAX and then rises by
    DENSE_FLOOR_RTOL at most, f32 matmuls throughout; then at
    DENSE_CPU_ROWS the same fit on the card and on the CPU from the same
    ids."""
    check_precision("config 5, before")
    t0 = time.perf_counter()
    made["thread"].join()
    wait_s = time.perf_counter() - t0
    if "error" in made:
        raise made["error"]
    data = made.pop("data")
    train, test = train_test_split(data)
    reset_counts()
    fit, bound = dense_fit(train, test, "cuda", DENSE_EPOCHS)
    torch.cuda.synchronize()
    kernels_run = (se.sync_epoch.launches, wg.worker_grads.launches)
    check_precision("config 5, after the fit")
    w = fit.weights
    ids = bound._sample_ids(0)[:DENSE_LAUNCH_STEPS]
    calls, kernels = launch_counts(lambda: bound._run(w.clone(), ids))
    launches = calls / DENSE_LAUNCH_STEPS
    mse0 = float(torch.mean(torch.as_tensor(test.labels, device="cuda") ** 2))  # at w = 0
    # an epoch's least time: every drawn row (its values, label and id)
    # read once, w read and written once a step; two GEMVs of B x D a step
    rows = DENSE_STEPS * DENSE_B
    bound_ms = 1e3 * max((rows * (DENSE_D * 4 + 4 + 8) + DENSE_STEPS * DENSE_D * 8)
                         / HBM_BYTES_PER_S, DENSE_STEPS * 4 * DENSE_B * DENSE_D / F32_FLOPS)
    print(f"phase 14 config 5 ({DENSE_ROWS:,} x {DENSE_D} dense least squares, 1 worker, "
          f"B={DENSE_B}, lr {DENSE_LR}, {DENSE_EPOCHS} epochs): data generation "
          f"{made['seconds']:.2f} s beside phase 13, {wait_s:.2f} s waited here; "
          f"{fit.steps_per_epoch} steps an epoch; epoch seconds {fit.epoch_seconds} (bound "
          f"{bound_ms:.3f} ms an epoch, bytes); test MSE "
          f"at w = 0 {mse0:.6f}, after each epoch {fit.test_losses}; kernel launches a step "
          f"{launches:.2f} ({calls} launch calls, {kernels} device kernels over "
          f"{DENSE_LAUNCH_STEPS} steps); sync_epoch and worker_grads launches in the fit "
          f"{kernels_run}; precision {torch.get_float32_matmul_precision()}, "
          f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}; {card_line()}", flush=True)
    losses = [mse0] + fit.test_losses
    if fit.steps_per_epoch != DENSE_STEPS or fit.epochs_run != DENSE_EPOCHS:
        raise AssertionError(f"config 5: {fit.epochs_run} epochs of {fit.steps_per_epoch} "
                             f"steps, want {DENSE_EPOCHS} of {DENSE_STEPS}")
    if kernels_run != (0, 0):
        raise AssertionError(f"config 5: (sync_epoch, worker_grads) launches {kernels_run}, "
                             f"want none: dense rows take the matmul steps")
    rises = [b / a - 1 for a, b in zip(losses, losses[1:])]
    print(f"phase 14 config 5: the test MSE's change at each epoch "
          f"{[f'{r:+.4%}' for r in rises]}", flush=True)
    held = all(r < 0 or (max(a, b) <= DENSE_MSE_MAX and r <= DENSE_FLOOR_RTOL)
               for a, b, r in zip(losses, losses[1:], rises))
    if not held or not losses[-1] <= DENSE_MSE_MAX:
        raise AssertionError(f"config 5: test MSE {losses} must fall until it is <= "
                             f"{DENSE_MSE_MAX}, then rise by {DENSE_FLOOR_RTOL:.0%} at most")
    del fit, bound, w, ids, train, test
    gc.collect()  # the trainer's bind wrapper holds its bound split in a cycle
    torch.cuda.empty_cache()

    # the first DENSE_CPU_ROWS rows, on the card and on the CPU, same ids
    small = data.slice(slice(0, DENSE_CPU_ROWS))
    tr, te = train_test_split(small)
    card, card_bound = dense_fit(tr, te, "cuda", DENSE_EPOCHS)
    cpu, _ = dense_fit(tr, te, "cpu", DENSE_EPOCHS, ids_from=card_bound)
    wc, wh = card.weights.cpu().numpy(), cpu.weights.numpy()
    rel = float(np.abs(wc - wh).max() / np.abs(wh).max())
    print(f"phase 14 config 5 card against CPU ({DENSE_CPU_ROWS:,} rows, same ids): max "
          f"|dw| / max |w| {rel:.3e}; test MSE card {card.test_losses}, CPU "
          f"{cpu.test_losses}", flush=True)
    if not rel <= DENSE_CPU_RTOL:
        raise AssertionError(f"config 5: card and CPU weights differ by {rel:.3e} relative, "
                             f"limit {DENSE_CPU_RTOL}")
    del data, small, tr, te, card, card_bound, cpu
    gc.collect()
    torch.cuda.empty_cache()
    check_precision("config 5, after")
    return {"launches_a_step": launches, "sync_epoch": kernels_run[0],
            "worker_grads": kernels_run[1]}


def check_config3() -> dict:
    """Config 3 at full width on phase 5's rows: one sync_epoch launch an
    epoch and no worker_grads; evaluate on the final weights = the fit's
    last test numbers bit for bit; the test accuracy rises every epoch and
    ends >= 0.70."""
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS):
        train, test = train_test_split(port_main.load_data(Config.from_env()))
    model = make_model("logistic", CFG3_LAM, D, regularizer="l2", device="cuda")
    trainer = SyncTrainer(model, batch_size=B, learning_rate=CFG3_LR, virtual_workers=K,
                          device="cuda")
    reset_counts()
    fit = trainer.fit(train, test, CFG3_EPOCHS)
    torch.cuda.synchronize()
    launches = (se.sync_epoch.launches, wg.worker_grads.launches)
    again = trainer.evaluate(fit.weights, test)
    loss0 = trainer.evaluate(np.zeros(D, np.float32), test)[0]
    print(f"phase 14 config 3 (logistic, l2, lambda {CFG3_LAM}, {K} workers, B={B}, lr "
          f"{CFG3_LR}, {CFG3_EPOCHS} epochs, {len(train):,} train rows): epoch seconds "
          f"{fit.epoch_seconds}; test objective at w = 0 {loss0:.7f}, then {fit.test_losses}; "
          f"accuracy {fit.test_accuracies}; sync_epoch launches {launches[0]}, worker_grads "
          f"{launches[1]}; evaluate again {again}; {card_line()}", flush=True)
    bad = []
    if launches != (CFG3_EPOCHS, 0):
        bad.append(f"launches (sync_epoch, worker_grads) {launches}, want ({CFG3_EPOCHS}, 0)")
    if again != (fit.test_losses[-1], fit.test_accuracies[-1]):
        bad.append(f"evaluate {again} is not the fit's last test numbers "
                   f"{(fit.test_losses[-1], fit.test_accuracies[-1])}")
    # the test objective is printed, not gated: at lr 0.5 on summed
    # gradients the logistic margins outgrow the noisy labels and the mean
    # log loss climbs above ln 2 while the accuracy rises.  The JAX package
    # does the same at this width: benches/results/baseline_configs_r4.json
    # and _r5.json hold its config 3 at test loss 0.8977 and 0.8966,
    # accuracy 0.8212 and 0.8209
    accs = fit.test_accuracies
    if not all(b > a for a, b in zip(accs, accs[1:])) or accs[-1] < RPC_ACC_FLOOR:
        bad.append(f"test accuracy {accs} must rise every epoch and end >= {RPC_ACC_FLOOR}")
    if bad:
        raise AssertionError("config 3: " + "; ".join(bad))
    return {"launches": launches[0], "epoch_seconds": fit.epoch_seconds}


def check_predict(w: np.ndarray, test: Dataset) -> None:
    """SyncTrainer.predict on phase 5's weights over its held-out rows:
    the hinge rule -sign(margin) of a float64 numpy margin wherever
    |margin| > PREDICT_MARGIN."""
    model = make_model("hinge", LAM, D, regularizer="l2", device="cuda")
    preds = SyncTrainer(model, batch_size=B, learning_rate=0.5, device="cuda").predict(w, test)
    m64 = np.einsum("np,np->n", test.values.astype(np.float64),
                    w.astype(np.float64)[test.indices])
    firm = np.abs(m64) > PREDICT_MARGIN
    wrong = int(np.sum(preds[firm] != -np.sign(m64[firm])))
    print(f"phase 14 SyncTrainer.predict on phase 5's weights: {len(preds)} rows, {int(firm.sum())} "
          f"with |margin| > {PREDICT_MARGIN}, {wrong} differ from the float64 rule", flush=True)
    if preds.shape != (len(test),) or wrong:
        raise AssertionError(f"predict: {wrong} of {int(firm.sum())} firm rows differ")


def telemetry_fit(model, train, test, variant: str, check: bool = False) -> dict:
    """One knobs-off RPC sync fit (3 workers, 1 epoch) with the
    heartbeat on, with telemetry's parts as `variant` (TEL_VARIANTS) says:
    every part but "off" gives each node its own registry, "scrape" and
    "on" install the master's scrape, and "on" has the workers publish
    their health gauges.  With `check` the scrape is held to the fit (see
    check_telemetry) and each part's host time is taken."""
    from distributed_sgd_tpu_torch.core import master as master_mod
    from distributed_sgd_tpu_torch.core import worker as worker_mod
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    replies, bodies = {}, {}
    servicer = worker_mod._WorkerServicer
    encode, update = servicer._encode_reply, servicer._gradient_update
    enable = master_mod.MasterNode.enable_telemetry

    def keep_reply(self, request, g, k):
        msg = encode(self, request, g, k)
        replies[self.w.node_label] = msg
        return msg

    def count_body(self, request):
        bodies[self.w.node_label] = bodies.get(self.w.node_label, 0) + 1
        return update(self, request)

    servicer._encode_reply, servicer._gradient_update = keep_reply, count_body
    if variant == "registries":
        master_mod.MasterNode.enable_telemetry = lambda self, port=None, **kw: None
    try:
        with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=Metrics(),
                        heartbeat_s=TEL_HEARTBEAT_S,
                        telemetry_port=None if variant == "off" else 0) as c:
            for w in c.workers:
                w.telemetry = variant == "on"
            reset_counts()
            fit = c.master.fit_sync(1, B, RPC_LR)
            torch.cuda.synchronize()
            rounds = c.master.metrics.counter("master.sync.rounds").value
            out = {"windows_s": rounds / fit.epoch_seconds[0], "rounds": rounds,
                   "launches": wg.worker_grads.launches, "fit": fit}
            if check:
                out.update(scrape_checks(c, replies, bodies))
                out["part_ms"] = telemetry_part_ms(c, replies)
    finally:
        servicer._encode_reply, servicer._gradient_update = encode, update
        master_mod.MasterNode.enable_telemetry = enable
    return out


def telemetry_part_ms(c, replies: dict) -> dict:
    """The host milliseconds of one call of each part of telemetry, the
    median of TEL_TIMED_CALLS calls, after the fit: a worker's snapshot,
    the master's scrape of its 3 workers, the process gauges that each
    scrape samples first, the exporter's text, and one record_health of a
    reply-sized gradient."""
    from distributed_sgd_tpu_torch.rpc import codec
    from distributed_sgd_tpu_torch.telemetry.aggregate import snapshot_metrics
    from distributed_sgd_tpu_torch.utils import metrics as mm

    w0 = c.workers[0]
    g = codec.decode_grad(replies[w0.node_label])
    parts = {
        "worker snapshot": lambda: snapshot_metrics(w0.metrics, role="worker",
                                                    node=w0.node_label),
        "master scrape of 3": lambda: c.master.scrape_telemetry(),
        "process gauges": lambda: mm.sample_process_gauges(c.master.metrics),
        "cluster text": lambda: c.master.telemetry.prometheus_text(),
        "record_health": lambda: w0.record_health(g),
    }
    out = {}
    for name, fn in parts.items():
        times = []
        for _ in range(TEL_TIMED_CALLS):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        out[name] = round(statistics.median(times) * 1e3, 4)
    return out


def scrape_checks(c, replies: dict, bodies: dict) -> dict:
    """The master's scrape of its 3 workers after the fit, and an HTTP GET
    of its exporter."""
    from distributed_sgd_tpu_torch.rpc import codec
    from distributed_sgd_tpu_torch.utils import metrics as mm

    got = c.master.scrape_telemetry()
    m = c.master.metrics
    errors = m.counter(mm.TELEMETRY_SCRAPE_ERRORS).value
    with urllib.request.urlopen(f"http://127.0.0.1:{c.master.telemetry_exporter.port}/metrics",
                                timeout=30) as r:
        text = r.read().decode()
    bad = []
    if got != RPC_WORKERS or errors != 0:
        bad.append(f"{got} snapshots a scrape and {errors} scrape errors, want "
                   f"{RPC_WORKERS} and 0")
    norms, computes = {}, {}
    for w in c.workers:
        label = w.node_label
        norm = float(np.linalg.norm(codec.decode_grad(replies[label])))
        gauge = w.metrics.gauge(mm.HEALTH_GRAD_NORM).value
        norms[label] = (gauge, norm)
        if not abs(gauge - norm) <= TEL_NORM_RTOL * norm:
            bad.append(f"{label}: health.grad.norm {gauge} against |last reply| {norm}")
        snap = c.master.telemetry._snaps[(w.host, w.port)]
        hist = {h.name: h.count for h in snap.hists}
        computes[label] = (hist.get("span.slave.grad.compute"), bodies.get(label))
        if hist.get("span.slave.grad.compute") != bodies.get(label):
            bad.append(f"{label}: slave.grad.compute count {hist.get('span.slave.grad.compute')}"
                       f", Gradient bodies {bodies.get(label)}")
    backward = sum(w.metrics.counter("slave.sync.backward").value for w in c.workers)
    line = f'slave_sync_backward_total{{role="cluster"}} {backward}'
    if line not in text:
        bad.append(f"the exporter's text lacks {line!r}")
    for w in c.workers:
        if f'health_grad_norm{{role="worker",worker="{w.node_label}"}}' not in text:
            bad.append(f"the exporter's text lacks {w.node_label}'s health_grad_norm")
    scrapes = m.counter(mm.TELEMETRY_SCRAPES).value
    print(f"phase 14 telemetry scrape: {got} snapshots, {errors} errors, {scrapes} scrapes "
          f"(the heartbeat's and these), health.grad.norm (gauge, |last reply|) {norms}; "
          f"slave.grad.compute (count, Gradient bodies) {computes}; cluster slave.sync.backward "
          f"{backward}; exporter text {len(text)} bytes", flush=True)
    if bad:
        raise AssertionError("telemetry: " + "; ".join(bad))
    return {"scrapes": scrapes}


def check_telemetry() -> dict:
    """The scrape's checks on a telemetry fit, then the cost: windows/s of
    each of TEL_VARIANTS in turns, from off to on and back, and the host
    time of one call of each part."""
    with cli_env(DSGD_SYNTHETIC=TEL_ROWS):
        train, test, model = port_main.build(Config.from_env(), "cuda")
    first = telemetry_fit(model, train, test, "on", check=True)
    with cli_env(DSGD_SYNTHETIC=TEL_TURN_ROWS):
        train, test, model = port_main.build(Config.from_env(), "cuda")
    turns = []
    for variant in TEL_VARIANTS + TEL_VARIANTS[::-1]:
        r = telemetry_fit(model, train, test, variant)
        turns.append((variant, r["windows_s"]))
    means = {v: statistics.mean(x for name, x in turns if name == v) for v in TEL_VARIANTS}
    against_off = {v: f"{means[v] / means['off'] - 1:+.2%}" for v in TEL_VARIANTS[1:]}
    print(f"phase 14 telemetry's cost ({TEL_TURN_ROWS:,} rows, {RPC_WORKERS} workers, 1 epoch, "
          f"heartbeat {TEL_HEARTBEAT_S} s, all nodes in this process): windows/s in turns "
          f"{turns}; means {means}; against off {against_off}; "
          f"host ms of one call (median of {TEL_TIMED_CALLS}) {first['part_ms']}; the checked "
          f"fit ({TEL_ROWS:,} rows) {first['windows_s']:.1f} windows/s, test accuracy "
          f"{first['fit'].test_accuracies[0]:.4f}, worker_grads launches {first['launches']} over "
          f"{first['rounds']} windows; {card_line()}", flush=True)
    if first["launches"] != RPC_WORKERS * first["rounds"]:
        raise AssertionError(f"telemetry fit: {first['launches']} worker_grads launches over "
                             f"{first['rounds']} windows")
    return {"launches": first["launches"]}


def check_flat_sparse() -> None:
    """flat_sparse matvec and scatter_add on the card against the CPU on
    one full-width batch (B rows of the main path's shape)."""
    from distributed_sgd_tpu_torch.ops import flat_sparse
    from distributed_sgd_tpu_torch.ops.sparse import SparseBatch

    idx, val, _ = main_path_batch(5)
    batch = SparseBatch(torch.from_numpy(idx[0]), torch.from_numpy(val[0]))
    rng = np.random.default_rng(6)
    w = torch.from_numpy(rng.normal(size=D).astype(np.float32))
    coeff = torch.from_numpy(rng.choice([-1.0, 1.0], B).astype(np.float32))

    def run(dev):
        flat = flat_sparse.from_padded(batch, device=dev)
        return (flat_sparse.matvec(flat, w.to(dev)).cpu(),
                flat_sparse.scatter_add(flat, coeff.to(dev), D).cpu(), int(flat.indices.shape[0]))

    card, host = run("cuda"), run("cpu")
    errs = [float((a - b).abs().max()) for a, b in zip(card[:2], host[:2])]
    print(f"phase 14 flat_sparse ({B} rows, {card[2]} stored entries): max |card - CPU| "
          f"matvec {errs[0]:.3e}, scatter_add {errs[1]:.3e}", flush=True)
    if not max(errs) <= FLAT_ATOL:
        raise AssertionError(f"flat_sparse: card and CPU differ by {errs}, limit {FLAT_ATOL}")


def run_model_phase(main_w: np.ndarray, main_test: Dataset, config5: dict) -> dict:
    """Phase 14 (`config5`: `start_config5_rows`); returns the launches of
    its paths."""
    t0 = time.perf_counter()
    dense = check_config5(config5)
    cfg3 = check_config3()
    check_predict(main_w, main_test)
    tel = check_telemetry()
    check_flat_sparse()
    check_precision("phase 14, end")
    took = time.perf_counter() - t0
    print(f"model phase seconds: {took:.1f} (budget {PHASE14_BUDGET_S})", flush=True)
    return {"dense_launches_a_step": dense["launches_a_step"], "cfg3": cfg3["launches"],
            "telemetry": tel["launches"], "dense_sync_epoch": dense["sync_epoch"],
            "dense_worker_grads": dense["worker_grads"]}


# -- phase 15: the process group ----------------------------------------------

PG_WORLD = 2  # gloo ranks on the one card: NCCL refuses two ranks on one device
PG_STEPS_FIRST = 100  # steps after which the two-rank fits are held to one process's
PG_ATOL = 1e-5  # ... within this
PG_ACC_GAP = 0.01  # the epoch's test accuracy against one process's
PG_ACC_FLOOR = 0.70
PG_TIMED_STEPS = 200  # per-step path steps split into parts by CUDA events
PG_FS_STEPS = 2146  # (d)'s steps: a third of its 6,436-step epoch (a depth cut, PR 13)
PG_RANK_TIMEOUT_S = 300  # each rank's own limit
PG_BUDGET_S = 90  # printed against the phase's time, not gated
HIER_RTOL = 1e-6  # the in-host group's reply against the flat worker's, relative
HIER_WINDOW_K = 4


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def check_nccl_one_rank() -> int:
    """(a) The main path for 1 epoch in the CLI without a process group,
    then inside an NCCL group of one rank (torchrun's environment: the CLI
    joins it): bitwise the same weights and test numbers, one sync_epoch
    launch, the evaluation's sums through NCCL.  Returns the launches."""
    import torch.distributed as dist

    from distributed_sgd_tpu_torch.parallel import multihost

    runs, seen = {}, {}
    init = multihost.initialize

    def spy(*args, **kw):
        dev = init(*args, **kw)
        seen.update(backend=dist.get_backend(), world=dist.get_world_size())
        return dev

    multihost.initialize = spy
    try:
        for label, extra in (("no group", {}),
                             ("nccl", dict(WORLD_SIZE=1, RANK=0, LOCAL_RANK=0,
                                           MASTER_ADDR="127.0.0.1", MASTER_PORT=free_port()))):
            with cli_env(DSGD_SYNTHETIC=MAIN_ROWS, DSGD_MAX_EPOCHS=1, **extra):
                reset_counts()
                run = port_main.main()
                torch.cuda.synchronize()
            runs[label] = (run.fit, se.sync_epoch.launches, wg.worker_grads.launches)
    finally:
        multihost.initialize = init
    (plain, _, _), (grouped, launches, wg_launches) = runs["no group"], runs["nccl"]
    print(f"(a) NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}, group {seen}: the main "
          f"path's epoch {grouped.epoch_seconds[0]:.4f} s in the group, "
          f"{plain.epoch_seconds[0]:.4f} s without; sync_epoch launches {launches}, "
          f"worker_grads {wg_launches}; test loss {grouped.test_losses[0]:.7f} accuracy "
          f"{grouped.test_accuracies[0]:.7f}", flush=True)
    if seen != {"backend": "nccl", "world": 1} or dist.is_initialized():
        raise AssertionError(f"(a): the group was {seen}, and is left initialized: "
                             f"{dist.is_initialized()}")
    if not torch.equal(grouped.weights, plain.weights) or (
            grouped.test_losses, grouped.test_accuracies) != (plain.test_losses,
                                                              plain.test_accuracies):
        raise AssertionError("(a): the fit inside an NCCL group of one rank differs from the "
                             "fit without a group")
    if (launches, wg_launches) != (1, 0):
        raise AssertionError(f"(a): {launches} sync_epoch and {wg_launches} worker_grads "
                             f"launches; want 1 and 0")
    return launches


def check_host_mesh(train: Dataset, model, w: np.ndarray) -> int:
    """(c) HostMeshEngine on ["cuda:0", "cuda:0"] over phase 8's full-width
    slice (a worker's train rows): a Gradient body and a K=4 window, each
    against the flat worker's reply for the same ids, two worker_grads
    launches a body.  Returns the launches of the body."""
    from distributed_sgd_tpu_torch.core.worker import WorkerNode

    rng = np.random.default_rng(15)
    ids = rng.choice(len(train), size=B, replace=False)
    window_ids = rng.choice(len(train), size=HIER_WINDOW_K * B, replace=False)
    nodes = {}
    try:
        for label, kw in (("flat", {}),
                          ("hier", dict(host_devices=2, devices=["cuda:0", "cuda:0"]))):
            nodes[label] = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, train, model, seed=0,
                                      metrics=Metrics(), **kw)
        flat, hier = nodes["flat"], nodes["hier"]
        g_flat = flat.compute_gradient(w, ids)
        win_flat = flat.compute_local_window(w, window_ids, HIER_WINDOW_K, B, RPC_LR)
        torch.cuda.synchronize()
        reset_counts()
        g_hier = hier.compute_gradient(w, ids)
        torch.cuda.synchronize()
        body_launches = wg.worker_grads.launches
        win_hier = hier.compute_local_window(w, window_ids, HIER_WINDOW_K, B, RPC_LR)
        torch.cuda.synchronize()
        win_launches = wg.worker_grads.launches - body_launches
        se_launches = se.sync_epoch.launches
        t_hier = time_ms(lambda: hier.compute_gradient(w, ids), iters=50, warmup=5)
        t_flat = time_ms(lambda: flat.compute_gradient(w, ids), iters=50, warmup=5)
    finally:
        for node in nodes.values():
            node.stop()
    rel_g = float(np.abs(g_hier - g_flat).max() / np.abs(g_flat).max())
    rel_win = float(np.abs(win_hier - win_flat).max() / np.abs(win_flat).max())
    print(f"(c) HostMeshEngine on [cuda:0, cuda:0] ({len(train):,} rows, B={B}): Gradient "
          f"body relative gap {rel_g:.3e}, K={HIER_WINDOW_K} window {rel_win:.3e} (limit "
          f"{HIER_RTOL}); worker_grads launches {body_launches} a body, {win_launches} a "
          f"window, sync_epoch {se_launches}; a body {t_hier:.4f} ms host-timed against "
          f"{t_flat:.4f} ms flat", flush=True)
    if not (rel_g <= HIER_RTOL and rel_win <= HIER_RTOL):
        raise AssertionError(f"(c): the group's replies differ from the flat worker's by "
                             f"{rel_g} and {rel_win}, relative")
    if (body_launches, win_launches, se_launches) != (2, 2 * HIER_WINDOW_K, 0):
        raise AssertionError(f"(c): {body_launches} launches a body, {win_launches} a window, "
                             f"{se_launches} sync_epoch; want 2, {2 * HIER_WINDOW_K}, 0")
    return body_launches


def write_rank_rows(tmp: str, train: Dataset, test: Dataset) -> None:
    """Phase 5's rows as .npy files, written once, that every rank maps."""
    for split, data in (("train", train), ("test", test)):
        for name in ("indices", "values", "labels"):
            np.save(os.path.join(tmp, f"{split}_{name}.npy"), getattr(data, name))
    np.save(os.path.join(tmp, "dim_sparsity.npy"), dim_sparsity(train))
    np.save(os.path.join(tmp, "n_features.npy"), np.int64(train.n_features))
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(dict(lam=LAM, batch=B, lr=RPC_LR, virtual_workers=K, seed=0,
                       steps_first=PG_STEPS_FIRST, timed_steps=PG_TIMED_STEPS,
                       fs_steps=PG_FS_STEPS), f)


def run_ranks(tmp: str) -> list:
    """The two gloo ranks of tools/process_group_ranks.py, each a process
    with a limit of its own; a rank that fails fails the phase."""
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "distributed_sgd_tpu_torch.tools.process_group_ranks", tmp,
         str(r), str(PG_WORLD), str(port)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(PG_WORLD)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=PG_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"rank {r} exited {p.returncode}:\n{log[-6000:]}")
    out = []
    for r in range(PG_WORLD):
        with np.load(os.path.join(tmp, f"rank{r}.npz")) as z:
            out.append({k: z[k] for k in z.files})
    return out


def check_two_ranks_sync(ranks: list, train: Dataset, test: Dataset, model) -> int:
    """(b) The two ranks' sync fit against one process's K=6 per-step fit
    driven by the same real rows for each worker and step."""
    r0, r1 = ranks
    n = len(train)
    shard_n = int(r0["sync_shard_n"])
    steps = r0["sync_ids"].shape[0]
    # rank r's local id i is padded row r * shard_n + i, real when below n;
    # one process's layout pads from row n on
    glob = [r["sync_ids"] + i * shard_n for i, r in enumerate(ranks)]
    ids6 = np.concatenate([np.where(g < n, g, n) for g in glob], axis=1)
    eng = SyncEngine(model, B, RPC_LR, virtual_workers=PG_WORLD * K, device="cuda")
    one = eng.bind(train)
    if one.steps_per_epoch != steps or one.epoch_kernel:
        raise AssertionError(f"(b): one process's K=6 fit has {one.steps_per_epoch} steps "
                             f"(want {steps}), epoch kernel {one.epoch_kernel}")
    t_ids = torch.from_numpy(ids6).cuda()
    w = one._run(torch.zeros(D, device="cuda"), t_ids[:PG_STEPS_FIRST])
    gap_first = float((w.cpu() - torch.from_numpy(r0["sync_w_first"])).abs().max())
    w = one._run(w, t_ids[PG_STEPS_FIRST:])
    acc_one = eng.bind(test).evaluate(w)[1]
    gap_end = float((w.cpu() - torch.from_numpy(r0["sync_w"])).abs().max())
    acc = float(r0["sync_test"][1])
    print(f"(b) gloo, {PG_WORLD} ranks on the card, K={K} a rank, B={B}, lr {RPC_LR}, "
          f"1 epoch of {steps} steps: epoch seconds "
          f"{[round(float(r['sync_epoch_s']), 4) for r in ranks]} (bind "
          f"{[round(float(r['sync_bind_s']), 3) for r in ranks]} s); us a step "
          f"{ {k[8:]: round(float(r0[k]), 2) for k in r0 if k.startswith('sync_us_')} } "
          f"(rank 0, {PG_TIMED_STEPS} steps); worker_grads launches "
          f"{[int(r['sync_worker_grads']) for r in ranks]}, sync_epoch "
          f"{[int(r['sync_sync_epoch']) for r in ranks]}; test accuracy {acc:.4f} against "
          f"{acc_one:.4f} for one process's K=6 fit; weights gap {gap_first:.3e} after "
          f"{PG_STEPS_FIRST} steps, {gap_end:.3e} after the epoch", flush=True)
    if not np.array_equal(r0["sync_w"], r1["sync_w"]):
        raise AssertionError("(b): the two ranks' weights differ")
    if any((int(r["sync_worker_grads"]), int(r["sync_sync_epoch"])) != (steps, 0)
           for r in ranks):
        raise AssertionError(f"(b): launches {[(int(r['sync_worker_grads']), int(r['sync_sync_epoch'])) for r in ranks]}; "
                             f"want ({steps}, 0) a rank")
    if not (acc >= PG_ACC_FLOOR and abs(acc - acc_one) <= PG_ACC_GAP and gap_first <= PG_ATOL):
        raise AssertionError(f"(b): accuracy {acc} (one process {acc_one}), gap after "
                             f"{PG_STEPS_FIRST} steps {gap_first}")
    return steps


def check_two_ranks_feature_sharded(ranks: list, train: Dataset, test: Dataset,
                                    model) -> float:
    """(d) The dp x tp fit at W=1, F=2 (its first PG_FS_STEPS steps)
    against the 1-D sync fit at one worker from the same ids."""
    r0, r1 = ranks
    ids = torch.from_numpy(r0["fs_ids"]).cuda()[:, None, :]
    eng = SyncEngine(model, B, RPC_LR, virtual_workers=1, device="cuda")
    one = eng.bind(train)
    w = one._run(torch.zeros(D, device="cuda"), ids[:PG_STEPS_FIRST])
    gap_first = float((w.cpu() - torch.from_numpy(r0["fs_w_first"])).abs().max())
    w = one._run(w, ids[PG_STEPS_FIRST:])
    acc_one = eng.bind(test).evaluate(w)[1]
    gap_end = float((w.cpu() - torch.from_numpy(r0["fs_w"])).abs().max())
    acc = float(r0["fs_test"][1])
    print(f"(d) dp x tp W=1 x F={PG_WORLD} (gloo, the features "
          f"{[r['fs_bounds'].tolist() for r in ranks]}), B={B}, lr {RPC_LR}, {ids.shape[0]} "
          f"steps of a {int(r0['fs_epoch_steps'])}-step epoch: seconds "
          f"{[round(float(r['fs_epoch_s']), 3) for r in ranks]}"
          f" (bind {[round(float(r['fs_bind_s']), 3) for r in ranks]} s); kernel launches "
          f"{[int(r['fs_launches']) for r in ranks]}; test accuracy {acc:.4f} against "
          f"{acc_one:.4f} for the 1-D fit; weights gap {gap_first:.3e} after "
          f"{PG_STEPS_FIRST} steps, {gap_end:.3e} at the end", flush=True)
    if not (np.array_equal(r0["fs_w"], r1["fs_w"]) and np.array_equal(r0["fs_ids"],
                                                                       r1["fs_ids"])):
        raise AssertionError("(d): the feature ranks' gathered weights or ids differ")
    if any(int(r["fs_launches"]) != 0 for r in ranks):
        raise AssertionError("(d): the dp x tp path launched a kernel")
    if not (acc >= PG_ACC_FLOOR and abs(acc - acc_one) <= PG_ACC_GAP and gap_first <= PG_ATOL):
        raise AssertionError(f"(d): accuracy {acc} (1-D {acc_one}), gap after "
                             f"{PG_STEPS_FIRST} steps {gap_first}")
    return float(r0["fs_epoch_s"])


def run_process_group_phase(main_w: np.ndarray) -> dict:
    """Phase 15; returns the launches of its paths."""
    t0 = time.perf_counter()
    nccl_launches = check_nccl_one_rank()
    with cli_env(DSGD_SYNTHETIC=MAIN_ROWS):
        train, test, model = port_main.build(Config.from_env(), "cuda")
    hier_launches = check_host_mesh(train, model, main_w)
    tmp = tempfile.mkdtemp(prefix="dsgd-ranks-")
    try:
        t1 = time.perf_counter()
        write_rank_rows(tmp, train, test)
        print(f"rank rows written in {time.perf_counter() - t1:.2f} s", flush=True)
        t1 = time.perf_counter()
        ranks = run_ranks(tmp)
        print(f"ranks ran in {time.perf_counter() - t1:.2f} s", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps = check_two_ranks_sync(ranks, train, test, model)
    check_two_ranks_feature_sharded(ranks, train, test, model)
    print(f"process group phase seconds: {time.perf_counter() - t0:.1f} "
          f"(budget {PG_BUDGET_S})", flush=True)
    return {"nccl": nccl_launches, "hier": hier_launches, "ranks": steps}

# -- phase 16: gradient compression and the training-health monitor -------------

COMP_K = 0.01  # DSGD_COMPRESS_K of the compressed fits: 472 of 47,236 coordinates
COMP_SEL_K = 472  # the selection timed: 1% of D
# how far a compressed fit's test accuracy may trail the uncompressed
# fit's; one-sided, as the JAX package's tests/test_compress.py holds its
# compressed fits (compression must not hurt; doing better passes)
COMP_ACC_GAP = 0.02
COMP_CPU_ATOL = 1e-5  # the compressed RPC fit on the card against the same on the CPU
HOG_COMP_UPDATES = 130000  # (b)'s budget: each codec's fit stops at its first check past it
HOG_COMP_CHECK_EVERY = 10000  # updates between the smoothed test loss's checks
# the JAX engine's best weights' test accuracy at (b)'s settings with topk
# 1% + EF, on the CPU (tests/torch_hogwild_compress_reference.py).  Top-k
# of a 64-step delta ships 1% of its support: the coordinator settles
# ~0.05 below the uncompressed fit in JAX too (0.8638 there), so top-k is
# held to JAX's compressed fit; qint8 to the uncompressed one
HOG_TOPK_JAX_ACC = 0.8117
HEALTH_POISON_CALL = 31  # worker 0's Gradient body that replies NaN: window 30 of 267
# the resumed fit's test loss against the knobs-off fit's: its windows from
# the tripped one on draw from the generator past that window's ids (the
# snapshot's state), so it is a fit of other draws, not the same one
HEALTH_LOSS_GAP = 0.05
COMP_BUDGET_S = 90  # printed against the phase's time, not gated


def comms_counts(m: Metrics) -> tuple:
    return (m.counter("comms.bytes_on_wire").value,
            m.counter("comms.bytes_dense_equiv").value)


def topk_then_ties(x: torch.Tensor, k: int) -> torch.Tensor:
    """The support lax.top_k picks, found another way: torch.topk's k-th
    largest magnitude, every index above it and the lowest indices tied at
    it, ascending.  Timed beside ops/topk.py's stable sort; the port does
    not use it."""
    a = x.abs()
    t = torch.topk(a, k, sorted=False).values.min()
    above = a > t
    tie = a == t
    take = tie & (torch.cumsum(tie, 0) <= k - above.sum())
    return torch.nonzero(above | take).squeeze(1)


def selection_cases() -> list:
    """(label, x, k): tests/test_torch_compress.py's planted ties; at D a
    sparse delta of 7,600 nonzeros (100 rows of ~76) with ties among them,
    whose zeros tie at k = 23,618 (DSGD_COMPRESS_K 0.5); one repeated
    magnitude; a dense vector."""
    rng = np.random.default_rng(16)
    ties = np.array([0, 3, -3, 0, 1, 3, 0, -1, 2, 0, 0], np.float32)
    sparse = np.zeros(D, np.float32)
    hit = rng.choice(D, 7600, replace=False)
    sparse[hit] = rng.normal(size=7600).astype(np.float32)
    sparse[hit[:400]] = 0.5
    return [("ties k=2", ties, 2), ("ties k=8", ties, 8), ("ties k=10", ties, 10),
            ("sparse delta k=472", sparse, COMP_SEL_K),
            ("sparse delta k=23618", sparse, 23618),
            ("one magnitude k=472", np.full(D, -0.25, np.float32), COMP_SEL_K),
            ("dense k=472", rng.normal(size=D).astype(np.float32), COMP_SEL_K)]


def check_topk_selection() -> dict:
    """(a) ops/topk.py's selection on the card against the CPU (the index
    lists equal) and against torch.topk with its boundary repaired; one
    selection at D, k = 472 by CUDA events, beside the repaired torch.topk
    and torch.topk alone (its ties unordered); a compressor's whole call
    from host numpy on the host clock."""
    from distributed_sgd_tpu_torch.compress import QInt8Compressor, TopKCompressor
    from distributed_sgd_tpu_torch.ops.topk import select, topk_magnitude

    cases = selection_cases()
    for label, x, k in cases:
        card_idx, card_val = topk_magnitude(x, k)
        cpu_idx, cpu_val = topk_magnitude(x, k, device="cpu")
        alt = topk_then_ties(torch.from_numpy(x).cuda(), k).to(torch.int32).cpu().numpy()
        same = card_idx.tobytes() == cpu_idx.tobytes() and card_val.tobytes() == cpu_val.tobytes()
        print(f"(a) topk {label} (D={len(x)}): card == CPU {same}; torch.topk with its "
              f"boundary repaired == {alt.tobytes() == card_idx.tobytes()}; first indices "
              f"{card_idx[:8].tolist()}", flush=True)
        if not same or alt.tobytes() != card_idx.tobytes():
            raise AssertionError(f"(a) topk {label}: the card's support differs from the CPU's "
                                 f"or from the repaired torch.topk's")
    x = torch.from_numpy(cases[-1][1]).cuda()
    sel_ms = time_ms(lambda: select(x, COMP_SEL_K))
    alt_ms = time_ms(lambda: topk_then_ties(x, COMP_SEL_K))
    lib_ms = time_ms(lambda: torch.topk(x.abs(), COMP_SEL_K))
    bound_us = (4 * D + 8 * COMP_SEL_K) / HBM_BYTES_PER_S * 1e6
    g = cases[-1][1] * np.float32(1e-3)
    host = {}
    for label, comp in (("topk", TopKCompressor(k=COMP_K, metrics=Metrics(), device="cuda")),
                        ("qint8", QInt8Compressor(metrics=Metrics()))):
        ts = []
        for _ in range(60):
            t0 = time.perf_counter()
            comp.compress(g, dest="d")
            ts.append(time.perf_counter() - t0)
        host[label] = statistics.median(ts[10:]) * 1e3
    print(f"(a) one selection at D={D}, k={COMP_SEL_K} (CUDA events, mean of 200): the stable "
          f"sort (ops/topk.py select) {sel_ms * 1e3:.2f} us, torch.topk with its boundary "
          f"repaired {alt_ms * 1e3:.2f} us, torch.topk alone (ties unordered) "
          f"{lib_ms * 1e3:.2f} us; bound {bound_us:.4f} us (bytes); a whole compress call "
          f"with EF from host numpy (host clock, median of 50): topk {host['topk']:.4f} ms, "
          f"qint8 {host['qint8']:.4f} ms; {card_line()}", flush=True)
    return {"select_us": sel_ms * 1e3, "repaired_us": alt_ms * 1e3, "topk_us": lib_ms * 1e3}


def run_compressed_hogwild(train: Dataset, test: Dataset, model) -> dict:
    """(b) Hogwild at full width with phase 6's settings (3 workers, 64
    steps a dispatch, B=100, lr 0.5), compress none, topk (1%, EF) and
    qint8 (EF), each for one budget of HOG_COMP_UPDATES updates, its
    smoothed test loss checked every HOG_COMP_CHECK_EVERY.  Each dispatch one
    mean-mode sync_epoch launch, no worker_grads; the best weights' test
    accuracy >= 0.70 and qint8's no more than COMP_ACC_GAP below the
    uncompressed fit's; updates/s and the bytes on the wire against their
    dense f32 equivalent; top-k's accuracy within COMP_ACC_GAP of the JAX
    engine's at the same settings instead (HOG_TOPK_JAX_ACC), both ways.
    Returns each codec's launches."""
    test_bound = SyncEngine(model, B, 0.0).bind(test)
    out = {}
    for label, kw in (("none", {}), ("topk", {"compress": "topk", "compress_k": COMP_K}),
                      ("qint8", {"compress": "qint8"})):
        m = Metrics()
        eng = hw.HogwildEngine(model, n_workers=RPC_WORKERS, batch_size=B,
                               learning_rate=RPC_LR, check_every=HOG_COMP_CHECK_EVERY,
                               backoff_s=0.05, seed=0, metrics=m, steps_per_dispatch=HOGWILD_K,
                               device="cuda", **kw)
        reset_counts()
        t0 = time.perf_counter()
        # the workers' step counter: the checks fall behind a fast fit
        fit = eng.fit(train, test, max_epochs=1, criterion=lambda hist, m=m: (
            m.counter("slave.async.batch").value >= HOG_COMP_UPDATES))
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches, mean_launches = se.sync_epoch.launches, se.sync_epoch.opt_launches["sgd"]
        wg_launches = wg.worker_grads.launches
        dispatches = m.counter("slave.async.batch").value // HOGWILD_K
        wire, dense = comms_counts(m)
        loss, acc = test_bound.evaluate(fit.weights)
        out[label] = {"launches": launches, "acc": acc, "updates": fit.state.updates}
        print(f"(b) Hogwild {label} (full width, {RPC_WORKERS} workers, k={HOGWILD_K}, B={B}, "
              f"lr {RPC_LR}): {fit.state.updates} updates in {fit_s:.3f} s = "
              f"{fit.state.updates / fit_s:.1f} updates/s; {dispatches} dispatches, sync_epoch "
              f"launches {launches} ({mean_launches} in the mean mode), worker_grads "
              f"{wg_launches}; comms.bytes_on_wire {wire} against comms.bytes_dense_equiv "
              f"{dense} ({dense / wire if wire else float('nan'):.2f}x); peer deltas dropped "
              f"{m.counter('slave.async.grad.dropped').value}; best weights' test loss "
              f"{loss:.7f} accuracy {acc:.7f}; {card_line()}", flush=True)
        if (launches, mean_launches, wg_launches) != (dispatches, dispatches, 0) or not dispatches:
            raise AssertionError(f"(b) Hogwild {label}: sync_epoch {launches} ({mean_launches} "
                                 f"mean mode), worker_grads {wg_launches} over {dispatches} "
                                 f"dispatches")
        if live_worker_threads():
            raise AssertionError(f"(b) Hogwild {label}: worker threads left")
        ref_acc = HOG_TOPK_JAX_ACC if label == "topk" else out["none"]["acc"]
        gap = acc - ref_acc
        print(f"(b) Hogwild {label}: accuracy {acc - out['none']['acc']:+.4f} from the "
              f"uncompressed fit's, {gap:+.4f} from "
              f"{'the JAX engine' if label == 'topk' else 'uncompressed'} ({ref_acc:.4f})",
              flush=True)
        if acc < ASYNC_ACC_FLOOR or gap < -COMP_ACC_GAP or (
                label == "topk" and gap > COMP_ACC_GAP):
            raise AssertionError(f"(b) Hogwild {label}: accuracy {acc} (want >= "
                                 f"{ASYNC_ACC_FLOOR} and within {COMP_ACC_GAP} of {ref_acc})")
        want_ratio = {"none": None, "topk": 20.0, "qint8": 3.5}[label]
        if (want_ratio is None) != (wire == 0) or (want_ratio and dense / wire < want_ratio):
            raise AssertionError(f"(b) Hogwild {label}: {wire} bytes on the wire for {dense} "
                                 f"dense")
    return out


def check_compressed_rpc(ref: dict) -> dict:
    """(c) The RPC sync fit over gRPC at full width (3 workers, B=100,
    lr 0.5, 1 epoch) with topk 1% + EF, against phase 8's knobs-off fit over
    the same windows: one worker_grads launch a body, accuracy >= 0.70 and
    no more than COMP_ACC_GAP below knobs off, windows/s and the reply
    bytes; then at
    RPC_SMALL_ROWS the compressed fit on the card against the same fit on
    the CPU, within COMP_CPU_ATOL.  Returns the launches."""
    train, test, model = ref["data"]
    m = Metrics()
    fit, loss0, (launches, se_launches), _ = rpc_fit(model, train, test, m, compress="topk",
                                                     compress_k=COMP_K)
    windows = m.counter("master.sync.rounds").value
    epoch_s = fit.epoch_seconds[0]
    acc = fit.test_accuracies[0]
    wire, dense = comms_counts(m)
    grad_bytes = m.counter("master.sync.grad.bytes").value
    parts = {label: m.histogram(name).mean * 1e3 for label, name in RPC_PART_HISTS}
    print(f"(c) rpc topk {COMP_K} + EF (full width, {RPC_WORKERS} workers, B={B}, lr {RPC_LR}, "
          f"1 epoch): test loss {fit.test_losses[0]:.7f} from {loss0:.6f}, accuracy {acc:.7f} "
          f"against {ref['test_acc']:.7f} knobs off; {windows} windows in {epoch_s:.3f} s = "
          f"{windows / epoch_s:.1f} windows/s ({ref['windows_per_s']:.1f} knobs off); "
          f"master.sync.grad.bytes {grad_bytes} ({ref['grad_bytes']} knobs off); "
          f"comms.bytes_on_wire {wire} against {dense} dense; worker_grads launches "
          f"{launches}, sync_epoch {se_launches}; {card_line()}", flush=True)
    print("(c) rpc topk ms a window: " + json.dumps({k: round(v, 4) for k, v in parts.items()}),
          flush=True)
    if launches != windows * RPC_WORKERS or se_launches != 0 or not windows:
        raise AssertionError(f"(c): {launches} worker_grads and {se_launches} sync_epoch "
                             f"launches over {windows} windows")
    if acc < RPC_ACC_FLOOR or acc < ref["test_acc"] - COMP_ACC_GAP or not (
            np.isfinite(np.asarray(fit.weights)).all()):
        raise AssertionError(f"(c): accuracy {acc} against {ref['test_acc']} knobs off")
    strain, stest, smodel = ref["small"]["data"]
    cpu_model = make_model("hinge", LAM, D, dim_sparsity=dim_sparsity(strain), device="cpu")
    fits = {}
    for dev, mdl in (("cuda", smodel), ("cpu", cpu_model)):
        t0 = time.perf_counter()
        fits[dev] = rpc_fit(mdl, strain, stest, compress="topk", compress_k=COMP_K)[0]
        print(f"(c) rpc topk {RPC_SMALL_ROWS}-row fit on {dev}: "
              f"{time.perf_counter() - t0:.2f} s, test loss {fits[dev].test_losses[0]:.7f}",
              flush=True)
    err = float(np.abs(np.asarray(fits["cuda"].weights) - np.asarray(fits["cpu"].weights)).max())
    off = float(np.abs(np.asarray(fits["cuda"].weights) - ref["small"]["weights"]).max())
    print(f"(c) rpc topk card against CPU ({RPC_SMALL_ROWS} rows): weights max_abs_err "
          f"{err:.3e}; max |dw| against the knobs-off fit {off:.3e}", flush=True)
    if err > COMP_CPU_ATOL or not np.allclose(fits["cuda"].test_losses, fits["cpu"].test_losses,
                                              rtol=1e-5, atol=0):
        raise AssertionError(f"(c): the compressed fit on the card is {err} from the CPU's")
    return {"launches": launches}


def check_health_halt(ref: dict, tmp: str) -> int:
    """(d) DSGD_HEALTH_ACTION=halt on the RPC sync fit at RPC_SMALL_ROWS
    (3 workers on the card, 1 epoch): worker 0's HEALTH_POISON_CALL-th
    Gradient body replies NaN.  The monitor trips, the round is not
    applied, the flight-*-health.json dump and the fit-state snapshot at
    that window are written and the fit stops; a restart resumes from the
    snapshot and completes the epoch, its test loss within HEALTH_LOSS_GAP
    of the knobs-off fit's; a third run finds nothing to run.  Returns the
    worker_grads launches of the two runs."""
    from distributed_sgd_tpu_torch.checkpoint import fit_state_path, restore_fit_state
    from distributed_sgd_tpu_torch.core.cluster import DevCluster
    from distributed_sgd_tpu_torch.core.split import vanilla_split
    from distributed_sgd_tpu_torch.telemetry.health import HealthMonitor
    from distributed_sgd_tpu_torch.trace import flight

    train, test, model = ref["small"]["data"]
    path = fit_state_path(tmp)
    total = -(-max(len(p) for p in vanilla_split(len(train), RPC_WORKERS)) // B)
    recorder = flight.get()
    flight.configure(capacity=recorder.capacity, service="phase16", dir=tmp)
    runs = []
    try:
        for label, poison in (("halted", True), ("resumed", False), ("again", False)):
            m = Metrics()
            monitor = HealthMonitor(metrics=m, action="halt")
            with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=m) as c:
                if poison:
                    real, seen = c.workers[0].compute_gradient, [0]

                    def poisoned(w, ids, real=real, seen=seen):
                        seen[0] += 1
                        g = real(w, ids)
                        return np.full_like(g, np.nan) if seen[0] == HEALTH_POISON_CALL else g

                    c.workers[0].compute_gradient = poisoned
                reset_counts()
                t0 = time.perf_counter()
                fit = c.master.fit_sync(1, B, RPC_LR, health=monitor, fit_state_path=path)
                torch.cuda.synchronize()
            fs = restore_fit_state(path, "sgd", [])
            runs.append((label, fit, monitor, m.counter("master.sync.rounds").value,
                         wg.worker_grads.launches, fs))
            print(f"(d) {label}: {time.perf_counter() - t0:.2f} s, epochs run {fit.epochs_run}, "
                  f"windows {runs[-1][3]}, worker_grads launches {runs[-1][4]}, tripped "
                  f"{monitor.tripped} ({monitor.trip_reason}); the snapshot at epoch {fs.epoch} "
                  f"window cursor {fs.batch}; test losses {fit.test_losses}", flush=True)
    finally:
        flight.configure(capacity=recorder.capacity, service=recorder.service,
                         dir=recorder.dir)
    (_, halted, mon, h_windows, h_launches, h_fs), (_, resumed, mon2, r_windows, r_launches,
                                                     r_fs), (_, again, _, a_windows, _, _) = runs
    dump = os.path.join(tmp, f"flight-phase16-{os.getpid()}-health.json")
    print(f"(d) the dump {os.path.basename(dump)} exists: {os.path.exists(dump)}; the resumed "
          f"fit's test loss {resumed.test_losses[0]:.7f} against {ref['small']['test_loss']:.7f} "
          f"knobs off; {card_line()}", flush=True)
    if not (mon.tripped and mon.trip_reason == "non_finite_grad" and os.path.exists(dump)):
        raise AssertionError("(d): the monitor did not trip on the NaN reply, or left no dump")
    if (halted.epochs_run, h_windows, h_fs.epoch, h_fs.batch) != (
            0, HEALTH_POISON_CALL, 0, (HEALTH_POISON_CALL - 1) * B) or not (
            np.array_equal(h_fs.weights, np.asarray(halted.weights))
            and np.isfinite(h_fs.weights).all()):
        raise AssertionError("(d): the halt did not stop at the tripped window with its snapshot")
    if (mon2.tripped or resumed.epochs_run != 1 or r_windows != total - HEALTH_POISON_CALL + 1
            or r_launches != r_windows * RPC_WORKERS or r_fs.epoch != 1
            or abs(resumed.test_losses[0] - ref["small"]["test_loss"]) > HEALTH_LOSS_GAP):
        raise AssertionError(f"(d): the restart did not resume from the snapshot and complete "
                             f"({r_windows} windows of {total}, epochs {resumed.epochs_run})")
    if a_windows != 0 or again.epochs_run != 1:
        raise AssertionError("(d): a third run found something to run")
    return h_launches + r_launches


def run_compression_phase(ref: dict) -> dict:
    """Phase 16; returns the launches of its paths."""
    t0 = time.perf_counter()
    check_topk_selection()
    train, test, model = ref["data"]
    hog = run_compressed_hogwild(train, test, model)
    rpc = check_compressed_rpc(ref)
    with tempfile.TemporaryDirectory(prefix="dsgd-health-") as tmp:
        health = check_health_halt(ref, tmp)
    print(f"compression phase seconds: {time.perf_counter() - t0:.1f} "
          f"(budget {COMP_BUDGET_S})", flush=True)
    return {"hogwild": {k: v["launches"] for k, v in hog.items()}, "rpc": rpc["launches"],
            "health": health}


CHAOS_PLAN = "scenario:flaky-rack"  # drop 3%, delay 2-20 ms, dup 2%, seed 23
CHAOS_ROWS = 162000  # both fits train on the first 162,000 train rows: 540 windows
CHAOS_QUORUM, CHAOS_SOFT_S, CHAOS_GRAD_TIMEOUT_S = 2, 0.4, 2.0  # tests/test_chaos.py's soak
CHAOS_ACC_FLOOR, CHAOS_ACC_GAP = 0.70, 0.02
CHAOS_KINDS = ("drop", "delay", "dup", "error", "partition")
# the flywheel at the dev role's window and horizon (main.py
# _run_dev_flywheel, the CLI's defaults); the shift moves from row 4,096
# (= the window, where serving starts: no pre-shift traffic at all) to
# 8,192, so half the 8,192 served rows precede it.  The stream is 4,096
# features wide, not the dev role's 16,384: there the initial fit's mean
# loss over the served rows goes from 0.6641 before the shift to 0.9863
# after it, 1.485x, under the detector's 1.5x bar, in the JAX package as
# in the port (tests/test_torch_flywheel.py, the same bits), so a trip
# rode on the probes' sampling noise (about 1 run in 5 never tripped, on
# the card and on the CPU); at 4,096 it is 0.5518 to 0.9775, 1.772x
FLY_WINDOW, FLY_HORIZON, FLY_SHIFT_AT = 4096, 12288, 8192
FLY_FEATURES = 4096
FLY_CLIENTS = 32  # the pump's concurrent clients (Flywheel.pump sends one row at a time)
FLY_CHUNK = 64
# shortened timing knobs (the CLI's 1.0 s poll, 5.0 s cooldown, 2.0 s refresh)
FLY_POLL_S, FLY_COOLDOWN_S, FLY_REFRESH_S = 0.2, 1.0, 0.5
FLY_WARMUP_WAIT_S = 120  # the pre-shift warm-up refreshes must land within this
FLY_SETTLE_S = 180
SPIN_ROWS = 100000  # the spin-up workers' slice of the full-width corpus
SPIN_LOCAL_STEPS = 4  # the warm-up's K-step window: sync_epoch's sum mode
SPIN_TIMEOUT_S = 300
LIFE_BUDGET_S = 100  # printed against the phase's time, not gated

# one spin-up: a worker over SPIN_ROWS rows on the card, the warm-up with
# DSGD_COMPILE_CACHE set, then its first Gradient reply, timed from the
# process's start; nvcc runs are counted through _build.nvcc_command
SPIN_CHILD = """
import time
t0 = time.perf_counter()
import hashlib, json, sys
import numpy as np
from distributed_sgd_tpu_torch import compile_cache
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import SparseSVM, make_model
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import coeff as co
from distributed_sgd_tpu_torch.ops import sync_epoch as se
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import WorkerStub, new_channel
from distributed_sgd_tpu_torch.utils import metrics as mm

rows, bs, k = int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
nvcc = []
real = _build.nvcc_command
_build.nvcc_command = lambda name, out, rule=None: nvcc.append(name) or real(name, out, rule)
cfg = Config.from_env()
if cfg.compile_cache:
    compile_cache.configure(cfg.compile_cache)
data = rcv1_like(rows, seed=0, idf_values=True)
model = make_model("hinge", 1e-5, data.n_features, dim_sparsity=dim_sparsity(data),
                   device="cuda")
worker = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, data, model)
worker.server.start()
t_warm = time.perf_counter()
if cfg.compile_cache:
    compile_cache.warmup_async("spinup", worker.warmup_thunks(bs, k)).join()
t_warm = time.perf_counter() - t_warm
warm_launches = (wg.worker_grads.launches, se.sync_epoch.launches)
w = (np.random.default_rng(1).normal(size=data.n_features) * 0.01).astype(np.float32)
channel = new_channel("127.0.0.1", worker.port)
reply = WorkerStub(channel).Gradient(pb.GradientRequest(
    samples=np.arange(bs, dtype=np.int32), weights=codec.encode_tensor(w)), timeout=120)
first = time.perf_counter() - t0
channel.close()
worker.stop()
m = mm.global_metrics()
print(json.dumps({"first_reply_s": first, "warmup_s": t_warm,
                  "sha": hashlib.sha256(reply.SerializeToString()).hexdigest(),
                  "hits": m.counter(mm.COMPILE_CACHE_HITS).value,
                  "misses": m.counter(mm.COMPILE_CACHE_MISSES).value, "nvcc": nvcc,
                  "warm_launches": warm_launches,
                  "launches": (wg.worker_grads.launches, se.sync_epoch.launches)}))
"""


def chaos_fit(train, test, model, plan=None) -> dict:
    """One fit of CHAOS_ROWS rows' windows under `plan` (clear sky when
    None) with the soak's quorum settings; returns its numbers."""
    from distributed_sgd_tpu_torch import chaos
    from distributed_sgd_tpu_torch.autopilot import window_split
    from distributed_sgd_tpu_torch.core.cluster import DevCluster
    from distributed_sgd_tpu_torch.utils import metrics as mm

    g = global_metrics()
    before = {k: g.counter(f"chaos.injected.{k}").value for k in CHAOS_KINDS}
    m = Metrics()
    with DevCluster(model, train, test, n_workers=RPC_WORKERS, seed=0, metrics=m,
                    chaos=plan) as c:
        reset_counts()
        fit = c.master.fit_sync(1, B, RPC_LR, split=window_split(0, CHAOS_ROWS),
                                grad_timeout_s=CHAOS_GRAD_TIMEOUT_S, quorum=CHAOS_QUORUM,
                                straggler_soft_s=CHAOS_SOFT_S)
        launches = wg.worker_grads.launches
        members = len(c.master.members)
    windows = m.counter("master.sync.rounds").value
    out = {"acc": fit.test_accuracies[0], "loss": fit.test_losses[0], "windows": windows,
           "windows_per_s": windows / fit.epoch_seconds[0], "launches": launches,
           "members": members, "evictions": m.counter(mm.MASTER_EVICTIONS).value,
           "degraded": m.counter(mm.QUORUM_DEGRADED).value,
           "hedges": m.counter(mm.QUORUM_HEDGES).value,
           "late": m.counter(mm.QUORUM_LATE).value,
           "injected": {k: g.counter(f"chaos.injected.{k}").value - before[k]
                        for k in CHAOS_KINDS},
           "left_installed": chaos.state() is not None}
    print(f"chaos fit {plan or 'clear sky'} (full width, {RPC_WORKERS} workers, B={B}, "
          f"quorum {CHAOS_QUORUM}, soft {CHAOS_SOFT_S} s, {CHAOS_ROWS:,} rows): "
          + json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                        for k, v in out.items()}), flush=True)
    return out


def check_chaos_fit(full_data, card: str) -> dict:
    """(a): the clear-sky fit, then the same windows under the plan."""
    train, test, model = full_data
    clear = chaos_fit(train, test, model)
    storm = chaos_fit(train, test, model, CHAOS_PLAN)
    print(f"chaos windows/s on {card}: clear sky {clear['windows_per_s']:.2f}, "
          f"{CHAOS_PLAN} {storm['windows_per_s']:.2f}", flush=True)
    for label, r in (("clear", clear), ("storm", storm)):
        if r["members"] != RPC_WORKERS or r["evictions"] or r["left_installed"]:
            raise AssertionError(f"chaos {label}: {r['members']} members, {r['evictions']} "
                                 f"evictions, plan left installed: {r['left_installed']}")
        if r["launches"] < r["windows"] * CHAOS_QUORUM:
            raise AssertionError(f"chaos {label}: {r['launches']} worker_grads launches over "
                                 f"{r['windows']} windows")
    if any(clear["injected"].values()):
        raise AssertionError(f"the clear-sky fit injected faults: {clear['injected']}")
    missing = [k for k in ("drop", "delay", "dup") if storm["injected"][k] <= 0]
    if missing:
        raise AssertionError(f"{CHAOS_PLAN} injected no {missing}: {storm['injected']}")
    if storm["acc"] < CHAOS_ACC_FLOOR or storm["acc"] < clear["acc"] - CHAOS_ACC_GAP:
        raise AssertionError(f"chaos: accuracy {storm['acc']:.4f} under weather against "
                             f"{clear['acc']:.4f} clear (want >= {CHAOS_ACC_FLOOR} and at most "
                             f"{CHAOS_ACC_GAP} below)")
    return {"clear": clear["launches"], "storm": storm["launches"]}


def pump_clients(fly, n: int) -> list:
    """``Flywheel.pump``'s traffic -- the next `n` stream rows as Predict
    requests, features only -- from FLY_CLIENTS clients at once, row i on
    client i mod FLY_CLIENTS (a request a row, as the fleet's router sees a
    fleet of users); returns the dropped requests' errors.  One row at a
    time the fleet's 5 ms coalescing window sets the pace: 8,192 rows would
    take ~100 s."""
    from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
    from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel

    n = min(n, fly.horizon_rows - fly.stream_time)
    rows = fly.stream.rows(fly.stream_time, n)
    dropped = []

    def client(c):
        channel = new_channel("127.0.0.1", fly.fleet.router_port)
        stub = ServeStub(channel)
        for i in range(c, n, FLY_CLIENTS):
            try:
                stub.Predict(pb.PredictRequest(indices=np.asarray(rows.indices[i], np.int32),
                                               values=np.asarray(rows.values[i], np.float32)),
                             timeout=10.0)
            except Exception as e:  # noqa: BLE001 - counted: the zero-drop check
                dropped.append(repr(e))
        channel.close()

    threads = [threading.Thread(target=client, args=(c,)) for c in range(FLY_CLIENTS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    fly.served += n
    return dropped


def check_flywheel(card: str) -> dict:
    """(b): the flywheel on the card at the dev role's window and horizon,
    FLY_FEATURES wide."""
    from distributed_sgd_tpu_torch.autopilot import DriftDetector, DriftingStream, Flywheel

    cfg = Config()  # the CLI's defaults
    stream = DriftingStream(n_features=FLY_FEATURES, seed=cfg.seed, shift_at=FLY_SHIFT_AT)
    detector = DriftDetector(ratio=cfg.autopilot_drift_ratio,
                             patience=cfg.autopilot_drift_patience,
                             warmup=cfg.autopilot_drift_warmup,
                             abs_floor=cfg.autopilot_drift_floor)
    m = Metrics()
    t0 = time.perf_counter()
    events, retrain_s = [], []
    reset_counts()
    with tempfile.TemporaryDirectory(prefix="dsgd-flywheel-") as tmp:
        fly = Flywheel(
            stream, horizon_rows=FLY_HORIZON, window_rows=FLY_WINDOW, model=cfg.model,
            lam=cfg.lam, n_workers=2, n_replicas=2, max_epochs=cfg.max_epochs,
            batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
            patience=cfg.patience, conv_delta=cfg.conv_delta,
            probe_capacity=cfg.autopilot_probe_capacity,
            label_delay=cfg.autopilot_label_delay, source_refresh_s=FLY_REFRESH_S,
            canary_fraction=0.5, detector=detector, poll_s=FLY_POLL_S,
            cooldown_s=FLY_COOLDOWN_S, canary_timeout_s=cfg.autopilot_canary_timeout_s,
            max_retrains=cfg.autopilot_max_retrains,
            recovery_band=cfg.autopilot_recovery_band, seed=cfg.seed, ckpt_dir=tmp,
            metrics=m, device="cuda")
        ctl = fly.controller
        to, retrain = ctl._to, ctl.retrain

        def logged_to(state, **info):
            events.append((round(time.perf_counter() - t0, 3), state))
            to(state, **info)

        def timed_retrain():
            t1 = time.perf_counter()
            try:
                return retrain()
            finally:
                retrain_s.append(round(time.perf_counter() - t1, 3))

        ctl._to, ctl.retrain = logged_to, timed_retrain
        fly.start()
        start_s = time.perf_counter() - t0
        try:
            dropped = pump_clients(fly, FLY_SHIFT_AT - fly.stream_time)
            pre_s = time.perf_counter() - t0
            deadline = time.monotonic() + FLY_WARMUP_WAIT_S
            while ctl._consumed <= detector.warmup:
                if time.monotonic() > deadline:
                    raise AssertionError(f"flywheel: {ctl._consumed} probe losses after "
                                         f"{FLY_WARMUP_WAIT_S} s of pre-shift traffic")
                time.sleep(0.05)
            pre = list(fly.fleet.router.probe_losses())
            t_shift = time.perf_counter() - t0
            dropped += pump_clients(fly, FLY_HORIZON - fly.stream_time)
            post_s = time.perf_counter() - t0
            # the horizon is served: run() only waits for the controller
            summary = fly.run(chunk=FLY_CHUNK, settle_timeout_s=FLY_SETTLE_S)
            summary["dropped"] += len(dropped)
            # a retrain whose window still straddled the shift rolls back
            # (or half-recovers); the controller's residual rule retrains
            # again on newer rows, hands-free: wait for its promotion
            deadline = time.monotonic() + FLY_SETTLE_S
            while time.monotonic() < deadline and not (
                    m.counter(AUTOPILOT_PROMOTED).value >= 1 and ctl.state == "SERVING"):
                time.sleep(0.2)
            summary.update(retrains=ctl.retrains, state=ctl.state,
                           promoted=int(m.counter(AUTOPILOT_PROMOTED).value),
                           rolled_back=int(m.counter(AUTOPILOT_ROLLED_BACK).value),
                           probe_losses=fly.fleet.router.probe_losses())
        finally:
            fly.stop()
    launches = wg.worker_grads.launches
    left = [t.name for t in threading.enumerate() if "autopilot" in t.name]
    promoted_at = next((t for t, state in events if state == "PROMOTED"), None)
    print(f"flywheel on {card}: " + json.dumps(
        {k: v for k, v in summary.items() if k != "probe_losses"}), flush=True)
    print(f"flywheel: started (initial fit, fleet up) in {start_s:.2f} s; pre-shift rows "
          f"served by {pre_s:.2f} s; pre-shift probe losses {[round(x, 4) for x in pre]}; "
          f"shift's first served row at {t_shift:.2f} s, the last at {post_s:.2f} s; "
          f"transitions {events}; retrain seconds {retrain_s}; shift to promotion "
          f"{(promoted_at - t_shift) if promoted_at else float('nan'):.2f} s; worker_grads "
          f"launches {launches}", flush=True)
    served = FLY_HORIZON - FLY_WINDOW
    if (summary["dropped"] or summary["served"] != served or summary["retrains"] < 1
            or summary["promoted"] < 1 or summary["state"] != "SERVING" or left):
        raise AssertionError(f"flywheel: {summary} (want 0 dropped, {served} served, >= 1 "
                             f"retrain and promotion, SERVING), threads left {left}")
    if launches <= 0:
        raise AssertionError("flywheel: no worker_grads launch")
    return {"launches": launches}


def spin_up(label: str, cache) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "DSGD_COMPILE_CACHE"}
    if cache:
        env["DSGD_COMPILE_CACHE"] = cache
    out = subprocess.run([sys.executable, "-c", SPIN_CHILD, str(SPIN_ROWS), str(B),
                          str(SPIN_LOCAL_STEPS)], env=env, capture_output=True, text=True,
                         timeout=SPIN_TIMEOUT_S, cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode != 0:
        raise AssertionError(f"spin-up {label} exited {out.returncode}:\n{out.stderr[-4000:]}")
    r = json.loads(out.stdout.strip().splitlines()[-1])
    print(f"spin-up {label}: " + json.dumps(r), flush=True)
    return r


def spin_up_here() -> dict:
    """SPIN_CHILD's worker and first reply in this process, with the
    compile cache unset: the libraries of phase 2's build in _build/."""
    from distributed_sgd_tpu_torch import compile_cache
    from distributed_sgd_tpu_torch.core.worker import WorkerNode
    from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
    from distributed_sgd_tpu_torch.rpc.service import WorkerStub, new_channel

    if compile_cache.enabled():
        raise AssertionError("spin-up: the compile cache is on in the smoke's own process")
    t0 = time.perf_counter()
    reset_counts()
    data = rcv1_like(SPIN_ROWS, seed=0, idf_values=True)
    model = make_model("hinge", LAM, data.n_features, dim_sparsity=dim_sparsity(data),
                       device="cuda")
    worker = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, data, model)
    worker.server.start()
    w = (np.random.default_rng(1).normal(size=data.n_features) * 0.01).astype(np.float32)
    channel = new_channel("127.0.0.1", worker.port)
    try:
        reply = WorkerStub(channel).Gradient(pb.GradientRequest(
            samples=np.arange(B, dtype=np.int32), weights=codec.encode_tensor(w)), timeout=120)
    finally:
        channel.close()
        worker.stop()
    r = {"first_reply_s": time.perf_counter() - t0,
         "sha": hashlib.sha256(reply.SerializeToString()).hexdigest(),
         "launches": (wg.worker_grads.launches, se.sync_epoch.launches)}
    print("spin-up off (this process): " + json.dumps(r), flush=True)
    return r


def check_spin_up(card: str) -> dict:
    """(c): cold and warm worker processes, then knobs off here."""
    with tempfile.TemporaryDirectory(prefix="dsgd-compile-cache-") as cache:
        cold = spin_up("cold", cache)
        files = sorted(os.listdir(cache))
        warm = spin_up("warm", cache)
        off = spin_up_here()
        after = sorted(os.listdir(cache))
    print(f"spin-up first Gradient reply on {card}: cold {cold['first_reply_s']:.2f} s "
          f"(warm-up {cold['warmup_s']:.2f} s), warm {warm['first_reply_s']:.2f} s (warm-up "
          f"{warm['warmup_s']:.2f} s), knobs off in this process (from its data) "
          f"{off['first_reply_s']:.2f} s; cache files {files}", flush=True)
    if (cold["misses"], cold["hits"], sorted(cold["nvcc"])) != (2, 0, sorted(_build.KERNELS)):
        raise AssertionError(f"spin-up cold: {cold} (want 2 misses, both kernels built)")
    if (warm["misses"], warm["hits"], warm["nvcc"]) != (0, 2, []):
        raise AssertionError(f"spin-up warm: {warm} (want 2 hits, 0 misses, no nvcc)")
    if after != files or len(files) != 2:
        raise AssertionError(f"spin-up: the cache changed: {files} -> {after}")
    if not cold["sha"] == warm["sha"] == off["sha"]:
        raise AssertionError("spin-up: the first replies differ between cold, warm and off")
    return {"wg": [r["launches"][0] for r in (cold, warm, off)],
            "se": [r["launches"][1] for r in (cold, warm, off)]}


def run_lifecycle_phase(full_data, card: str) -> dict:
    """Phase 17; returns the launches of its paths."""
    t0 = time.perf_counter()
    out = {"chaos": check_chaos_fit(full_data, card)}
    t1 = time.perf_counter()
    out["flywheel"] = check_flywheel(card)
    t2 = time.perf_counter()
    out["spin"] = check_spin_up(card)
    t3 = time.perf_counter()
    print(f"lifecycle phase seconds: {t3 - t0:.1f} ((a) {t1 - t0:.1f}, (b) {t2 - t1:.1f}, "
          f"(c) {t3 - t2:.1f}; budget {LIFE_BUDGET_S}) on {card}", flush=True)
    return out


# -- phase 18: the text corpus ------------------------------------------------

CORPUS_SEED = 0
CORPUS_EPOCHS = 2
CORPUS_MIN_FREE_BYTES = 2 * 10 ** 9  # the full-scale corpus is ~0.96 GB of text
CORPUS_TRUNC_PAD = 32  # a forced pad width under the train file's max nnz: it truncates
# the port's CLI on the seed-0 corpus on the CPU (tools/corpus_fit.py --device
# cpu, run on the GPU host's CPU): test accuracy 0.9080 after 2 epochs (test
# losses 0.1984, 0.1877).  The CPU and the card draw their sample ids from
# different generators, so the floor is the CPU's less the 0.03 band that
# tests/test_torch_trainer.py allows fits with their own ids
CORPUS_CPU_ACC = 0.9080
CORPUS_ACC_FLOOR = CORPUS_CPU_ACC - 0.03
# the card's test losses and accuracies after each epoch of that fit, the
# same bits in every run (NVIDIA H100 80GB HBM3, 700 W): held to 7 digits.
# The 2nd epoch's loss rises.  That is the draw's, not the kernel's
# (tools/corpus_fit.py --witness, sampling seeds 0-4): the CPU given the
# card's ids gives these numbers to 3e-10, rising too, and the 2nd epoch
# rises for 4 of 5 seeds on the card and 2 of 5 with the CPU's own ids
CORPUS_LOSS_ACC = [[0.2017463, 0.2065195], [0.9007726, 0.8985474]]
DATA_GATE_S = 40.0  # the reference's gate: all 804,414 rows in < 40 s; printed, not gated
CORPUS_BUDGET_S = 75  # printed against the phase's time, not gated


def same_bits(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()
        for x, y in zip(a, b))


def check_parser_route() -> None:
    """(a): build (or load) the native parser; the python route is refused."""
    from distributed_sgd_tpu_torch.data import _native

    t0 = time.perf_counter()
    loaded = _native.native_loaded()
    seconds = time.perf_counter() - t0
    built = _native.last_build
    if built:
        print(f"corpus (a) the native parser built in {built['seconds']:.2f} s ({seconds:.2f} s "
              f"with the toolchain's fingerprint): {' '.join(built['command'])}", flush=True)
    else:
        print(f"corpus (a) the native parser loaded in {seconds:.2f} s: "
              f"{getattr(_native._lib, '_name', None)}", flush=True)
    if not loaded:
        raise AssertionError("corpus: the native parser did not load (at full scale the "
                             "python route would take minutes)")


def write_corpus(folder: str, card: str) -> dict:
    """(b): the reference's 804,414 rows, 47,236 features and qrels, as
    text, after a check of the free disk."""
    from distributed_sgd_tpu_torch.data.corpus import N_ROWS_FULL, write_rcv1_corpus

    usage = shutil.disk_usage(folder)
    print(f"corpus (b) {folder}: {usage.free:,} bytes free of {usage.total:,}", flush=True)
    if usage.free < CORPUS_MIN_FREE_BYTES:
        raise AssertionError(f"corpus: {usage.free:,} bytes free, want "
                             f"{CORPUS_MIN_FREE_BYTES:,} for the full-scale corpus")
    t0 = time.perf_counter()
    meta = write_rcv1_corpus(folder, seed=CORPUS_SEED)
    seconds = time.perf_counter() - t0
    print(f"corpus (b) write_rcv1_corpus (seed {CORPUS_SEED}): {meta['n_rows']:,} rows, "
          f"{meta['bytes']:,} B of vectors, {meta['nnz_per_row']:.2f} tokens a row, "
          f"{meta['n_ccat']:,} CCAT, in {seconds:.2f} s on {card}", flush=True)
    if meta["n_rows"] != N_ROWS_FULL or meta["n_rows"] != MAIN_ROWS:
        raise AssertionError(f"corpus: {meta['n_rows']} rows written")
    return meta


def check_corpus_parity(folder: str) -> None:
    """(c): on the 23,149-row train file, the native parse at 1 thread and
    at the host's threads equals the python parse bit for bit, and the
    native pack equals numpy's, lossless and at a width that truncates."""
    from distributed_sgd_tpu_torch.data import _native
    from distributed_sgd_tpu_torch.data import rcv1

    path = os.path.join(folder, "lyrl2004_vectors_train.dat")
    t0 = time.perf_counter()
    py = rcv1.parse_svm_file_py(path)
    py_s = time.perf_counter() - t0
    native_s = {}
    for n_threads in (1, 0):
        t0 = time.perf_counter()
        out = _native.parse_svm_file(path, n_threads=n_threads)
        native_s[n_threads] = time.perf_counter() - t0
        if out is None or not same_bits(out, py):
            raise AssertionError(f"corpus: the native parse at n_threads={n_threads} differs "
                                 f"from the python parse on the train file")
    _, row_ptr, col_idx, values = py
    max_nnz = int(np.diff(row_ptr).max())
    packs = []
    for p in (max_nnz, CORPUS_TRUNC_PAD):
        t0 = time.perf_counter()
        native = _native.pack_csr(row_ptr, col_idx, values, p)
        t1 = time.perf_counter()
        plain = rcv1.pack_csr_numpy(row_ptr, col_idx, values, p)
        t2 = time.perf_counter()
        if native[2] != plain[2] or not same_bits(native[:2], plain[:2]):
            raise AssertionError(f"corpus: the native pack at width {p} differs from numpy's "
                                 f"({native[2]} and {plain[2]} rows truncated)")
        packs.append(f"width {p}: {native[2]:,} rows truncated, native {t1 - t0:.3f} s, "
                     f"numpy {t2 - t1:.3f} s")
    print(f"corpus (c) the train file ({len(py[0]):,} rows, {len(values):,} entries, max nnz "
          f"{max_nnz}): python parse {py_s:.3f} s, native {native_s[1]:.3f} s at 1 thread, "
          f"{native_s[0]:.3f} s at {os.cpu_count()}; all bitwise equal; packs equal bitwise, "
          + "; ".join(packs), flush=True)


def run_corpus_cli(folder: str, card: str) -> int:
    """(d): ``main()`` over the text files (DSGD_DATA_PATH, DSGD_FULL=1,
    2 epochs, the CLI's defaults otherwise): 804,414 rows through the
    native parse (5 files) and pack, one ``sync_epoch`` launch an epoch,
    no ``worker_grads``, the test loss below 1.0 (its value at w = 0)
    after each epoch, the losses and accuracies CORPUS_LOSS_ACC's to 7
    digits and the accuracy at least CORPUS_ACC_FLOOR.  Returns the
    launches."""
    from distributed_sgd_tpu_torch.data import _native
    from distributed_sgd_tpu_torch.tools.corpus_fit import fit_from_text

    spent = {"parse": [0, 0.0], "pack": [0, 0.0]}
    real = {"parse": _native.parse_svm_file, "pack": _native.pack_csr}

    def timed(key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return real[key](*a, **kw)
            finally:
                spent[key][0] += 1
                spent[key][1] += time.perf_counter() - t0
        return run

    _native.parse_svm_file, _native.pack_csr = timed("parse"), timed("pack")
    try:
        reset_counts()
        t0 = time.perf_counter()
        run, rows = fit_from_text(folder, CORPUS_EPOCHS)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches, steps_run = se.sync_epoch.launches, se.sync_epoch.steps
        wg_launches = wg.worker_grads.launches
    finally:
        _native.parse_svm_file, _native.pack_csr = real["parse"], real["pack"]
    fit = run.fit
    print(f"corpus (d) the CLI from text files (DSGD_DATA_PATH, DSGD_FULL=1, "
          f"DSGD_MAX_EPOCHS={CORPUS_EPOCHS}): {rows:,} rows; data seconds "
          f"{run.data_seconds:.3f} (the reference's gate {DATA_GATE_S:.0f} s, not gated), of "
          f"which {spent['parse'][0]} native parses {spent['parse'][1]:.3f} s and "
          f"{spent['pack'][0]} pack {spent['pack'][1]:.3f} s; epoch seconds "
          f"{[round(s, 4) for s in fit.epoch_seconds]}; test losses {fit.test_losses} "
          f"accuracies {fit.test_accuracies}; sync_epoch launches {launches} over "
          f"{steps_run} steps, worker_grads launches {wg_launches}; {total_s:.2f} s in all on "
          f"{card}", flush=True)
    if rows != MAIN_ROWS or spent["parse"][0] != 5 or spent["pack"][0] != 1:
        raise AssertionError(f"corpus: {rows} rows through {spent['parse'][0]} native parses "
                             f"and {spent['pack'][0]} packs; want {MAIN_ROWS}, 5 and 1")
    if fit.epochs_run != CORPUS_EPOCHS or fit.steps_per_epoch != STEPS:
        raise AssertionError(f"corpus: ran {fit.epochs_run} epochs of {fit.steps_per_epoch} "
                             f"steps, want {CORPUS_EPOCHS} of {STEPS}")
    if (launches, steps_run, wg_launches) != (CORPUS_EPOCHS, CORPUS_EPOCHS * STEPS, 0):
        raise AssertionError(f"corpus: sync_epoch launched {launches} times over {steps_run} "
                             f"steps and worker_grads {wg_launches} times; want "
                             f"{CORPUS_EPOCHS}, {CORPUS_EPOCHS * STEPS} and 0")
    # at w = 0 every hinge prediction is 0 and the test loss is 1
    if not all(loss < 1.0 for loss in fit.test_losses):
        raise AssertionError(f"corpus: the test loss did not fall from 1.0: {fit.test_losses}")
    got = np.array([fit.test_losses, fit.test_accuracies])
    if not np.allclose(got, CORPUS_LOSS_ACC, rtol=0, atol=1e-6):
        raise AssertionError(f"corpus: test losses and accuracies {got.tolist()} differ from "
                             f"{CORPUS_LOSS_ACC} in the 7th digit")
    w = fit.weights
    if w.shape != (D,) or not bool(torch.isfinite(w).all()):
        raise AssertionError(f"corpus: final weights not finite f32[{D}]: {w.shape}")
    if fit.test_accuracies[-1] < CORPUS_ACC_FLOOR:
        raise AssertionError(f"corpus: test accuracy {fit.test_accuracies[-1]:.4f} below "
                             f"{CORPUS_ACC_FLOOR:.4f} (the CPU's {CORPUS_CPU_ACC} less 0.03)")
    return launches


def run_corpus_phase(card: str) -> int:
    """Phase 18; returns the CLI's sync_epoch launches."""
    t0 = time.perf_counter()
    check_parser_route()
    t1 = time.perf_counter()
    folder = tempfile.mkdtemp(prefix="dsgd-corpus-")
    try:
        write_corpus(folder, card)
        t2 = time.perf_counter()
        check_corpus_parity(folder)
        t3 = time.perf_counter()
        launches = run_corpus_cli(folder, card)
        t4 = time.perf_counter()
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(card)
    print(f"corpus phase seconds: {time.perf_counter() - t0:.1f} ((a) {t1 - t0:.1f}, (b) "
          f"{t2 - t1:.1f}, (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}; budget {CORPUS_BUDGET_S}) on "
          f"{card}", flush=True)
    return launches


# -- phase 19: a model's own coefficient and the examples ----------------------

COEFF_STEPS = 20  # steps of the sync_epoch variant's checks against the plain version
# the custom-model example's learning rate, with the CLI's lambda (l2): at
# full width its 1e-4 makes lam ||w||^2 outgrow the squared hinge's fall
COEFF_LR = 0.1
COEFF_SMALL_ROWS = 20000  # the RPC and Hogwild fits of (c): 16,000 train rows
# the fault-2 check: the variant's 20 steps from the plain version within
# SE_ATOL, and from hinge's at least this far (the rules differ on every
# sample with -0.5 <= y*m < 0)
COEFF_HINGE_GAP = 1e-3
# the feature-sharded example's workers x shards: 2 ranks on the card (2 x 2
# before a depth cut; phase 15 (d) runs the dp x tp engine on two ranks too)
COEFF_FS_GRID = (1, 2)
COEFF_BUDGET_S = 60  # printed against the phase's time, not gated
EXAMPLES = ("train_single_chip", "custom_model", "train_async_hogwild", "train_dense",
            "train_feature_sharded", "serve_predict")


class ShiftedSVM(SparseSVM):
    """The reference hinge model with its subgradient's switch moved from
    y*m < 0 to y*m < -0.5: a SparseSVM subclass with a rule of its own,
    which must train by that rule and not by hinge's (the second fault
    ops/coeff.py repairs)."""

    coeff_cuda = "return (y * m < -0.5f) ? 0.f : y;"

    def grad_coeff(self, margins, y):
        yf = y.float()
        return torch.where(yf * margins < -0.5, torch.zeros_like(yf), yf)


def same_nonfinite(got: torch.Tensor, want: torch.Tensor) -> bool:
    """The same NaN entries and the same infinities (a margin through an
    infinite value is NaN, and so is every term of a user rule there)."""
    inf = torch.isinf(want)
    return bool(torch.equal(torch.isnan(got), torch.isnan(want))
                and torch.equal(torch.isinf(got), inf) and torch.equal(got[inf], want[inf]))


def user_counts() -> tuple:
    return wg.worker_grads.user_launches, se.sync_epoch.user_launches


def reset_user_counts() -> None:
    wg.worker_grads.user_launches = se.sync_epoch.user_launches = 0


def build_coeff_variants(rules) -> float:
    """(a) Both kernels' variants for each rule, every nvcc started
    together; prints the seconds, the libraries and the ptxas reports."""
    t0 = time.perf_counter()
    reports, errors = {}, []

    def one(rule):
        try:
            reports[rule.name] = _build.build(_build.KERNELS, rule)
        except Exception as e:  # noqa: BLE001 - raised below, in this thread
            errors.append(e)

    threads = [threading.Thread(target=one, args=(r,)) for r in rules]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    seconds = time.perf_counter() - t0
    print(f"(a) the variants of {[r.name for r in rules]} built in {seconds:.2f} s: "
          f"{[_build.library_path(n, r).name for r in rules for n in _build.KERNELS]}",
          flush=True)
    for name, by_kernel in reports.items():
        for kernel, report in by_kernel.items():
            print(f"{name} {kernel} nvcc report:\n{report.strip()}", flush=True)
    if sorted(len(v) for v in reports.values()) != [2] * len(rules):
        raise AssertionError(f"(a): want every variant compiled here, got {reports.keys()}")
    return seconds


def check_coeff_worker_grads(rule) -> dict:
    """(b) The worker_grads variant against its plain version at K=1 and
    K=8 (and on a non-finite term), 40 launches one output each, timed;
    returns the rows by K."""
    rng = np.random.default_rng(19)
    rows = {}
    for k in (1, 8):
        ds = rcv1_like(k * B, n_features=D, nnz=P, seed=10 + k, idf_values=True)
        idx, val = ds.indices.reshape(k, B, P), ds.values.reshape(k, B, P)
        y = ds.labels.reshape(k, B).astype(np.float32)
        w = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
        args = [w] + [torch.from_numpy(a).cuda() for a in (idx, val, y)] + [rule]
        got, want = wg.worker_grads(*args), wg.worker_grads_plain(*args)
        outs = {digest(wg.worker_grads(*args)) for _ in range(WG_REPEATS)}
        err = float((got - want).abs().max())
        ok = bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())
        kernel = lambda: wg.worker_grads(*args)  # noqa: E731
        plain = lambda: wg.worker_grads_plain(*args)  # noqa: E731
        plain_ms = [time_ms(plain)]
        kernel_ms = [time_ms(kernel), time_ms(kernel)]
        plain_ms.append(time_ms(plain))
        nz = val != 0
        bytes_moved = idx.nbytes + val.nbytes + y.nbytes + 4 * len(np.unique(idx[nz])) + 4 * k * D
        flops = 4 * int(nz.sum()) + 8 * k * B  # as the built-in row: the rule is a few per sample
        bound_bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
        bound_ops_ms = flops / F32_FLOPS * 1e3
        print(f"(b) worker_grads {rule.name} K={k}: max_abs_err={err:.3e} (rtol {RTOL}, atol "
              f"{ATOL}); {len(outs)} distinct output(s) of {WG_REPEATS} launches; "
              f"{min(kernel_ms) * 1e3:.2f} us a call (runs "
              f"{[round(t * 1e3, 2) for t in kernel_ms]}), plain "
              f"{[round(t * 1e3, 2) for t in plain_ms]} us", flush=True)
        if not ok or len(outs) != 1:
            raise AssertionError(f"worker_grads {rule.name} K={k}: max abs err {err}, "
                                 f"{len(outs)} distinct outputs")
        rows[k] = {
            "name": f"worker_grads (user coefficient {rule.name}, K={k})", "route": "cuda",
            "source": "distributed_sgd_tpu_torch/csrc/worker_grads.cu", "replaces": TPU_KERNEL,
            "launches": None, "max_abs_err": err,
            "ms": min(kernel_ms), "plain_ms": min(plain_ms),
            "bound_ms": max(bound_bytes_ms, bound_ops_ms),
            "bound_by": "bytes" if bound_bytes_ms >= bound_ops_ms else "operations",
            "library_ms": None,  # no single PyTorch call computes the fused function
        }
    # a non-finite term: one value inf, the plain version's inf at its feature
    idx = np.arange(B * P, dtype=np.int32).reshape(1, B, P) % D
    val = np.full((1, B, P), 0.5, np.float32)
    val[0, 3, 5] = np.inf
    y = np.ones((1, B), np.float32)
    args = [torch.zeros(D, device="cuda")] + [torch.from_numpy(a).cuda() for a in (idx, val, y)]
    got, want = wg.worker_grads(*args, rule), wg.worker_grads_plain(*args, rule)
    fin = torch.isfinite(want)
    if not (same_nonfinite(got, want) and int((~fin).sum()) > 0
            and bool(((got[fin] - want[fin]).abs() <= ATOL + RTOL * want[fin].abs()).all())):
        raise AssertionError(f"worker_grads {rule.name}: a non-finite term came out other than "
                             f"the plain version's")
    return rows


def se_bound(ids: np.ndarray, row_nnz: np.ndarray, per_feature_step: int,
             reg_kind: str) -> tuple:
    """(bound ms, bound_by) of sync_epoch on `ids`: each sampled row, the
    ids and w read once (and dim_sparsity, where `reg_kind` reads it), w
    written once; a mul and an add a nonzero for the margin and the
    scatter, and `per_feature_step` operations a feature and step in the
    sweep."""
    vectors = 3 if reg_kind == "dim_sparsity" else 2
    bytes_moved = len(np.unique(ids)) * (8 * P + 4) + ids.nbytes + vectors * 4 * D
    flops = 4 * int(row_nnz[ids].sum()) + ids.shape[0] * D * per_feature_step
    by_bytes, by_ops = bytes_moved / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


def check_coeff_sync_epoch(rule, data: dict, row_nnz: np.ndarray) -> dict:
    """(b) The sync_epoch variant against its plain version at full width:
    sgd K=3 (20 steps; a full epoch timed), K=4 B=150 (two rounds a step,
    the kept coefficients), the mean mode K=1 (a 64-step dispatch), the
    K=4 sum window and a non-finite term; 40 launches one output per
    route.  Returns the rows by route."""
    rng = np.random.default_rng(23)
    n = data["indices"].shape[0]
    w_rand = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
    sub = -(-n // K)
    thirds = np.minimum(sub, n - np.arange(K) * sub)[:, None]
    epoch = rng.integers(0, sub, (STEPS, K, B)) % thirds + (np.arange(K) * sub)[:, None]

    def launch_args(ids, **extra):
        args = (w_rand, torch.from_numpy(ids).cuda(), data["indices"], data["values"],
                data["labels_f32"])
        kw = dict(coeff=rule, reg_kind="l2", lam=LAM, dim_sparsity=None,
                  lr=COEFF_LR, n_total_workers=ids.shape[1])
        return args, dict(kw, **extra)

    routes = {  # label -> (ids, extra kw, launches timed, sweep operations a feature and step)
        "sgd K=3": (epoch, {}, 1, 2 * K + 4),
        "mean K=1": (rng.integers(0, sub, (HOGWILD_K, 1, B)), {"grad_divisor": B}, 50, 3 + 4),
        "window K=4": (rng.integers(0, n, (WINDOW_K, 1, B)), {}, 100, 2 + 3),
    }
    def optimizer(kind):
        opt = se.Optimizer(kind)
        return dict(optimizer=opt, opt_state=se.init_opt_state(opt, D, "cuda"),
                    lr=OPT_LR[kind])

    def flat(out):  # w, then the optimizer's state vectors
        return torch.cat([out[0], *out[1].vectors]) if isinstance(out, tuple) else out

    checks = [("sgd K=3", epoch[:COEFF_STEPS], {}),
              ("K=4 B=150", rng.integers(0, n, (COEFF_STEPS, 4, 150)), {}),
              ("momentum K=3", epoch[:COEFF_STEPS], optimizer("momentum")),
              ("adam K=3", epoch[:COEFF_STEPS], optimizer("adam")),
              ("mean K=1", routes["mean K=1"][0], {"grad_divisor": B}),
              ("window K=4", routes["window K=4"][0], {})]
    errs = {}
    for label, ids, extra in checks:
        args, kw = launch_args(ids, **extra)
        got, want = flat(se.sync_epoch(*args, **kw)), flat(se.sync_epoch_plain(*args, **kw))
        outs = {digest(flat(se.sync_epoch(*args, **kw))) for _ in range(SE_REPEATS)}
        err = float((got - want).abs().max())
        print(f"(b) sync_epoch {rule.name} {label} ({ids.shape[0]} steps): max_abs_err="
              f"{err:.3e} (atol {SE_ATOL}), weights moved "
              f"{float((want[:D] - w_rand).abs().max()):.3e};"
              f" {len(outs)} distinct output(s) of {SE_REPEATS} launches", flush=True)
        if not err <= SE_ATOL or len(outs) != 1:
            raise AssertionError(f"sync_epoch {rule.name} {label}: max abs err {err}, "
                                 f"{len(outs)} distinct outputs")
        errs[label] = err
    for label, k, extra in (("sgd K=3", K, {}), ("adam K=3", K, "adam"),
                            ("mean K=1", 1, {"grad_divisor": B})):
        def user_args(d, ids, extra=extra):
            args, kw = launch_args(ids, **(optimizer(extra) if extra == "adam" else extra))
            return (args[0], args[1], d["indices"], d["values"], d["labels_f32"]), kw

        errs[label] = max(errs.get(label, 0.0), check_sweep_cases(
            f"{rule.name} {label}", data, (k, B), user_args, flat, steps=COEFF_STEPS))
    # a non-finite term, one step from w = 0, as phase 3's
    vals = data["values"].clone()
    vals[int(epoch[0, 0, 0]), 0] = float("inf")
    args, kw = launch_args(epoch[:1])
    args = (torch.zeros(D, device="cuda"), args[1], data["indices"], vals, data["labels_f32"])
    got, want = se.sync_epoch(*args, **kw), se.sync_epoch_plain(*args, **kw)
    fin = torch.isfinite(want)
    if not (same_nonfinite(got, want) and int((~fin).sum()) > 0
            and float((got[fin] - want[fin]).abs().max()) <= SE_ATOL):
        raise AssertionError(f"sync_epoch {rule.name}: a non-finite term came out other than "
                             f"the plain version's")
    del vals
    outs = {digest(se.sync_epoch(*launch_args(epoch)[0], **launch_args(epoch)[1]))
            for _ in range(SE_REPEATS)}
    if len(outs) != 1:
        raise AssertionError(f"sync_epoch {rule.name} full epoch: {len(outs)} distinct outputs")

    rows = {}
    for label, (ids, extra, iters, per_feature) in routes.items():
        args, kw = launch_args(ids, **extra)
        kernel = lambda: se.sync_epoch(*args, **kw)  # noqa: E731
        plain = lambda: se.sync_epoch_plain(*args, **kw)  # noqa: E731
        p_iters = max(1, iters // 10)
        plain_ms = [time_ms(plain, iters=p_iters, warmup=1)]
        kernel_ms = [time_ms(kernel, iters=iters, warmup=1),
                     time_ms(kernel, iters=iters, warmup=1)]
        plain_ms.append(time_ms(plain, iters=p_iters, warmup=1))
        bound_ms, bound_by = se_bound(ids, row_nnz, per_feature, kw["reg_kind"])
        print(f"(b) sync_epoch {rule.name} {label} timed ({ids.shape[0]} steps): "
              f"{[round(t, 4) for t in kernel_ms]} ms a launch, plain "
              f"{[round(t, 4) for t in plain_ms]} ms, bound {bound_ms:.6f} ms ({bound_by})",
              flush=True)
        rows[label] = {
            "name": f"sync_epoch (user coefficient {rule.name}, {label})", "route": "cuda",
            "source": "distributed_sgd_tpu_torch/csrc/sync_epoch.cu", "replaces": TPU_KERNEL,
            "launches": None, "max_abs_err": errs[label],
            "ms": min(kernel_ms), "plain_ms": min(plain_ms),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,  # no single PyTorch call runs the steps
        }
    return rows


def run_coeff_paths(model_cls, train: Dataset, test: Dataset) -> dict:
    """(c) The user rule through the engines, counts from 0: a full-width
    1-epoch sync fit (one sync_epoch variant launch, the loss finite and
    falling), the per-step path (8 workers, worker_grads at K=8), and at
    COEFF_SMALL_ROWS the RPC fit (a K=1 Gradient body a reply), its K=4
    window and Hogwild (the mean mode).  Returns the variant launches by
    route."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    def model():
        return model_cls(LAM, D, regularizer="l2", device="cuda")

    launches = {}
    reset_user_counts()
    eng = SyncEngine(model(), B, COEFF_LR, virtual_workers=K, device="cuda")
    bound, bound_test = eng.bind(train), eng.bind(test)
    w0 = torch.zeros(D, device="cuda")
    loss0 = bound_test.evaluate(w0)[0]
    t0 = time.perf_counter()
    w = bound.epoch(w0, psync.fold_in(0, 0))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    loss, acc = bound_test.evaluate(w)
    launches["sgd K=3"] = user_counts()[1]
    print(f"(c) {model_cls.__name__} sync fit, full width, 1 epoch of {bound.steps_per_epoch} "
          f"steps: {fit_s:.3f} s, test loss {loss0:.7f} -> {loss:.7f}, accuracy {acc:.4f}; "
          f"variant launches (worker_grads, sync_epoch) {user_counts()}", flush=True)
    if not (math.isfinite(loss) and loss < loss0) or user_counts() != (0, 1):
        raise AssertionError(f"(c): the {model_cls.__name__} fit's loss {loss0} -> {loss}, "
                             f"variant launches {user_counts()} (want (0, 1))")
    del bound, bound_test

    reset_user_counts()
    eng = SyncEngine(model(), B, COEFF_LR, virtual_workers=PER_STEP_WORKERS, device="cuda")
    bound = eng.bind(train)
    assert not bound.epoch_kernel, "8 workers at D=47,236 take the per-step path"
    w = bound.epoch(w0, psync.fold_in(0, 0))
    launches["K=8"] = user_counts()[0]
    print(f"(c) per-step path ({PER_STEP_WORKERS} workers, 1 epoch): variant launches "
          f"{user_counts()}", flush=True)
    if user_counts() != (bound.steps_per_epoch, 0) or not bool(torch.isfinite(w).all()):
        raise AssertionError(f"(c) per-step path: variant launches {user_counts()}")
    del bound

    small_train = Dataset(train.indices[:COEFF_SMALL_ROWS], train.values[:COEFF_SMALL_ROWS],
                          train.labels[:COEFF_SMALL_ROWS], D)
    for steps, label in ((1, "K=1"), (WINDOW_K, "window K=4")):
        reset_user_counts()
        with DevCluster(model(), small_train, test, n_workers=RPC_WORKERS, seed=0) as c:
            loss0 = c.master.local_loss(np.zeros(D, np.float32), test=True)[0]
            fit = c.master.fit_sync(1, B, COEFF_LR, local_steps=steps)
        launches[label] = user_counts()[0 if steps == 1 else 1]
        print(f"(c) RPC fit, {COEFF_SMALL_ROWS:,} rows, local_steps {steps}: test loss "
              f"{loss0:.7f} -> {fit.test_losses[-1]:.7f}; variant launches {user_counts()}",
              flush=True)
        if not (fit.test_losses[-1] < loss0 and launches[label] > 0 and
                user_counts()[1 if steps == 1 else 0] == 0):
            raise AssertionError(f"(c) RPC fit local_steps {steps}: {user_counts()}")

    reset_user_counts()
    eng = hw.HogwildEngine(model(), n_workers=RPC_WORKERS, batch_size=B,
                           learning_rate=COEFF_LR, steps_per_dispatch=HOGWILD_K, device="cuda")
    res = eng.fit(small_train, test, max_epochs=1)
    launches["mean K=1"] = user_counts()[1]
    print(f"(c) Hogwild, {COEFF_SMALL_ROWS:,} rows, k={HOGWILD_K}: {res.state.updates} "
          f"updates, best test loss {res.state.loss:.7f}; variant launches {user_counts()}",
          flush=True)
    if user_counts()[0] != 0 or launches["mean K=1"] < 1 or not math.isfinite(res.state.loss):
        raise AssertionError(f"(c) Hogwild: variant launches {user_counts()}")
    return launches


def check_shifted_svm(data: dict, train: Dataset) -> None:
    """(d) A SparseSVM subclass with its own rule trains by that rule on
    the card: 20 steps of its variant against its plain version, and
    away from hinge's kernel; a 1-epoch fit through the engine, one
    variant launch, away from hinge's on the same ids."""
    rng = np.random.default_rng(29)
    ids = torch.from_numpy(rng.integers(0, data["indices"].shape[0], (COEFF_STEPS, K, B))).cuda()
    w0 = torch.tensor(rng.normal(size=D).astype(np.float32) * 0.1, device="cuda")
    shifted = ShiftedSVM(LAM, D, regularizer="l2", device="cuda")
    kw = dict(reg_kind="l2", lam=LAM, dim_sparsity=None, lr=0.5, n_total_workers=K)
    args = (w0, ids, data["indices"], data["values"], data["labels_f32"])
    got = se.sync_epoch(*args, coeff=shifted.coeff, **kw)
    want = se.sync_epoch_plain(*args, coeff=shifted.coeff, **kw)
    hinge = se.sync_epoch(*args, coeff=co.HINGE, **kw)
    err, gap = float((got - want).abs().max()), float((got - hinge).abs().max())
    fits = {}
    for cls in (ShiftedSVM, SparseSVM):
        reset_user_counts()
        eng = SyncEngine(cls(LAM, D, regularizer="l2", device="cuda"), B, 0.5,
                         virtual_workers=K, device="cuda")
        fits[cls.__name__] = (eng.bind(train).epoch(torch.zeros(D, device="cuda"),
                                                    psync.fold_in(0, 0)), user_counts())
    fit_gap = float((fits["ShiftedSVM"][0] - fits["SparseSVM"][0]).abs().max())
    print(f"(d) ShiftedSVM(SparseSVM), {COEFF_STEPS} steps: variant vs its plain version "
          f"max_abs_err={err:.3e} (atol {SE_ATOL}), vs hinge's kernel {gap:.3e}; 1-epoch fits "
          f"through the engine: ShiftedSVM vs SparseSVM weights {fit_gap:.3e}, variant launches "
          f"{fits['ShiftedSVM'][1]} and {fits['SparseSVM'][1]}", flush=True)
    if not (err <= SE_ATOL and gap >= COEFF_HINGE_GAP and fit_gap >= COEFF_HINGE_GAP
            and fits["ShiftedSVM"][1] == (0, 1) and fits["SparseSVM"][1] == (0, 0)):
        raise AssertionError("(d): the SparseSVM subclass did not train by its own rule")


def run_examples() -> dict:
    """(e) The six examples_torch mains on the card, in this process (the
    feature-sharded one starts its ranks); returns the variant launches of
    the custom-model example and each main's seconds."""
    import importlib

    mains = {name: importlib.import_module(f"examples_torch.{name}").main for name in EXAMPLES}
    out, seconds = {}, {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        reset_user_counts()
        if name == "train_feature_sharded":
            got = mains[name](workers=COEFF_FS_GRID[0], shards=COEFF_FS_GRID[1])
        else:
            got = mains[name]()
        seconds[name] = round(time.perf_counter() - t0, 2)
        out[name] = (got, user_counts())
        ok = math.isfinite(got) and {"train_dense": got < 1.0, "serve_predict": got > 1}.get(
            name, True)
        if not ok or (user_counts() != (0, 0)) != (name == "custom_model"):
            raise AssertionError(f"(e) {name}: returned {got}, variant launches {user_counts()}")
    print(f"(e) examples_torch on the card: {json.dumps(out)}; seconds {json.dumps(seconds)}",
          flush=True)
    return {"custom_model": out["custom_model"][1][1], "seconds": seconds}


def run_coeff_phase(card: str) -> list:
    """Phase 19; returns the summary rows of the user-coefficient routes."""
    from examples_torch.custom_model import SquaredHinge

    t0 = time.perf_counter()
    sqh = SquaredHinge(LAM, D, regularizer="l2", device="cuda")
    rule = sqh.coeff
    build_s = build_coeff_variants([rule, ShiftedSVM(LAM, D, regularizer="l2",
                                                     device="cuda").coeff])
    t1 = time.perf_counter()
    with rows_of(MAIN_ROWS) as (train, test, _):
        data = on_card(train)
        row_nnz = (train.values != 0).sum(axis=1)
        wg_rows = check_coeff_worker_grads(rule)
        se_rows = check_coeff_sync_epoch(rule, data, row_nnz)
        t2 = time.perf_counter()
        launches = run_coeff_paths(SquaredHinge, train, test)
        t3 = time.perf_counter()
        check_shifted_svm(data, train)
        del data
    t4 = time.perf_counter()
    ex = run_examples()
    t5 = time.perf_counter()
    wg_rows[1]["launches"], wg_rows[8]["launches"] = launches["K=1"], launches["K=8"]
    se_rows["sgd K=3"]["launches"] = launches["sgd K=3"]
    se_rows["mean K=1"]["launches"] = launches["mean K=1"]
    se_rows["window K=4"]["launches"] = launches["window K=4"]
    se_rows["sgd K=3"]["path"] = (f"full-width fit {launches['sgd K=3']}; the custom-model "
                                  f"example (K=1, D=2,048, 5 epochs) {ex['custom_model']}")
    print(card)
    print(f"coefficient phase seconds: {time.perf_counter() - t0:.1f} ((a) {t1 - t0:.1f} of "
          f"which nvcc {build_s:.1f}, (b) {t2 - t1:.1f}, (c) {t3 - t2:.1f}, (d) {t4 - t3:.1f}, "
          f"(e) {t5 - t4:.1f}; budget {COEFF_BUDGET_S}) on {card}", flush=True)
    return [wg_rows[1], wg_rows[8]] + [se_rows[k] for k in ("sgd K=3", "mean K=1", "window K=4")]


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
    if "sync_epoch" in reports:
        print("sync_epoch ptxas, this design: " + "; ".join(
            line.split(":", 1)[-1].strip() for line in reports["sync_epoch"].splitlines()
            if "registers" in line or "spill" in line) + f"; the design it replaced: "
              f"{REPLACED_SE_PTXAS}", flush=True)

    share_synthetic_rows()

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
    se_row["launches"], main_w, main_test = run_main_path()
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
    rpc_async_launches = run_async_rpc_phase(rpc_full.pop("async_cli"))
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

    phase("12 online serving: Predict on the card, hot swap, weight push, the canary fleet "
          "and the serve and route roles")
    run_serving_phase(main_w, main_test)

    phase("13 the aggregation tree and the sharded master")
    config5 = start_config5_rows()  # phase 14's rows, made beside this phase
    tree = run_tree_phase(rpc_full)
    comp_ref = {k: rpc_full[k] for k in ("data", "small", "test_acc", "windows_per_s",
                                         "grad_bytes")}
    del rpc_full
    wg_row["path"] += f"; phase 13 at {RPC_SMALL_ROWS:,} rows, 1 epoch each: tree " + (
        f"{tree['tree'][0]}, ") + ", ".join(
        f"{label} {tree[label][0]}" for label, _ in SMALL_TREE_FITS) + (
        f", kill_shard ({SHARD_KILL_ROWS:,} rows) {tree['kill_shard']}")
    k_label = next(label for label, kw in TREE_FITS if "local_steps" in kw)
    window_row["path"] += f"; phase 13 {k_label} (full width, 1 epoch) {tree[k_label][1]}"

    phase("14 the telemetry scrape and the rest of the model: BASELINE configs 3 and 5")
    model = run_model_phase(main_w, main_test, config5)
    del config5
    pg_w = main_w
    del main_w, main_test
    se_row["path"] += (f"; phase 14 config 3 (logistic, l2, full width, {CFG3_EPOCHS} epochs) "
                       f"{model['cfg3']}; config 5 (dense) {model['dense_sync_epoch']}")
    wg_row["path"] += (f"; phase 14 telemetry fit ({TEL_ROWS:,} rows, 1 epoch) "
                       f"{model['telemetry']}; config 5 (dense) {model['dense_worker_grads']}")

    phase("15 the process group: NCCL at one rank, two gloo ranks on the card, the in-host "
          "group and the dp x tp engine")
    pg = run_process_group_phase(pg_w)
    del pg_w
    se_row["path"] += f"; phase 15 (a) the main path in an NCCL group of one rank {pg['nccl']}"
    wg_row["path"] += (f"; phase 15 (b) {PG_WORLD} gloo ranks, K={K} a rank, 1 epoch (full "
                       f"width) {pg['ranks']} a rank; (c) HostMeshEngine on 2 devices "
                       f"{pg['hier']} a Gradient body; (d) dp x tp 0")

    phase("16 gradient compression and the training-health monitor")
    comp = run_compression_phase(comp_ref)
    full_data = comp_ref["data"]
    del comp_ref
    mean_row["path"] += (f"; phase 16 (b) Hogwild at full width, k={HOGWILD_K}, one budget: "
                         + ", ".join(f"{label} {n}" for label, n in comp["hogwild"].items()))
    wg_row["path"] += (f"; phase 16 (c) rpc topk {COMP_K} + EF (full width, 1 epoch) "
                       f"{comp['rpc']}; (d) the health halt and its resume ({RPC_SMALL_ROWS:,} "
                       f"rows) {comp['health']}")

    phase("17 fault injection, the autopilot and the spin-up fast path")
    life = run_lifecycle_phase(full_data, card)
    del full_data
    wg_row["path"] += (f"; phase 17 (a) {CHAOS_ROWS:,} rows' windows clear sky "
                       f"{life['chaos']['clear']}, under {CHAOS_PLAN} {life['chaos']['storm']} "
                       f"(hedges included); (b) the flywheel's initial fit and retrains "
                       f"{life['flywheel']['launches']}; (c) spin-up cold, warm, knobs off "
                       f"(warm-up and first reply) {life['spin']['wg']}")
    window_row["path"] += (f"; phase 17 (c) spin-up warm-ups (K={SPIN_LOCAL_STEPS}) cold, warm, "
                           f"knobs off {life['spin']['se']}")

    phase("18 the text corpus: the native parser, the corpus writer and the CLI from text files")
    corpus_launches = run_corpus_phase(card)
    se_row["path"] += (f"; phase 18 the CLI from the text corpus (804,414 rows, "
                       f"{CORPUS_EPOCHS} epochs) {corpus_launches}")

    phase("19 a model's own coefficient and the examples")
    coeff_rows = run_coeff_phase(card)

    phase("20 summary")
    print(card)
    print(json.dumps({"kernels": [wg_row, se_row, mean_row, opt_rows["momentum"],
                                  opt_rows["adam"], window_row] + coeff_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)

if __name__ == "__main__":
    main()
