"""One rank of a two-rank gloo world on a card: the sync engine and the
dp x tp engine at full width, host-local.

    python -m distributed_sgd_tpu_torch.tools.process_group_ranks <dir> <rank> <world> <port>

Every rank joins a gloo process group on ``127.0.0.1:<port>`` (gloo, not
NCCL: NCCL refuses two ranks on one device, and this is how one card runs
a world of two) and works on ``cuda:0``.  ``<dir>`` holds the train and
test rows as ``.npy`` files (``train_indices.npy`` ... ``test_labels.npy``,
``dim_sparsity.npy``) and ``meta.json`` (``lam``, ``batch``, ``lr``,
``virtual_workers``, ``seed``, ``steps_first``, ``timed_steps``,
``fs_steps``).  Each
rank maps the files and loads only what it holds:

1. the sync engine, ``SyncEngine.bind_host_local`` of its half of the
   padded rows, ``virtual_workers`` workers a rank: one epoch on the
   per-step path (a ``worker_grads`` launch a step, then one all_reduce of
   the ``[D]`` sum), the weights saved after ``steps_first`` steps and at
   the epoch's end, the test split's evaluation, the launches counted,
   and ``timed_steps`` more steps split by CUDA events into
   ``worker_grads``, the regularizer with the all_reduce, and the update;
2. the dp x tp engine at W = 1, F = 2: each rank its half of the
   features, the first ``fs_steps`` steps of an epoch (no kernel: plain
   torch around one all_reduce a step), the gathered weights after
   ``steps_first`` steps and at the end, the test split's evaluation.

Each rank writes ``<dir>/rank<r>.npz``: the epoch's ids (as drawn), the
weights, the evaluations, the seconds and the launch counts.  The caller
holds them against one process's fits on the same rows
(``chip_smoke.py`` phase 15).  Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops import sync_epoch as se
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.parallel import multihost
from distributed_sgd_tpu_torch.parallel.feature_sharded import FeatureShardedEngine, make_mesh_2d
from distributed_sgd_tpu_torch.parallel.mesh import all_reduce_sum
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, fold_in


def _mapped(d: str, split: str) -> Dataset:
    """The split's rows as read-only maps of its .npy files."""
    arr = {k: np.load(os.path.join(d, f"{split}_{k}.npy"), mmap_mode="r")
           for k in ("indices", "values", "labels")}
    return Dataset(arr["indices"], arr["values"], arr["labels"],
                   int(np.load(os.path.join(d, "n_features.npy"))))


def _reader(data: Dataset):
    """A row reader over mapped rows: each call copies [start, stop) in."""
    return lambda start, stop: Dataset(np.array(data.indices[start:stop]),
                                       np.array(data.values[start:stop]),
                                       np.array(data.labels[start:stop]), data.n_features)


def _timed_parts(bound, w: torch.Tensor, ids: torch.Tensor) -> dict:
    """Microseconds a step of the per-step path, by part (CUDA events):
    the worker_grads launch, the regularizer and the all_reduce of the
    [D] sum, the update.  The weights are not kept."""
    m, d = bound.model, bound.data
    names = ("worker_grads", "all_reduce", "update")
    spent = dict.fromkeys(names, 0.0)
    for rows in ids:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        gk = wg.worker_grads(w, d.indices[rows], d.values[rows], bound._labels_f32[rows],
                             m.coeff)
        ev[1].record()
        g = all_reduce_sum(m.regularize(gk, w).sum(dim=0), bound.group) / (
            bound.n_workers * bound.virtual_workers)
        ev[2].record()
        w = w - bound.learning_rate * g
        ev[3].record()
        ev[3].synchronize()
        for i, name in enumerate(names):
            spent[name] += ev[i].elapsed_time(ev[i + 1]) * 1000.0
    return {k: v / len(ids) for k, v in spent.items()}


def run(d: str, r: int, world: int, port: int) -> None:
    with open(os.path.join(d, "meta.json")) as f:
        meta = json.load(f)
    device = multihost.initialize(f"127.0.0.1:{port}", world, r, backend="gloo",
                                  device="cuda:0")
    train, test = _mapped(d, "train"), _mapped(d, "test")
    ds = np.load(os.path.join(d, "dim_sparsity.npy"))
    model = make_model("hinge", meta["lam"], train.n_features, dim_sparsity=ds, device=device)
    first = meta["steps_first"]
    out = {}

    # 1. the sync engine: this rank's half of the padded rows, host-local
    eng = SyncEngine(model, meta["batch"], meta["lr"], virtual_workers=meta["virtual_workers"],
                     device=device)
    t0 = time.perf_counter()
    bound = eng.bind_host_local(_reader(train), len(train), train.n_features,
                                train.indices.shape[1])
    test_bound = eng.bind_host_local(_reader(test), len(test), test.n_features,
                                     test.indices.shape[1])
    out["sync_bind_s"] = time.perf_counter() - t0
    ids = bound._sample_ids(fold_in(fold_in(meta["seed"], 0), r))
    wg.worker_grads.launches = 0
    se.sync_epoch.launches = 0
    w0 = torch.zeros(train.n_features, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    w = bound._run(w0, ids[:first])
    torch.cuda.synchronize()
    out["sync_w_first"] = w.cpu().numpy()
    w = bound._run(w, ids[first:])
    torch.cuda.synchronize()
    out["sync_epoch_s"] = time.perf_counter() - t0
    out["sync_worker_grads"] = wg.worker_grads.launches
    out["sync_sync_epoch"] = se.sync_epoch.launches
    out["sync_ids"] = ids.cpu().numpy()
    out["sync_w"] = w.cpu().numpy()
    out["sync_test"] = np.array(test_bound.evaluate(w))
    out["sync_shard_n"] = bound.shard_n
    parts = _timed_parts(bound, w, ids[:meta["timed_steps"]])
    for k, v in parts.items():
        out[f"sync_us_{k}"] = v

    # 2. the dp x tp engine, W = 1 x F = 2: each rank half the features
    grid = make_mesh_2d(1, world, device=device)
    t0 = time.perf_counter()
    fs = FeatureShardedEngine(model, grid, meta["batch"], meta["lr"]).bind(train)
    fs_test = FeatureShardedEngine(model, grid, meta["batch"], meta["lr"]).bind(test)
    out["fs_bind_s"] = time.perf_counter() - t0
    fids = fs._sample_ids(fold_in(fold_in(meta["seed"], 0), grid.worker_index))
    out["fs_epoch_steps"] = len(fids)
    fids = fids[:meta["fs_steps"]]
    wg.worker_grads.launches = 0
    se.sync_epoch.launches = 0
    wf = fs.init_weights()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for s in fids[:first]:
        wf = fs._step(wf, s)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    out["fs_w_first"] = fs.to_dense(wf)
    t0 = time.perf_counter()
    for s in fids[first:]:
        wf = fs._step(wf, s)
    torch.cuda.synchronize()
    out["fs_epoch_s"] = t_first + time.perf_counter() - t0
    out["fs_launches"] = wg.worker_grads.launches + se.sync_epoch.launches
    out["fs_ids"] = fids.cpu().numpy()
    out["fs_w"] = fs.to_dense(wf)
    out["fs_test"] = np.array(fs_test.evaluate(wf))
    out["fs_bounds"] = np.array([fs.lo, fs.hi])
    np.savez(os.path.join(d, f"rank{r}.npz"), **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    run(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
