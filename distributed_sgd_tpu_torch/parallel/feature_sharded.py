"""Feature-sharded (tensor-parallel) sync SGD over two process groups.

The port of the JAX package's parallel/feature_sharded.py.  The JAX engine
runs the sync engine's step over a 2-D mesh ('workers', 'features'); the
port lays the same grid over the ranks of the default process group: rank
``w * F + f`` is data rank w and feature rank f (the JAX mesh's device
order), and `make_mesh_2d` builds the two groups each rank reduces over,
its feature group (the F ranks of its data rank) and its data group (the
W ranks of its feature rank).

- weights: each feature rank holds its contiguous slice of the flat
  ``[D]`` vector.  The JAX engine holds rows of the lane-blocked
  ``[R, 128]`` view, 8-aligned; the port's bounds are those rows times
  128, clipped to D, so both hold the same features;
- data: the rank's data shard of the padded row layout (parallel/sync.py
  ``padded_layout``), loaded alone (``load_host_shard``), the same on every
  feature rank of a data rank;
- gather: each rank's partial margins over the features it owns (an entry
  of another slice contributes 0), all-reduced over the feature group;
- coeff: computed on every rank (cheap, no broadcast);
- scatter: into the rank's own slice, no collective;
- regularize: 'l2' is local; 'dim_sparsity' (SparseSVM.scala:31) needs
  the global dot ``w . dimSparsity``: the slices' partial dots are
  all-reduced over the feature group, in the same all_reduce as the
  partial margins (the JAX engine's two psums, one collective), then the
  ``g != 0`` mask;
- reduce: the mean over the data group, then ``w - lr*g``.

Dense-layout rows (Dataset.dense) are column tiles: each rank holds the
columns of its slice, the partial margins are a ``[B, D/F] @ [D/F]``
matvec, and the gradient ``coeff @ x`` lands in the local slice (JAX
``_step_dense``).

No kernel of the port serves this path: the fused ``worker_grads`` and
``sync_epoch`` kernels go from the gather to the scatter inside one
launch, and here the partial margins are all-reduced between the two.
The JAX engine computes it with XLA one-hot matmuls outside any Pallas
kernel; the port runs plain torch, as for the dense layout.

Each data rank's ids come from a generator on its device seeded by the
epoch key folded with the data rank, so a data rank's F feature ranks
draw the same ids.  `fit`, `evaluate` and `predict` keep the JAX engine's
contracts; checkpoints use the 1-D SyncTrainer's snapshot (dense weights,
the newest-first test losses), so a feature-sharded fit resumes in the
SyncTrainer and back.  Every rank restores; rank 0 alone writes.
"""

from __future__ import annotations

import logging
import math
import time
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_sgd_tpu_torch.checkpoint import (
    for_rank,
    restore_sync_fit,
    save_sync_fit,
    save_sync_fit_final,
)
from distributed_sgd_tpu_torch.convert import LANES, n_blocks
from distributed_sgd_tpu_torch.core.grad_state import GradState
from distributed_sgd_tpu_torch.core.trainer import FitResult, record_epoch
from distributed_sgd_tpu_torch.data.host_shard import dataset_reader, load_host_shard
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.parallel.mesh import (
    DeviceLike,
    all_gather_cat,
    all_reduce_sum,
    barrier,
    distributed,
    rank,
    resolve_device,
    world_size,
)
from distributed_sgd_tpu_torch.parallel.sync import fold_in, padded_layout

log = logging.getLogger("dsgd.trainer")


class Mesh2D(NamedTuple):
    """This rank's place on the W x F grid and the two groups it reduces
    over (None without a process group: a grid of one)."""

    n_workers: int
    n_shards: int
    worker_index: int
    shard_index: int
    feature_group: object
    worker_group: object
    device: torch.device


def make_mesh_2d(n_workers: int, n_feature_shards: int, device: DeviceLike = None) -> Mesh2D:
    """The W x F grid over the first W * F ranks of the default process
    group, rank ``w * F + f`` at (w, f).  Every rank of the group must call
    it (each group is made by all of them); a rank past W * F is off the
    grid and raises."""
    need = n_workers * n_feature_shards
    world = world_size()
    if world < need:
        raise ValueError(f"need {need} devices, have {world}")
    device = resolve_device(device)
    r = rank()
    fgroup = wgroup = None
    if distributed():
        for w in range(n_workers):
            g = dist.new_group([w * n_feature_shards + f for f in range(n_feature_shards)])
            if r // n_feature_shards == w:
                fgroup = g
        for f in range(n_feature_shards):
            g = dist.new_group([w * n_feature_shards + f for w in range(n_workers)])
            if r % n_feature_shards == f:
                wgroup = g
    if r >= need:
        raise ValueError(f"rank {r} is off the {n_workers} x {n_feature_shards} grid")
    return Mesh2D(n_workers, n_feature_shards, r // n_feature_shards, r % n_feature_shards,
                  fgroup, wgroup, device)


class FeatureShardedEngine:
    """dp x tp sync engine: this rank's slice of the weights, its data
    shard."""

    def __init__(self, model: LinearModel, mesh: Mesh2D, batch_size: int,
                 learning_rate: float):
        if model.device != mesh.device:
            raise ValueError(f"model lives on {model.device}, the grid on {mesh.device}")
        self.model = model
        self.mesh = mesh
        self.device = mesh.device
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.n_workers = mesh.n_workers
        self.n_shards = mesh.n_shards
        d = model.n_features
        # the JAX engine's 8-aligned row ranges of the blocked view, in
        # features
        r = n_blocks(d)
        self.r_total = -(-r // (8 * self.n_shards)) * 8 * self.n_shards
        self.r_local = self.r_total // self.n_shards
        width = self.r_local * LANES
        self.lo = min(mesh.shard_index * width, d)
        self.hi = min(self.lo + width, d)
        self._width = width
        ds = model.dim_sparsity
        self._ds = ds[self.lo:self.hi] if ds is not None else None

    # -- collectives -----------------------------------------------------------

    def _sum_features(self, t: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(t, self.mesh.feature_group) if self.n_shards > 1 else t

    def _mean_workers(self, t: torch.Tensor) -> torch.Tensor:
        if self.n_workers == 1:
            return t
        return all_reduce_sum(t, self.mesh.worker_group) / self.n_workers

    # -- the step ------------------------------------------------------------

    def _owned(self, idx: torch.Tensor, val: torch.Tensor):
        """(slice-local ids, values) of padded rows, entries of other slices
        mapped to id 0 with value 0."""
        local = idx.long() - self.lo
        owned = (local >= 0) & (local < self.hi - self.lo)
        return torch.where(owned, local, 0), torch.where(owned, val, 0.0)

    def _partial(self, w_local: torch.Tensor, idx: Optional[torch.Tensor],
                 val: torch.Tensor):
        """(this rank's partial margins over the features it owns, the
        slice-local ids and values of sparse rows)."""
        if self.dense:
            return torch.matmul(val, w_local), None
        li, lv = self._owned(idx, val)
        if not w_local.numel():
            return torch.zeros(len(val), dtype=torch.float32, device=val.device), (li, lv)
        return (w_local[li] * lv).sum(dim=1), (li, lv)

    def _margins(self, w_local: torch.Tensor, idx: Optional[torch.Tensor],
                 val: torch.Tensor) -> torch.Tensor:
        """Per-row margins: the local partials, all-reduced over the
        feature group."""
        return self._sum_features(self._partial(w_local, idx, val)[0])

    def _step(self, w_local: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """One step.  The partial margins and, for dim_sparsity, the
        partial dot ``w . dimSparsity`` (both of the weights before the
        step) go through ONE all_reduce over the feature group: the sums
        are elementwise, so they are the bits of two."""
        by = self._y[ids]
        bv = self._val[ids]
        part, owned = self._partial(w_local, None if self.dense else self._idx[ids], bv)
        reg, lam = self.model.regularizer, self.model.lam
        if reg == "dim_sparsity":
            sums = self._sum_features(
                torch.cat([part, torch.dot(w_local.float(), self._ds).reshape(1)]))
            m, dot = sums[:-1], sums[-1]
        else:
            m = self._sum_features(part)
        coeff = self.model.grad_coeff(m, by)
        if self.dense:
            g = torch.matmul(coeff.float().unsqueeze(0), bv).squeeze(0)
        else:
            g = torch.zeros_like(w_local)
            if w_local.numel():
                li, lv = owned
                g.index_add_(0, li.reshape(-1), (coeff[:, None] * lv).reshape(-1))
        # the regularizer on this rank's slice of each worker's reply
        if reg == "dim_sparsity":
            g = g + torch.where(g != 0, lam * 2.0 * dot, torch.zeros_like(g))
        elif reg == "l2":
            g = g + 2.0 * lam * w_local
        g = self._mean_workers(g)
        return w_local - self.learning_rate * g

    # -- host API ----------------------------------------------------------

    def bind(self, data: Dataset) -> "FeatureShardedEngine":
        """This rank's data shard (the columns of its slice for dense
        rows), loaded alone; returns the engine."""
        self.dense = data.is_dense
        self.n_true = len(data)
        total, chunk = padded_layout(len(data), self.n_workers, 4096)
        self.shard_n = total // self.n_workers
        self.eval_chunk = chunk
        start = self.mesh.worker_index * self.shard_n
        pad_width = 0 if self.dense else data.indices.shape[1]
        local = load_host_shard(dataset_reader(data), len(data), data.n_features, pad_width,
                                start, start + self.shard_n, labels_dtype=data.labels.dtype)
        dev = self.device
        if self.dense:
            self._idx = None
            self._val = torch.as_tensor(
                np.ascontiguousarray(local.values[:, self.lo:self.hi]), dtype=torch.float32,
            ).to(dev)
        else:
            self._idx = torch.as_tensor(local.indices, dtype=torch.int32).to(dev)
            self._val = torch.as_tensor(local.values, dtype=torch.float32).to(dev)
        self._labels = torch.as_tensor(local.labels).to(dev)
        self._y = self._labels.float()
        max_shard = math.ceil(len(data) / self.n_workers)
        self.steps_per_epoch = max(1, math.ceil(max_shard / self.batch_size))
        return self

    def _sample_ids(self, key: int) -> torch.Tensor:
        """The epoch's ids, int64[steps, B] uniform over this data rank's
        padded shard, from a generator seeded with `key` (already folded
        with the data rank)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key)
        return torch.randint(0, self.shard_n, (self.steps_per_epoch, self.batch_size),
                             generator=gen, device=self.device)

    def init_weights(self) -> torch.Tensor:
        """This rank's slice of zero weights."""
        return torch.zeros(self.hi - self.lo, dtype=torch.float32, device=self.device)

    def epoch(self, w_local: torch.Tensor, key: int) -> torch.Tensor:
        for ids in self._sample_ids(fold_in(key, self.mesh.worker_index)):
            w_local = self._step(w_local, ids)
        return w_local

    def to_dense(self, w_local: torch.Tensor) -> np.ndarray:
        """The whole ``[D]`` weights, gathered over the feature group."""
        padded = torch.zeros(self._width, dtype=torch.float32, device=self.device)
        padded[: self.hi - self.lo] = w_local
        if self.n_shards > 1:
            padded = all_gather_cat(padded, self.mesh.feature_group)
        return padded[: self.model.n_features].cpu().numpy()

    def _dense_tensor(self, w_local: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.to_dense(w_local)).to(self.device)

    def from_dense(self, w) -> torch.Tensor:
        """This rank's slice of dense ``[D]`` weights (inverse of to_dense)."""
        w = np.asarray(w, dtype=np.float32)
        return torch.as_tensor(np.ascontiguousarray(w[self.lo:self.hi])).to(self.device)

    def _chunks(self):
        c = self.eval_chunk
        for s in range(0, self.shard_n, c):
            idx = None if self.dense else self._idx[s:s + c]
            yield idx, self._val[s:s + c], self._labels[s:s + c]

    def predict(self, w_local: torch.Tensor) -> np.ndarray:
        """Predictions for every true sample of the bound split, the data
        ranks' shards gathered in order."""
        preds = torch.cat([self.model.predict(self._margins(w_local, ci, cv))
                           for ci, cv, _ in self._chunks()])
        if self.n_workers > 1:
            preds = all_gather_cat(preds, self.mesh.worker_group)
        return preds.cpu().numpy()[: self.n_true]

    def evaluate(self, w_local: torch.Tensor):
        """(objective, accuracy) over the bound split, as
        ``BoundSync.evaluate``: the margins reduced over the feature group,
        the loss and hit sums over the data group."""
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        hit_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for ci, cv, cy in self._chunks():
            margins = self._margins(w_local, ci, cv)
            mask = (cy != 0).float()
            losses = self.model.losses_from_margins(margins, cy)
            hits = (self.model.predict(margins) == cy.float()).float()
            loss_sum = loss_sum + torch.sum(losses * mask)
            hit_sum = hit_sum + torch.sum(hits * mask)
        sums = torch.stack([loss_sum, hit_sum])
        if self.n_workers > 1:
            sums = all_reduce_sum(sums, self.mesh.worker_group)
        sums = sums.cpu()
        w = self.to_dense(w_local)
        reg = self.model.lam * float(np.dot(w, w))
        return reg + float(sums[0]) / self.n_true, float(sums[1]) / self.n_true

    def fit(self, train: Dataset, test: Dataset, max_epochs: int, criterion=None,
            initial_weights=None, checkpointer=None, checkpoint_every: int = 1,
            seed: int = 0) -> FitResult:
        """Epoch loop, early stopping, checkpoint and resume: the
        SyncTrainer's fit contract (core/trainer.py) on the grid.  Epoch e
        is keyed ``fold_in(seed, e)``."""
        self.bind(train)
        test_bound = FeatureShardedEngine(self.model, self.mesh, self.batch_size,
                                          self.learning_rate).bind(test)
        w = self.init_weights() if initial_weights is None else self.from_dense(initial_weights)
        checkpointer = for_rank(checkpointer, rank())
        result = FitResult(state=GradState(weights=self._dense_tensor(w)),
                           steps_per_epoch=self.steps_per_epoch)
        test_newest_first = []

        start_epoch = 0
        restored = restore_sync_fit(checkpointer, "sgd", [])
        if restored is not None:
            start_epoch, w_np, test_newest_first, _ = restored
            w = self.from_dense(w_np)
            log.info("resumed feature-sharded fit from checkpoint at epoch %d", start_epoch)

        if start_epoch >= max_epochs:
            loss, _ = self.evaluate(w)
            result.epochs_run = start_epoch
            result.state = GradState(weights=self._dense_tensor(w), loss=loss).finish()
            return result

        for epoch in range(start_epoch, max_epochs):
            t0 = time.perf_counter()
            w = self.epoch(w, fold_in(seed, epoch))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            epoch_s = time.perf_counter() - t0
            loss, acc = self.evaluate(w)
            test_loss, test_acc = test_bound.evaluate(w)
            record_epoch(result, test_newest_first, epoch, loss, acc, test_loss, test_acc,
                         epoch_s)
            log.info("epoch %d: loss=%.6f acc=%.4f test_loss=%.6f test_acc=%.4f "
                     "(%.2fs, %d feature shards)", epoch, loss, acc, test_loss, test_acc,
                     epoch_s, self.n_shards)
            if checkpointer is not None and (epoch + 1) % checkpoint_every == 0:
                save_sync_fit(checkpointer, epoch + 1, self.to_dense(w), test_newest_first)
            if criterion is not None and criterion(test_newest_first):
                log.info("Converged to target: stopping computation")
                break
        save_sync_fit_final(checkpointer, result.epochs_run, start_epoch, checkpoint_every,
                            lambda: self.to_dense(w), test_newest_first)
        if world_size() > 1:
            barrier()  # rank 0's last snapshot is written before any rank goes on
        result.state = GradState(
            weights=self._dense_tensor(w),
            loss=result.losses[-1] if result.losses else float("nan")).finish()
        return result
