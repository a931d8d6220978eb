"""Synchronous data-parallel SGD on one CUDA card.

The port of distributed_sgd_tpu/parallel/sync.py.  The JAX engine compiles
an epoch into one XLA program over a device mesh; this engine runs the
same step on one card (world size 1):

1. draw ``[K, B]`` sample ids, each virtual worker from its own disjoint
   contiguous sub-shard (the vanilla split);
2. every worker's sum ``sum_b grad_coeff(x_b . w, y_b) * x_b``;
3. each worker's sum gets the model's regularizer (the ``g != 0`` mask is
   per worker, before the sum over workers);
4. mean over all workers and ``w -= lr * g``.

Where the state (w, dim_sparsity and the K workers' sums) fits one
thread-block cluster's shared memory (``cluster_plan``, checked when the
engine is bound), a whole epoch's steps are one launch of the
``sync_epoch`` kernel (ops/sync_epoch.py).  Otherwise each step runs on its
own (``_one_step``): one ``worker_grads`` launch (ops/worker_grads.py), then
the regularizer, the cross-card reduce (`all_reduce_sum`, identity on one
card) and the update in torch.  The path is picked by shape alone, before
any launch.

Sampling mirrors the JAX engine's index arithmetic exactly; only the
random source differs.  An epoch's draws come from one ``torch.Generator``
on the engine's device, seeded by the epoch key (`fold_in` of the run's
seed and the epoch index): the structure of ``jax.random.fold_in``, not
its bits.  ``sampling='fresh'`` draws uniform ids per step (with
replacement); ``sampling='epoch'`` walks one per-epoch permutation of each
worker's sub-shard.

Evaluation (objective + accuracy over a split) runs chunked on the device
with the label-0 pad mask, in plain torch: the JAX package computes it
outside any Pallas kernel.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch
from distributed_sgd_tpu_torch.ops.sync_epoch import cluster_plan, sync_epoch
from distributed_sgd_tpu_torch.ops.worker_grads import worker_grads
from distributed_sgd_tpu_torch.parallel.mesh import (
    DeviceLike,
    all_reduce_sum,
    pad_rows,
    rank,
    resolve_device,
    world_size,
)

log = logging.getLogger("dsgd.sync")


def fold_in(key: int, data: int) -> int:
    """A new non-negative 63-bit seed derived from `key` and `data`."""
    state = np.random.SeedSequence([int(key), int(data)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def steps_per_epoch_for(n_true: int, n_workers: int, virtual_workers: int,
                        batch_size: int) -> int:
    """Steps per epoch: ceil(max shard / batch), the max shard taken over
    the TOTAL worker count (cards x virtual workers)."""
    max_shard = math.ceil(n_true / (n_workers * virtual_workers))
    return max(1, math.ceil(max_shard / batch_size))


def _uniform_draws(gen: torch.Generator, shape, high: int, device) -> torch.Tensor:
    """Uniform ints in [0, high): the 'fresh' sampling source."""
    return torch.randint(0, high, shape, generator=gen, device=device)


def _permutations(gen: torch.Generator, k: int, n: int, device) -> torch.Tensor:
    """[k, n]: one uniform permutation of range(n) per row: the 'epoch'
    sampling source."""
    return torch.rand((k, n), generator=gen, device=device).argsort(dim=1)


class ShardedData(NamedTuple):
    indices: torch.Tensor  # int32[N_pad, P], this card's rows
    values: torch.Tensor  # f32[N_pad, P]
    labels: torch.Tensor  # [N_pad]; 0 = padding mask
    n_true: int  # real sample count over all cards


class BoundSync:
    """Sync engine bound to one dataset's shapes on one device."""

    def __init__(
        self,
        model: LinearModel,
        data: ShardedData,
        batch_size: int,
        learning_rate: float,
        sampling: str = "fresh",
        steps_per_epoch: Optional[int] = None,
        eval_chunk: int = 4096,
        virtual_workers: int = 1,
        optimizer=None,
    ):
        if sampling not in ("fresh", "epoch"):
            raise ValueError(f"sampling must be 'fresh' or 'epoch', got {sampling!r}")
        if virtual_workers < 1:
            raise ValueError("virtual_workers must be >= 1")
        resolve_optimizer(optimizer)
        self.model = model
        self.data = data
        self.device = data.indices.device
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.sampling = sampling
        self.n_workers = world_size()
        # K reference workers emulated on this card: each step draws K
        # per-worker batches from K disjoint contiguous sub-shards
        self.virtual_workers = int(virtual_workers)
        self.shard_n = data.indices.shape[0]
        self.eval_chunk = min(eval_chunk, self.shard_n)
        if self.shard_n % self.eval_chunk != 0:
            raise ValueError(
                f"shard size {self.shard_n} not a multiple of eval_chunk {self.eval_chunk}")
        self.steps_per_epoch = steps_per_epoch or steps_per_epoch_for(
            data.n_true, self.n_workers, self.virtual_workers, self.batch_size)
        # labels enter the kernels as f32 (pads stay 0)
        self._labels_f32 = data.labels.float().contiguous()
        # the epoch kernel reduces over this card's workers only
        self.epoch_kernel = (self.n_workers == 1 and cluster_plan(
            self.virtual_workers, model.n_features) is not None)
        self._told_per_step = False

    def _subshards(self):
        """(sub, starts, sizes): the per-virtual-worker ceil-split of this
        card's shard — the single source of sample ownership for both
        sampling modes and the trainability check."""
        k = self.virtual_workers
        sub = -(-self.shard_n // k)  # ceil
        starts = np.minimum(np.arange(k) * sub, self.shard_n - 1)
        sizes = np.maximum(self.shard_n - starts, 1)
        return sub, starts, sizes

    def _place(self, sel: torch.Tensor) -> torch.Tensor:
        """Raw draws sel[..., K, B] in [0, sub) -> ids into this card's
        shard.  The short trailing sub-shard maps out-of-range draws in by
        modulo."""
        sub, starts, sizes = self._subshards()
        wrap = torch.as_tensor(np.minimum(sub, sizes), device=sel.device)
        starts = torch.as_tensor(starts, device=sel.device)
        return sel % wrap[:, None] + starts[:, None]

    def _sample_ids(self, key: int) -> torch.Tensor:
        """The epoch's sample ids, int64[steps, K, B], drawn on the device
        from a generator seeded with `key`."""
        k, b, s = self.virtual_workers, self.batch_size, self.steps_per_epoch
        sub, _, _ = self._subshards()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key)
        if self.sampling == "fresh":
            sel = _uniform_draws(gen, (s, k, b), sub, self.device)
        else:
            perms = _permutations(gen, k, sub, self.device)  # [K, sub]
            start = torch.clamp(torch.arange(s, device=self.device) * b, max=max(sub - b, 0))
            cols = start[:, None] + torch.arange(b, device=self.device)  # [S, B]
            sel = perms[:, cols].permute(1, 0, 2)  # [S, K, B]
        return self._place(sel)

    def _one_step(self, w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """One sync DP step with ids[K, B]; returns the new weights."""
        d = self.data
        gk = worker_grads(w, d.indices[ids], d.values[ids], self._labels_f32[ids],
                          self.model.coeff_kind)  # [K, D], one launch for every worker
        gk = self.model.regularize(gk, w)
        # master mean over ALL workers
        g = all_reduce_sum(gk.sum(dim=0)) / (self.n_workers * self.virtual_workers)
        return w - self.learning_rate * g

    def _check_trainable(self) -> None:
        """Checked at train-call time, not bind time: an eval-only binding
        (e.g. the test split) never samples batches."""
        k = self.virtual_workers
        sub, _, _ = self._subshards()
        if self.sampling == "epoch" and self.batch_size > sub:
            raise ValueError(
                f"sampling='epoch' needs batch_size ({self.batch_size}) <= "
                f"per-virtual-worker sub-shard ({sub} = ceil({self.shard_n}/{k})); "
                f"lower the batch size or worker count")
        if k > 1 and (k - 1) * sub >= self.shard_n:
            raise ValueError(
                f"virtual_workers={k} over a {self.shard_n}-sample shard leaves "
                f"trailing workers without a nonempty ceil-split sub-shard; "
                f"lower virtual_workers")

    # -- host API ----------------------------------------------------------

    def _run(self, w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The weights after the steps ids[S, K, B]: one sync_epoch launch
        where the shape fits the cluster, else one `_one_step` per step."""
        if self.epoch_kernel:
            m, d = self.model, self.data
            return sync_epoch(
                w, ids.contiguous(), d.indices, d.values, self._labels_f32,
                coeff_kind=m.coeff_kind, reg_kind=m.reg_kind, lam=m.lam,
                dim_sparsity=m.dim_sparsity, lr=self.learning_rate,
                n_total_workers=self.n_workers * self.virtual_workers)
        if not self._told_per_step:
            log.info("K=%d workers at D=%d do not fit one cluster's shared memory: "
                     "running the per-step path (worker_grads per step)",
                     self.virtual_workers, self.model.n_features)
            self._told_per_step = True
        for rows in ids:
            w = self._one_step(w, rows)
        return w

    def epoch(self, w: torch.Tensor, key: int) -> torch.Tensor:
        self._check_trainable()
        return self._run(w, self._sample_ids(fold_in(key, rank())))

    def multi_epoch(self, w: torch.Tensor, key: int, n_epochs: int) -> torch.Tensor:
        """`n_epochs` epochs, epoch e keyed by fold_in(key, e)."""
        for e in range(n_epochs):
            w = self.epoch(w, fold_in(key, e))
        return w

    def step(self, w: torch.Tensor, key: int) -> torch.Tensor:
        """One step: the first step of the epoch keyed by `key`."""
        self._check_trainable()
        return self._run(w, self._sample_ids(fold_in(key, rank()))[:1])

    def _chunks(self):
        d, c = self.data, self.eval_chunk
        for s in range(0, self.shard_n, c):
            yield SparseBatch(d.indices[s:s + c], d.values[s:s + c]), d.labels[s:s + c]

    def predict(self, w: torch.Tensor) -> np.ndarray:
        """Model predictions for every (true) sample in the bound split."""
        preds = [self.model.predict(self.model.margins(w, batch))
                 for batch, _ in self._chunks()]
        return torch.cat(preds).cpu().numpy()[: self.data.n_true]

    def evaluate(self, w: torch.Tensor) -> Tuple[float, float]:
        """(objective, accuracy) over the bound split.

        objective = lam*||w||^2 + mean sample loss; accuracy =
        fraction(predict == y).  Pads (label 0) are masked.
        """
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        hit_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for batch, cy in self._chunks():
            mask = (cy != 0).float()
            margins = self.model.margins(w, batch)
            losses = self.model.losses_from_margins(margins, cy)
            hits = (self.model.predict(margins) == cy.float()).float()
            loss_sum = loss_sum + torch.sum(losses * mask)
            hit_sum = hit_sum + torch.sum(hits * mask)
        sums = all_reduce_sum(torch.stack([loss_sum, hit_sum])).cpu()
        n = self.data.n_true
        reg = self.model.lam * float(torch.sum(w.float() ** 2))
        return reg + float(sums[0]) / n, float(sums[1]) / n


def resolve_optimizer(optimizer) -> None:
    """None/'sgd' -> None (the reference's plain update w - lr*g).
    momentum and adam are not ported yet."""
    if optimizer is None or optimizer == "sgd":
        return None
    if optimizer in ("momentum", "adam"):
        raise NotImplementedError(
            f"optimizer={optimizer!r} is not ported yet (ROADMAP.md Queue A: "
            f"'momentum and adam for the sync engine'); use 'sgd'")
    raise ValueError(f"optimizer must be 'sgd', 'momentum' or 'adam', got {optimizer!r}")


class SyncEngine:
    """Factory: pads datasets, places them on the device, binds loops."""

    def __init__(
        self,
        model: LinearModel,
        batch_size: int,
        learning_rate: float,
        sampling: str = "fresh",
        eval_chunk: int = 4096,
        virtual_workers: int = 1,
        optimizer=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        resolve_optimizer(optimizer)
        self.model = model
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.sampling = sampling
        self.eval_chunk = eval_chunk
        self.virtual_workers = virtual_workers
        self.optimizer = optimizer

    def bind(self, data: Dataset, steps_per_epoch: Optional[int] = None) -> BoundSync:
        if data.is_dense:
            raise NotImplementedError(
                "dense-layout data is not ported yet (ROADMAP.md Queue A: "
                "'the dense layout'); pass padded sparse rows")
        n_workers = world_size()
        n_true = len(data)
        if n_true < n_workers:
            raise ValueError(f"dataset of {n_true} rows < {n_workers} workers")
        total, chunk = padded_layout(n_true, n_workers, self.eval_chunk)
        local = _pad_to_exact(data, total)
        shard = slice(rank() * (total // n_workers), (rank() + 1) * (total // n_workers))

        def put(arr, dtype):
            return torch.as_tensor(np.ascontiguousarray(arr[shard]), dtype=dtype).to(self.device)

        labels_dtype = torch.int32 if np.issubdtype(local.labels.dtype, np.integer) else torch.float32
        sharded = ShardedData(
            indices=put(local.indices, torch.int32),
            values=put(local.values, torch.float32),
            labels=put(local.labels, labels_dtype),
            n_true=n_true,
        )
        return BoundSync(
            self.model, sharded, self.batch_size, self.learning_rate,
            sampling=self.sampling, steps_per_epoch=steps_per_epoch,
            eval_chunk=chunk, virtual_workers=self.virtual_workers,
            optimizer=self.optimizer,
        )


def padded_layout(n_true: int, n_workers: int, eval_chunk: int = 4096) -> Tuple[int, int]:
    """(padded_total, chunk): each of the n_workers equal shards is padded
    to a multiple of the eval chunk so the chunked eval never reads out of
    range (pads carry label 0 and are masked)."""
    shard = math.ceil(n_true / n_workers)
    chunk = min(eval_chunk, shard)
    shard_padded = math.ceil(shard / chunk) * chunk
    return n_workers * shard_padded, chunk


def _pad_to_exact(data: Dataset, target: int) -> Dataset:
    if target < len(data):
        raise ValueError("target smaller than dataset")
    return pad_rows(data, target - len(data))
