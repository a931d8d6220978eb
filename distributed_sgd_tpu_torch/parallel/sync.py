"""Synchronous data-parallel SGD on CUDA cards, one rank a card.

The port of distributed_sgd_tpu/parallel/sync.py.  The JAX engine compiles
an epoch into one XLA program over a device mesh; this engine runs the
same step on each rank of a process group (parallel/mesh.py; one process
and no group is a world of one):

1. draw ``[K, B]`` sample ids, each virtual worker from its own disjoint
   contiguous sub-shard (the vanilla split);
2. every worker's sum ``sum_b grad_coeff(x_b . w, y_b) * x_b``;
3. each worker's sum gets the model's regularizer (the ``g != 0`` mask is
   per worker, before the sum over workers);
4. mean over all workers and the optimizer's update: ``w -= lr * g``
   ('sgd', the reference's), or the JAX engine's optax ``momentum`` or
   ``adam`` (`resolve_optimizer`).  Their state is the engine's, made at
   bind time (zeros, count 0) and carried from call to call, as the JAX
   engine's ``_opt_state``.

Where the state (w, the optimizer's vectors and the K workers' integer
sums) fits one thread-block cluster's shared memory
(``cluster_plan``, checked when the engine is bound), a whole epoch's steps
are one launch of the ``sync_epoch`` kernel (ops/sync_epoch.py).  Otherwise
each step runs on its own (``_one_step``): one ``worker_grads`` launch
(ops/worker_grads.py), then the regularizer, the all_reduce of the
``[D]`` sum over the ranks (`all_reduce_sum`) and the update in torch, as
the JAX engine applies optax outside its Pallas kernel.  The epoch kernel
cannot reduce across ranks inside its launch, so a world of more than one
rank always takes the per-step path.  The path is picked by shape and
world size alone, before any launch.  Every rank applies the update to the
same all-reduced bits, so the ranks' weights and optimizer state stay
bitwise equal.

Sampling mirrors the JAX engine's index arithmetic exactly; only the
random source differs.  An epoch's draws come from one ``torch.Generator``
on the engine's device, seeded by the epoch key folded with the rank
(`fold_in`, as the JAX engine folds in its mesh position): the structure
of ``jax.random.fold_in``, not its bits.  ``sampling='fresh'`` draws uniform ids per step (with
replacement); ``sampling='epoch'`` walks one per-epoch permutation of each
worker's sub-shard.

Dense-layout data (``Dataset.dense``: values ``[N, D]``, no index array)
binds the ``"dense"`` backend, picked by the layout as the JAX engine
picks it: no kernel of the port applies (``sync_epoch`` reads index
rows), so each step runs on its own with the same draws as the sparse
path: every worker's ``grad_dense`` sum (one batched f32 ``torch.matmul``
for all K), the regularizer, the mean over workers and the update.  The
JAX engine runs ``jnp.dot`` there too, outside any Pallas kernel.

Evaluation (objective + accuracy over a split) runs chunked on the device
with the label-0 pad mask, in plain torch, and its two sums are one
all_reduce: the JAX package computes it outside any Pallas kernel (dense
chunks through ``margins_dense``).

At a world of more than one rank `SyncEngine.bind` loads only the rank's
rows of the padded layout (parallel/multihost.py ``host_shard_bounds``),
and ``bind_host_local`` binds a row reader's slice without the corpus.
"""

from __future__ import annotations

import logging
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.ops.coeff import check_launchable
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch
from distributed_sgd_tpu_torch.ops.sync_epoch import (
    Optimizer,
    OptState,
    apply_update,
    cluster_plan,
    init_opt_state,
    sync_epoch,
)
from distributed_sgd_tpu_torch.ops.worker_grads import worker_grads
from distributed_sgd_tpu_torch.parallel.mesh import (
    DeviceLike,
    all_gather_cat,
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
    indices: torch.Tensor  # int32[N_pad, P], this rank's rows ([N_pad, 0]: dense layout)
    values: torch.Tensor  # f32[N_pad, P]
    labels: torch.Tensor  # [N_pad]; 0 = padding mask
    n_true: int  # real sample count over all ranks

    @property
    def is_dense(self) -> bool:
        return SparseBatch(self.indices, self.values).is_dense


class BoundSync:
    """Sync engine bound to one dataset's shapes: this rank's shard on its
    device."""

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
        momentum: float = 0.9,
        group=None,
    ):
        """The layout picks `kernel`: 'dense' (the matmul steps) for
        dense-layout rows, else 'sparse' (the sync_epoch or worker_grads
        kernels).  `group`: the process group whose ranks are the workers
        (the default group when None)."""
        if sampling not in ("fresh", "epoch"):
            raise ValueError(f"sampling must be 'fresh' or 'epoch', got {sampling!r}")
        if virtual_workers < 1:
            raise ValueError("virtual_workers must be >= 1")
        if data.is_dense and data.values.shape[1] != model.n_features:
            raise ValueError(
                f"dense-layout rows must span the model's {model.n_features} features, "
                f"got width {data.values.shape[1]}")
        self.kernel = "dense" if data.is_dense else "sparse"
        if self.kernel == "sparse":  # a model's own rule needs its CUDA form on the card
            check_launchable(model.coeff, data.indices.device)
        self.optimizer = resolve_optimizer(optimizer, momentum)
        self.model = model
        self.data = data
        self.device = data.indices.device
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.sampling = sampling
        self.group = group
        self.n_workers = world_size(group)
        self.rank = rank(group)
        # K reference workers emulated on this rank: each step draws K
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
        self._opt_state = self._init_opt_state()
        # the epoch kernel reduces over this rank's workers only, and
        # reads index rows
        self.epoch_kernel = (self.kernel == "sparse" and self.n_workers == 1 and cluster_plan(
            self.virtual_workers, model.n_features, self.optimizer.n_state) is not None)
        self._told_per_step = False

    def _subshards(self):
        """(sub, starts, sizes): the per-virtual-worker ceil-split of this
        rank's shard — the single source of sample ownership for both
        sampling modes and the trainability check."""
        k = self.virtual_workers
        sub = -(-self.shard_n // k)  # ceil
        starts = np.minimum(np.arange(k) * sub, self.shard_n - 1)
        sizes = np.maximum(self.shard_n - starts, 1)
        return sub, starts, sizes

    def _place(self, sel: torch.Tensor) -> torch.Tensor:
        """Raw draws sel[..., K, B] in [0, sub) -> ids into this rank's
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
        """One sync DP step with ids[K, B]; returns the new weights and
        advances the optimizer state."""
        d = self.data
        if self.kernel == "dense":
            gk = self.model.grad_dense(w, d.values[ids], self._labels_f32[ids])  # [K, D]
        else:
            gk = worker_grads(w, d.indices[ids], d.values[ids], self._labels_f32[ids],
                              self.model.coeff)  # [K, D], one launch for every worker
        gk = self.model.regularize(gk, w)
        # master mean over ALL workers: one all_reduce of the [D] sum
        g = all_reduce_sum(gk.sum(dim=0), self.group) / (self.n_workers * self.virtual_workers)
        w, self._opt_state = apply_update(w, g, self.learning_rate, self.optimizer,
                                          self._opt_state)
        return w

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

    def warmup_thunks(self):
        """The warm-up thunk of the spin-up fast path (compile_cache.py,
        DSGD_COMPILE_CACHE), as the JAX binding's ``epoch``: this binding's
        kernel at its shape (one step, every virtual worker's batch) on
        inert inputs -- zero weights, a fresh optimizer state, the result
        dropped -- so the library is built or loaded and launched once
        before the fit's first epoch.  The binding's own state is not
        touched.  (The JAX binding also compiles its eval program; the
        port's evaluation launches no kernel of its own, nor does the dense
        layout's step: none is warmed.)"""
        if self.kernel == "dense":
            return []

        def epoch():
            w0 = torch.zeros(self.model.n_features, dtype=torch.float32, device=self.device)
            ids = torch.zeros((1, self.virtual_workers, self.batch_size), dtype=torch.int64,
                              device=self.device)
            m, d = self.model, self.data
            if self.epoch_kernel:
                sync_epoch(w0, ids, d.indices, d.values, self._labels_f32,
                           coeff=m.coeff, reg_kind=m.reg_kind, lam=m.lam,
                           dim_sparsity=m.dim_sparsity, lr=0.0,
                           n_total_workers=self.n_workers * self.virtual_workers,
                           optimizer=self.optimizer,
                           opt_state=self._init_opt_state())[0].cpu()
            else:
                worker_grads(w0, d.indices[ids[0]], d.values[ids[0]], self._labels_f32[ids[0]],
                             m.coeff).cpu()

        return [("epoch", epoch)]

    def _maybe_warmup(self) -> None:
        """Start the background warm-up at bind time when the compile cache
        is configured; nothing at all when the knob is off."""
        from distributed_sgd_tpu_torch import compile_cache

        if compile_cache.enabled():
            compile_cache.warmup_async(f"mesh[{self.n_workers}x{self.kernel}]",
                                       self.warmup_thunks())

    def _run(self, w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """The weights after the steps ids[S, K, B]: one sync_epoch launch
        where the shape fits the cluster, else one `_one_step` per step.
        Either way the optimizer state advances with them."""
        if self.epoch_kernel:
            m, d = self.model, self.data
            w, self._opt_state = sync_epoch(
                w, ids.contiguous(), d.indices, d.values, self._labels_f32,
                coeff=m.coeff, reg_kind=m.reg_kind, lam=m.lam,
                dim_sparsity=m.dim_sparsity, lr=self.learning_rate,
                n_total_workers=self.n_workers * self.virtual_workers,
                optimizer=self.optimizer, opt_state=self._opt_state)
            return w
        if not self._told_per_step and self.kernel == "sparse":
            if self.n_workers > 1:
                log.info("a world of %d ranks: running the per-step path (worker_grads per "
                         "step, then one all_reduce); the epoch kernel cannot reduce across "
                         "ranks", self.n_workers)
            else:
                log.info("K=%d workers at D=%d with optimizer %s do not fit one cluster's "
                         "shared memory: running the per-step path (worker_grads per step)",
                         self.virtual_workers, self.model.n_features, self.optimizer.kind)
            self._told_per_step = True
        for rows in ids:
            w = self._one_step(w, rows)
        return w

    def epoch(self, w: torch.Tensor, key: int) -> torch.Tensor:
        self._check_trainable()
        return self._run(w, self._sample_ids(fold_in(key, self.rank)))

    def multi_epoch(self, w: torch.Tensor, key: int, n_epochs: int) -> torch.Tensor:
        """`n_epochs` epochs, epoch e keyed by fold_in(key, e)."""
        for e in range(n_epochs):
            w = self.epoch(w, fold_in(key, e))
        return w

    def step(self, w: torch.Tensor, key: int) -> torch.Tensor:
        """One step: the first step of the epoch keyed by `key`."""
        self._check_trainable()
        return self._run(w, self._sample_ids(fold_in(key, self.rank))[:1])

    def _init_opt_state(self) -> OptState:
        return init_opt_state(self.optimizer, self.model.n_features, self.device)

    def reset_optimizer(self) -> None:
        """Zero the optimizer state (momentum trace, adam moments and count)."""
        self._opt_state = self._init_opt_state()

    def opt_state_leaves(self) -> list:
        """The optimizer state in the JAX engine's leaf order (checkpoint
        form): momentum [trace], adam [count (int32, shape ()), mu, nu],
        sgd []; flat [D] tensors on the engine's device."""
        vectors, count = self._opt_state
        if self.optimizer.kind == "adam":
            return [torch.tensor(count, dtype=torch.int32), *vectors]
        return list(vectors)

    def load_opt_state_leaves(self, leaves) -> None:
        """Restore the optimizer state from `opt_state_leaves()` output (or
        the JAX engine's, flat or lane-blocked)."""
        self._opt_state = convert.opt_state_from_jax(
            leaves, self.optimizer.kind, self.model.n_features, self.device)

    def _chunks(self):
        d, c = self.data, self.eval_chunk
        for s in range(0, self.shard_n, c):
            yield SparseBatch(d.indices[s:s + c], d.values[s:s + c]), d.labels[s:s + c]

    def predict(self, w: torch.Tensor) -> np.ndarray:
        """Model predictions for every (true) sample in the bound split:
        each rank predicts its rows, and at a world of more than one the
        ranks' shards are gathered in rank order."""
        preds = torch.cat([self.model.predict(self.model.margins(w, batch))
                           for batch, _ in self._chunks()])
        return all_gather_cat(preds, self.group).cpu().numpy()[: self.data.n_true]

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
        sums = all_reduce_sum(torch.stack([loss_sum, hit_sum]), self.group).cpu()
        n = self.data.n_true
        reg = self.model.lam * float(torch.sum(w.float() ** 2))
        return reg + float(sums[0]) / n, float(sums[1]) / n


class MeanSteps:
    """The async engines' local steps over one worker's rows.

    Each step with ids[B] is the JAX async step (hogwild.py, local_sgd.py):
    ``grad_mean`` (the gradient sum over the batch, divided by B), the
    model's regularizer, then the optimizer's update (``local_update``:
    ``w - lr*g`` for 'sgd').  Where w, the optimizer's state and the
    integer sums fit one cluster (``cluster_plan(1, D, n_state)``: D up to
    154,848 for sgd, 116,128 for momentum, 92,896 for adam), `run` is one
    ``sync_epoch`` launch in the mean mode (K = 1, grad_divisor = B).
    Otherwise each step is one ``worker_grads`` launch, with the mean, the
    regularizer and the update in torch.  Dense-layout rows (a zero-width
    index array) take ``grad_dense(reduce="mean")`` a step, as the JAX
    engines' dense branch does.  The route is picked by shape when this is
    built, before any launch.
    """

    def __init__(self, model: LinearModel, indices: torch.Tensor, values: torch.Tensor,
                 labels: torch.Tensor, learning_rate: float,
                 optimizer: Optional[Optimizer] = None):
        self.model = model
        self.indices, self.values = indices, values
        self.labels_f32 = labels.float().contiguous()
        self.learning_rate = float(learning_rate)
        self.optimizer = optimizer or Optimizer()
        self.dense = SparseBatch(indices, values).is_dense
        if not self.dense:
            check_launchable(model.coeff, indices.device)
        self.fused = (not self.dense and cluster_plan(1, model.n_features,
                                                       self.optimizer.n_state) is not None)
        if not self.fused and not self.dense:
            log.info("w at D=%d with optimizer %s does not fit one cluster's shared memory: "
                     "the async steps run one worker_grads launch each", model.n_features,
                     self.optimizer.kind)

    def init_state(self) -> OptState:
        """The optimizer's state before any step: zeros, count 0."""
        return init_opt_state(self.optimizer, self.model.n_features, self.indices.device)

    def run(self, w: torch.Tensor, ids: torch.Tensor,
            state: Optional[OptState] = None) -> Tuple[torch.Tensor, OptState]:
        """(weights, optimizer state) after the steps ids[S, 1, B] (rows of
        this worker's data) from `w` and `state` (`init_state()` when None),
        which are left untouched."""
        m, div = self.model, self.grad_divisor(ids.shape[2])
        state = self.init_state() if state is None else state
        if self.fused:
            return sync_epoch(
                w, ids, self.indices, self.values, self.labels_f32,
                coeff=m.coeff, reg_kind=m.reg_kind, lam=m.lam,
                dim_sparsity=m.dim_sparsity, lr=self.learning_rate, n_total_workers=1,
                grad_divisor=div, optimizer=self.optimizer, opt_state=state)
        for rows in ids:
            if self.dense:
                # the mean divides each coefficient before the product
                g = m.grad_dense(w, self.values[rows], self.labels_f32[rows],
                                 reduce="sum" if div == 1 else "mean")[0]
            else:
                g = worker_grads(w, self.indices[rows], self.values[rows],
                                 self.labels_f32[rows], m.coeff)[0] / div
            w, state = apply_update(w, m.regularize(g, w), self.learning_rate,
                                    self.optimizer, state)
        return w, state

    def grad_divisor(self, batch_size: int) -> int:
        """What a step's gradient sum is divided by: the batch (the mean)."""
        return batch_size


class WindowSteps(MeanSteps):
    """The sync RPC worker's K-step local window (GradientRequest.
    local_steps; the JAX worker's ``_window_fn``): S steps over
    ids[S, 1, B], each the SUM of the backwards over the batch, the
    model's regularizer, and the reference's plain update ``w - lr*g``,
    whatever optimizer the fit runs (the master applies that to the mean
    of the windows' decrements).  Where w and the integer sums fit one
    cluster (``cluster_plan(1, D, 0)``: D up to 154,848) the window is one
    ``sync_epoch`` launch in the sum mode (K = 1, grad_divisor = 1,
    n_total_workers = 1, sgd); otherwise one ``worker_grads`` launch a
    step, with the regularizer and the update in torch.

    A row of zeros (all values 0, label 0) adds an exact 0 to every sum
    and leaves the regularizer's ``g != 0`` mask as it was, so a short
    window's tail is filled with such a row: the JAX worker's padded,
    masked ids."""

    def __init__(self, model: LinearModel, indices: torch.Tensor, values: torch.Tensor,
                 labels: torch.Tensor, learning_rate: float):
        super().__init__(model, indices, values, labels, learning_rate, Optimizer())

    def grad_divisor(self, batch_size: int) -> int:
        return 1


def resolve_optimizer(optimizer, momentum: float = 0.9) -> Optimizer:
    """None/'sgd' -> the reference's plain update w - lr*g; 'momentum' ->
    ``optax.sgd(lr, momentum=momentum)``; 'adam' -> ``optax.adam(lr)``, as
    the JAX package's resolve_optimizer, in the port's own form.  The port
    has no optax, so an optax transformation (any other object) raises
    TypeError."""
    if optimizer is None or isinstance(optimizer, str):
        kind = optimizer or "sgd"
        if kind not in ("sgd", "momentum", "adam"):
            raise ValueError(f"optimizer must be 'sgd', 'momentum' or 'adam', got {optimizer!r}")
        return Optimizer(kind, momentum=float(momentum))
    raise TypeError(
        f"optimizer must be 'sgd', 'momentum' or 'adam', got {type(optimizer).__name__}: "
        f"the port has no optax, so it takes no optax transformation")


class SyncEngine:
    """Factory: pads datasets, places this rank's shard on the device,
    binds loops."""

    def __init__(
        self,
        model: LinearModel,
        batch_size: int,
        learning_rate: float,
        sampling: str = "fresh",
        eval_chunk: int = 4096,
        virtual_workers: int = 1,
        optimizer=None,
        momentum: float = 0.9,
        device: DeviceLike = None,
        group=None,
    ):
        """`group`: the process group whose ranks are the workers (the
        default group when None; no group at all is a world of one)."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        resolve_optimizer(optimizer, momentum)  # a bad name fails here, not at bind
        self.group = group
        self.model = model
        self.batch_size = batch_size
        self.learning_rate = learning_rate
        self.sampling = sampling
        self.eval_chunk = eval_chunk
        self.virtual_workers = virtual_workers
        self.optimizer = optimizer
        self.momentum = momentum

    def bind(self, data: Dataset, steps_per_epoch: Optional[int] = None) -> BoundSync:
        """`data` on the device, padded and sharded; dense-layout data binds
        the 'dense' backend (it has no index array to gather with).  At a
        world of more than one rank every rank passes the same full
        dataset and pads and copies ONLY its own row range
        (``host_shard_bounds``), as the JAX engine's multi-host bind."""
        n_workers = world_size(self.group)
        n_true = len(data)
        if n_true < n_workers:
            raise ValueError(f"dataset of {n_true} rows < {n_workers} workers")
        if n_workers > 1:
            from distributed_sgd_tpu_torch.data.host_shard import dataset_reader

            return self.bind_host_local(
                dataset_reader(data), n_true, data.n_features,
                data.indices.shape[1], steps_per_epoch=steps_per_epoch,
                labels_dtype=data.labels.dtype)
        total, chunk = padded_layout(n_true, n_workers, self.eval_chunk)
        local = _pad_to_exact(data, total)

        def put(arr, dtype):
            return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype).to(self.device)

        labels_dtype = torch.int32 if np.issubdtype(local.labels.dtype, np.integer) else torch.float32
        sharded = ShardedData(
            indices=put(local.indices, torch.int32),
            values=put(local.values, torch.float32),
            labels=put(local.labels, labels_dtype),
            n_true=n_true,
        )
        return self._bound(sharded, chunk, steps_per_epoch)

    def bind_host_local(self, reader, n_samples: int, n_features: int, pad_width: int,
                        steps_per_epoch: Optional[int] = None,
                        labels_dtype=None) -> BoundSync:
        """Bind WITHOUT the global corpus: each rank hands in a row reader
        (data/host_shard.py ``RowReader``) and loads ONLY its
        ``host_shard_bounds`` extent, real rows through one clipped read
        and padding rows as zeros.  ``pad_width=0`` is the dense layout.
        `labels_dtype` must be the corpus's on every rank; None is float32
        for the dense layout (the regression path) and int32 otherwise."""
        from distributed_sgd_tpu_torch.parallel.multihost import host_local_sharded

        if labels_dtype is None:
            labels_dtype = np.float32 if pad_width == 0 else np.int32
        sharded, chunk = host_local_sharded(
            reader, n_samples, n_features, pad_width, eval_chunk=self.eval_chunk,
            labels_dtype=labels_dtype, device=self.device, group=self.group)
        return self._bound(sharded, chunk, steps_per_epoch)

    def _bound(self, sharded: ShardedData, chunk: int,
               steps_per_epoch: Optional[int]) -> BoundSync:
        bound = BoundSync(
            self.model, sharded, self.batch_size, self.learning_rate,
            sampling=self.sampling, steps_per_epoch=steps_per_epoch,
            eval_chunk=chunk, virtual_workers=self.virtual_workers,
            optimizer=self.optimizer, momentum=self.momentum, group=self.group,
        )
        # the spin-up fast path (DSGD_COMPILE_CACHE): the kernel is built
        # and launched in the background while the fit gets going
        bound._maybe_warmup()
        return bound


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
