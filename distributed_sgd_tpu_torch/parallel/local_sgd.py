"""Local SGD with periodic averaging, one worker a rank.

The port of the JAX package's parallel/local_sgd.py, the on-mesh
alternative to Hogwild in the same convergence family: every worker runs
``sync_period`` (h) independent SGD steps on its own replica of w, then
the replicas average.  Each rank of the process group (parallel/mesh.py)
is one worker: a round is h local steps and the average, an
``all_reduce_sum`` over the ranks divided by their count, the JAX
engine's ``pmean`` (the identity in a world of one).  A round's h steps
are one ``sync_epoch`` launch in the mean mode (``MeanSteps``).

The optimizer ('sgd', or the JAX engine's optax 'momentum' or 'adam')
keeps its state across rounds.  After each round, as in the JAX engine,
the state's float vectors are averaged like the weights and adam's step
count is kept as the maximum over the ranks (``all_reduce_max``).

Sampling is the JAX engine's: each step draws B ids uniformly, with
replacement, over this rank's PADDED shard as ``SyncEngine.bind`` lays it
out.  Pad rows carry label 0: they add nothing to the gradient sum and
count in the mean's B.  Round r's ids come from a generator on the device
seeded with ``fold_in(seed, r)``, folded again with the rank past rank 0
(the JAX engine folds its mesh position into the round's key);
`_sample_ids` is the seam where tests put the JAX engine's own draws.

Around the rounds runs the reference's async loss checker: the leaky
smoothed test loss every `check_every` local steps, the best weights, the
early stop on the smoothed history and the budget of ``n_samples *
max_epochs`` steps (MasterAsync.scala:83,96-162).  With a checkpointer the
checker saves the best weights and its history, and a resumed fit spends
only the rest of the lifetime budget; the optimizer state is not saved,
as in the JAX engine.  Every rank restores the snapshot; only rank 0
writes one.
"""

from __future__ import annotations

import logging
import time
from typing import Optional

import numpy as np
import torch

from distributed_sgd_tpu_torch.checkpoint import for_rank
from distributed_sgd_tpu_torch.core.early_stopping import Criterion
from distributed_sgd_tpu_torch.core.loss_check import LossChecker, async_fit_result
from distributed_sgd_tpu_torch.core.trainer import FitResult
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.ops.sync_epoch import OptState
from distributed_sgd_tpu_torch.parallel.mesh import (
    DeviceLike,
    all_reduce_max,
    all_reduce_sum,
    barrier,
    rank,
    resolve_device,
    world_size,
)
from distributed_sgd_tpu_torch.parallel.sync import (
    MeanSteps,
    SyncEngine,
    fold_in,
    resolve_optimizer,
)
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.local_sgd")


class LocalSGDEngine:
    def __init__(
        self,
        model: LinearModel,
        batch_size: int,
        learning_rate: float,
        sync_period: int = 16,
        check_every: int = 100,
        leaky_loss: float = 0.9,
        seed: int = 0,
        metrics: Optional[metrics_mod.Metrics] = None,
        checkpointer=None,
        optimizer=None,
        momentum: float = 0.9,
        device: DeviceLike = None,
        group=None,
    ):
        """`group`: the process group whose ranks are the workers (the
        default group when None)."""
        if not (0.0 <= leaky_loss <= 1.0):
            raise ValueError("leaking coefficient must be between 0 and 1")
        if sync_period < 1:
            raise ValueError("sync_period must be >= 1")
        self.optimizer = resolve_optimizer(optimizer, momentum)
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine on {self.device}")
        self.model = model
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.sync_period = int(sync_period)
        self.check_every = check_every
        self.leaky_loss = leaky_loss
        self.seed = seed
        self.checkpointer = checkpointer  # persists the best weights (LossChecker)
        self.metrics = metrics or metrics_mod.global_metrics()
        self.group = group
        self.n_workers = world_size(group)
        self.rank = rank(group)

    def _sample_ids(self, rnd: int, shard_n: int) -> torch.Tensor:
        """Round `rnd`'s ids, int64[sync_period, 1, B] in [0, shard_n)."""
        key = fold_in(self.seed, rnd)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(key if self.rank == 0 else fold_in(key, self.rank))
        return torch.randint(0, shard_n, (self.sync_period, 1, self.batch_size),
                             generator=gen, device=self.device)

    def fit(
        self,
        train: Dataset,
        test: Dataset,
        max_epochs: int,
        criterion: Optional[Criterion] = None,
        initial_weights: Optional[np.ndarray] = None,
    ) -> FitResult:
        engine = SyncEngine(self.model, self.batch_size, self.learning_rate,
                            device=self.device, group=self.group)
        bound = engine.bind(train)  # the padded shard, as the sync engine lays it out
        eval_bound = engine.bind(test)
        data = bound.data
        steps = MeanSteps(self.model, data.indices, data.values, data.labels,
                          self.learning_rate, self.optimizer)
        state = steps.init_state()  # made once, averaged at every sync point
        h = self.sync_period
        n = len(train)
        max_steps = n * max_epochs  # MasterAsync.scala:83
        w = (torch.zeros(self.model.n_features, dtype=torch.float32, device=self.device)
             if initial_weights is None
             else torch.as_tensor(np.asarray(initial_weights, dtype=np.float32)).to(self.device))
        checker = LossChecker(self.leaky_loss, criterion,
                              checkpointer=for_rank(self.checkpointer, self.rank),
                              device=self.device)
        # maxSteps is a lifetime budget (MasterAsync.scala:83): a resumed fit
        # seeds its step counter from the snapshot and runs only the rest
        steps_done = checker.restored_updates
        last_check = steps_done - self.check_every
        t_start = time.time()
        rnd = 0
        round_seconds = self.metrics.histogram("slave.async.round.seconds")

        while steps_done < max_steps:
            t0 = time.perf_counter()
            w, state = steps.run(w, self._sample_ids(rnd, bound.shard_n), state)
            w = all_reduce_sum(w, self.group) / self.n_workers  # the replicas' average
            state = OptState(tuple(all_reduce_sum(v, self.group) / self.n_workers
                                   for v in state.vectors),
                             all_reduce_max(state.count, self.group))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            round_seconds.record(time.perf_counter() - t0)
            rnd += 1
            steps_done += self.n_workers * h
            if steps_done - last_check < self.check_every:
                continue
            raw_loss, raw_acc = eval_bound.evaluate(w)
            stop = checker.check(raw_loss, raw_acc, w, step=steps_done)
            log.info("loss computed at %d updates: test_loss=%.6f test_acc=%.4f",
                     steps_done, checker.smoothed[0], checker.smoothed_accs[0])
            last_check = steps_done
            if stop:
                log.info("converged to target: stopping computation")
                break

        if self.n_workers > 1:
            barrier(self.group)  # rank 0's last snapshot is written before any rank goes on
        return async_fit_result(checker, w, t_start, steps_done, self.batch_size, n)
