"""Host-side training driver: epoch loop, evaluation, early stopping.

The port of distributed_sgd_tpu/core/trainer.py's SyncTrainer: run one
epoch of the sync engine (parallel/sync.py), evaluate train + test
objective/accuracy on the device, feed the *test* loss history (newest
first) to the stopping criterion.  Epoch e's sampling key is
``fold_in(seed, e)``.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from distributed_sgd_tpu_torch.core.early_stopping import Criterion
from distributed_sgd_tpu_torch.core.grad_state import GradState
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, fold_in

log = logging.getLogger("dsgd.trainer")


@dataclass
class FitResult:
    state: GradState
    losses: List[float] = field(default_factory=list)  # chronological
    accuracies: List[float] = field(default_factory=list)
    test_losses: List[float] = field(default_factory=list)
    test_accuracies: List[float] = field(default_factory=list)
    epochs_run: int = 0
    epoch_seconds: List[float] = field(default_factory=list)
    steps_per_epoch: int = 0

    @property
    def weights(self):
        return self.state.weights


def record_epoch(result: FitResult, test_newest_first: List[float], epoch: int,
                 loss: float, acc: float, test_loss: float, test_acc: float,
                 epoch_s: float) -> None:
    """Epoch-end bookkeeping: the four series + wall clock, epochs_run, and
    the NEWEST-FIRST test-loss history the stopping criterion consumes."""
    result.losses.append(loss)
    result.accuracies.append(acc)
    result.test_losses.append(test_loss)
    result.test_accuracies.append(test_acc)
    result.epoch_seconds.append(epoch_s)
    result.epochs_run = epoch + 1
    test_newest_first.insert(0, test_loss)


class SyncTrainer:
    """Bulk-synchronous data-parallel trainer on one device."""

    def __init__(
        self,
        model: LinearModel,
        batch_size: int,
        learning_rate: float,
        sampling: str = "fresh",
        seed: int = 0,
        virtual_workers: int = 1,
        optimizer=None,
        momentum: float = 0.9,
        checkpointer=None,
        profile_dir: Optional[str] = None,
        device: DeviceLike = None,
    ):
        if checkpointer is not None:
            raise NotImplementedError(
                "checkpointing is not ported yet (ROADMAP.md Queue A: 'sync "
                "checkpoints')")
        if profile_dir is not None:
            raise NotImplementedError(
                "profile_dir is not ported yet (ROADMAP.md Queue A: 'profiler "
                "trace of an epoch')")
        self.engine = SyncEngine(
            model, batch_size, learning_rate, sampling=sampling,
            virtual_workers=virtual_workers, optimizer=optimizer, momentum=momentum,
            device=device,
        )
        self.model = model
        self.seed = seed

    def fit(
        self,
        train: Dataset,
        test: Dataset,
        max_epochs: int,
        criterion: Optional[Criterion] = None,
        initial_weights=None,
    ) -> FitResult:
        bound_train = self.engine.bind(train)
        bound_test = self.engine.bind(test)
        device = self.engine.device
        if initial_weights is None:
            w = torch.zeros(self.model.n_features, dtype=torch.float32, device=device)
        else:
            w = torch.as_tensor(np.asarray(initial_weights, dtype=np.float32), device=device)
        result = FitResult(state=GradState(weights=w),
                           steps_per_epoch=bound_train.steps_per_epoch)
        test_losses_newest_first: List[float] = []

        for epoch in range(max_epochs):
            t0 = time.perf_counter()
            w = bound_train.epoch(w, fold_in(self.seed, epoch))
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            epoch_s = time.perf_counter() - t0

            loss, acc = bound_train.evaluate(w)
            test_loss, test_acc = bound_test.evaluate(w)
            record_epoch(result, test_losses_newest_first, epoch,
                         loss, acc, test_loss, test_acc, epoch_s)
            log.info(
                "epoch %d: loss=%.6f acc=%.4f test_loss=%.6f test_acc=%.4f (%.2fs)",
                epoch, loss, acc, test_loss, test_acc, epoch_s,
            )
            if criterion is not None and criterion(test_losses_newest_first):
                log.info("Converged to target: stopping computation")
                break
        else:
            if max_epochs > 0:
                log.info("Reached max number of epochs: stopping computation")

        result.state = GradState(
            weights=w, loss=result.losses[-1] if result.losses else float("nan")
        ).finish()
        return result
