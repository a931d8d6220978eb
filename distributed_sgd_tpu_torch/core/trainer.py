"""Host-side training driver: epoch loop, evaluation, early stopping.

The port of distributed_sgd_tpu/core/trainer.py's SyncTrainer: run one
epoch of the sync engine (parallel/sync.py), evaluate train + test
objective/accuracy on the device, feed the *test* loss history (newest
first) to the stopping criterion.  Epoch e's sampling key is
``fold_in(seed, e)``, by absolute epoch, so a resumed fit continues the
same sampling stream.

With a checkpointer (checkpoint.py) the fit resumes from the latest
snapshot (weights, the test-loss history, the optimizer's state) and
saves every `checkpoint_every` epochs and at an off-cadence end.  With
`profile_dir` one epoch's training (no evaluation) runs under
``torch.profiler`` and its Chrome trace is written to
``<profile_dir>/trainer-epoch<e>.trace.json``.

Over a process group (parallel/mesh.py) every rank runs the same loop on
its shard: the evaluations are all-reduced, so every rank sees the same
history and stops at the same epoch.  Every rank restores the latest
snapshot; only rank 0 writes, and the fit ends with a barrier so that a
next fit on any rank finds rank 0's last snapshot.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from distributed_sgd_tpu_torch.checkpoint import (
    for_rank,
    opt_kind_tag,
    restore_sync_fit,
    save_sync_fit,
    save_sync_fit_final,
)
from distributed_sgd_tpu_torch.core.early_stopping import Criterion
from distributed_sgd_tpu_torch.core.grad_state import GradState
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, barrier, rank, world_size
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, fold_in
from distributed_sgd_tpu_torch.utils import measure
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

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


def profile_trace_path(profile_dir: str, epoch: int) -> str:
    """The Chrome trace file of the profiled epoch `epoch`."""
    return os.path.join(profile_dir, f"trainer-epoch{epoch}.trace.json")


class SyncTrainer:
    """Bulk-synchronous data-parallel trainer, one rank a device."""

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
        checkpoint_every: int = 1,
        profile_dir: Optional[str] = None,
        metrics: Optional[metrics_mod.Metrics] = None,
        device: DeviceLike = None,
        group=None,
    ):
        """`checkpointer`: a checkpoint.Checkpointer (or any object with
        ``save``/``restore_latest``) to resume from and save to every
        `checkpoint_every` epochs; `profile_dir`: where the profiled
        epoch's trace goes (`profile_trace_path`); `group`: the process
        group whose ranks are the workers (the default group when None)."""
        if checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        self.engine = SyncEngine(
            model, batch_size, learning_rate, sampling=sampling,
            virtual_workers=virtual_workers, optimizer=optimizer, momentum=momentum,
            device=device, group=group,
        )
        self._opt_kind = opt_kind_tag(optimizer)
        self.model = model
        self.seed = seed
        self.group = group
        self.checkpointer = for_rank(checkpointer, rank(group))
        self.checkpoint_every = int(checkpoint_every)
        self.profile_dir = profile_dir
        self.metrics = metrics or metrics_mod.global_metrics()

    def _start_profile(self):
        """A running torch.profiler (CPU, and CUDA on the card), or None
        when it fails to start: the profile is best-effort."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        try:
            prof = torch.profiler.profile(activities=acts)
            prof.start()
        except Exception as e:  # noqa: BLE001 - profiling must not stop the fit
            log.warning("torch.profiler capture failed to start: %s", e)
            return None
        return prof

    def _stop_profile(self, prof, epoch: int) -> None:
        try:
            prof.stop()
            os.makedirs(self.profile_dir, exist_ok=True)
            path = profile_trace_path(self.profile_dir, epoch)
            prof.export_chrome_trace(path)
        except Exception as e:  # noqa: BLE001 - profiling must not stop the fit
            log.warning("torch.profiler capture failed: %s", e)
            return
        log.info("profiler trace written to %s", path)

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

        start_epoch = 0
        restored = restore_sync_fit(
            self.checkpointer, self._opt_kind, bound_train.opt_state_leaves())
        if restored is not None:
            # the criterion sees the whole newest-first history, and the
            # optimizer resumes where it stopped (adam's count included);
            # a snapshot of another optimizer or layout raises
            start_epoch, w_np, test_losses_newest_first, opt_leaves = restored
            w = torch.as_tensor(np.asarray(w_np, dtype=np.float32), device=device)
            if opt_leaves:
                bound_train.load_opt_state_leaves(opt_leaves)
            log.info("resumed from checkpoint at epoch %d", start_epoch)

        if start_epoch >= max_epochs:
            # a resumed fit with nothing left to run reports the restored
            # weights' loss and the epochs already run, not 0 and nan
            loss, acc = bound_train.evaluate(w)
            log.info("checkpoint already at epoch %d >= max_epochs %d: nothing to "
                     "run (loss=%.6f acc=%.4f)", start_epoch, max_epochs, loss, acc)
            result.epochs_run = start_epoch
            result.state = GradState(weights=w, loss=loss).finish()
            return result

        # the second epoch of this run (the first builds the kernel), or
        # the only one
        profile_epoch = start_epoch + 1 if max_epochs > start_epoch + 1 else start_epoch
        profiled = False
        for epoch in range(start_epoch, max_epochs):
            prof = None
            if self.profile_dir is not None and epoch == profile_epoch:
                prof, profiled = self._start_profile(), True
            t0 = time.perf_counter()
            with measure.span("trainer.epoch", metrics=self.metrics), \
                    self.metrics.timer("master.sync.batch.duration"):
                w = bound_train.epoch(w, fold_in(self.seed, epoch))
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
            epoch_s = time.perf_counter() - t0
            if prof is not None:
                self._stop_profile(prof, epoch)

            loss, acc = bound_train.evaluate(w)
            test_loss, test_acc = bound_test.evaluate(w)
            record_epoch(result, test_losses_newest_first, epoch,
                         loss, acc, test_loss, test_acc, epoch_s)
            self.metrics.histogram("master.sync.loss").record(loss)
            self.metrics.histogram("master.sync.acc").record(100 * acc)
            self.metrics.histogram("master.sync.epoch.seconds").record(epoch_s)
            log.info(
                "epoch %d: loss=%.6f acc=%.4f test_loss=%.6f test_acc=%.4f (%.2fs)",
                epoch, loss, acc, test_loss, test_acc, epoch_s,
            )
            if self.checkpointer is not None and (epoch + 1) % self.checkpoint_every == 0:
                save_sync_fit(self.checkpointer, epoch + 1, w, test_losses_newest_first,
                              self._opt_kind, bound_train.opt_state_leaves())
            if criterion is not None and criterion(test_losses_newest_first):
                log.info("Converged to target: stopping computation")
                break
        else:
            log.info("Reached max number of epochs: stopping computation")
        save_sync_fit_final(
            self.checkpointer, result.epochs_run, start_epoch, self.checkpoint_every, w,
            test_losses_newest_first, self._opt_kind, bound_train.opt_state_leaves())
        if self.profile_dir is not None and not profiled:
            log.warning("no profiler trace captured: the fit stopped before epoch %d",
                        profile_epoch)
        if world_size(self.group) > 1:
            barrier(self.group)  # rank 0's last snapshot is written before any rank goes on

        result.state = GradState(
            weights=w, loss=result.losses[-1] if result.losses else float("nan")
        ).finish()
        return result

    def predict(self, weights, data: Dataset) -> np.ndarray:
        """The model's predictions over a split (Master.predict)."""
        return self.engine.bind(data).predict(self._on_device(weights))

    def evaluate(self, weights, data: Dataset):
        """(objective, accuracy) over a split, as `fit` evaluates it."""
        return self.engine.bind(data).evaluate(self._on_device(weights))

    def _on_device(self, weights) -> torch.Tensor:
        if isinstance(weights, torch.Tensor):
            return weights.to(self.engine.device)
        return torch.as_tensor(np.asarray(weights, dtype=np.float32), device=self.engine.device)
