"""The async loss checker: leaky smoothing and best-weights tracking.

The port's own copy of the JAX package's core/loss_check.py (after the
reference's MasterAsync.scala:96-162), shared by the Hogwild and local SGD
engines: ``smoothed_t = c * raw + (1 - c) * smoothed_{t-1}`` (the first
check takes the raw value as its predecessor), a newest-first smoothed
history for the stopping criterion, and the best (loss, weights) so far.

With a checkpointer (checkpoint.py) the checker resumes from the latest
snapshot (the best loss and weights, both smoothed histories and the
lifetime update count) and saves the best weights with the whole history
on each improvement and on every `save_every`-th check without one, at
steps past the restored one.  The best weights stay a tensor on the
engine's device; a save copies them to the host.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from distributed_sgd_tpu_torch.core.early_stopping import Criterion
from distributed_sgd_tpu_torch.core.grad_state import GradState
from distributed_sgd_tpu_torch.core.trainer import FitResult
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device


class LossChecker:
    def __init__(self, leaky_loss: float, criterion: Optional[Criterion] = None,
                 checkpointer=None, save_every: int = 10, device: DeviceLike = None):
        """`checkpointer`: a checkpoint.Checkpointer (or any object with
        ``save``/``restore_latest``); `device`: where restored best weights
        are put (the card unless given; read only with a checkpointer)."""
        if not (0.0 <= leaky_loss <= 1.0):
            raise ValueError("leaking coefficient must be between 0 and 1")
        self.leaky = leaky_loss
        self.criterion = criterion
        self.checkpointer = checkpointer
        # saves on every improvement, and on every save_every-th check
        # without one, so a long plateau does not pay a write per check
        self.save_every = max(1, int(save_every))
        self._checks_since_save = 0
        # saves land past the restored step: a step that exists is not
        # written again, and restore_latest takes the highest
        self._step_base = 0
        self.smoothed: List[float] = []  # newest first
        self.smoothed_accs: List[float] = []  # newest first
        self.best_loss = float("inf")
        self.best_weights: Optional[torch.Tensor] = None
        # the lifetime update count at the last snapshot, which the engines
        # seed their counters from (maxSteps counts lifetime updates,
        # MasterAsync.scala:83); _updates_seen is its monotone high-water
        # mark, the count each save persists
        self.restored_updates = 0
        self._updates_seen = 0
        if checkpointer is not None:
            restored = checkpointer.restore_latest()
            if restored is not None:
                step, state = restored
                self._step_base = step + 1
                # a resumed run's first, maybe worse, check must not shadow
                # the prior run's best; its smoothing chains from the prior
                # values, and its criterion sees the whole history
                if "best_loss" in state:
                    self.best_loss = float(state["best_loss"])
                    self.best_weights = torch.as_tensor(
                        np.asarray(state["weights"], np.float32), device=resolve_device(device))
                if "smoothed_nf" in state:
                    self.smoothed = [float(x) for x in np.asarray(state["smoothed_nf"])]
                if "smoothed_accs_nf" in state:
                    self.smoothed_accs = [float(x) for x in np.asarray(state["smoothed_accs_nf"])]
                if "updates" in state:
                    self.restored_updates = int(state["updates"])
                    self._updates_seen = self.restored_updates

    def check(self, raw_loss: float, raw_acc: float, weights,
              step: Optional[int] = None) -> bool:
        """Record one evaluation; True when training should stop.  `step`
        (the engine's lifetime update count) labels the saved snapshot; it
        defaults to the number of checks so far."""
        if step is not None:
            self._updates_seen = max(self._updates_seen, int(step))
        prev = self.smoothed[0] if self.smoothed else raw_loss
        loss = self.leaky * raw_loss + (1 - self.leaky) * prev
        prev_acc = self.smoothed_accs[0] if self.smoothed_accs else raw_acc
        acc = self.leaky * raw_acc + (1 - self.leaky) * prev_acc
        self.smoothed.insert(0, loss)
        self.smoothed_accs.insert(0, acc)
        improved = loss < self.best_loss  # MasterAsync.scala:130-139
        if improved:
            self.best_loss = loss
            self.best_weights = torch.as_tensor(weights).clone()
        self._checks_since_save += 1
        # never before a finite best: the current (maybe divergent) weights
        # are not saved as the best
        if self.checkpointer is not None and self.best_weights is not None and (
                improved or self._checks_since_save >= self.save_every):
            self.checkpointer.save(
                self._step_base + (step if step is not None else len(self.smoothed)),
                self.best_weights,
                extra={
                    "best_loss": self.best_loss,
                    "smoothed_nf": np.asarray(self.smoothed, np.float32),
                    "smoothed_accs_nf": np.asarray(self.smoothed_accs, np.float32),
                    "updates": self._updates_seen,
                },
            )
            self._checks_since_save = 0
        return self.criterion is not None and self.criterion(self.smoothed)

    def refresh(self, best_loss: Optional[float] = None, best_weights=None) -> None:
        """Rotate the baseline onto a new evaluation set: clear both
        histories and the best, then take `best_loss` (and `best_weights`)
        if finite, measured by the caller on the new rows.  The
        checkpointer and the lifetime update count are untouched."""
        self.smoothed = []
        self.smoothed_accs = []
        self.best_loss = float("inf")
        self.best_weights = None
        if best_loss is not None and np.isfinite(best_loss):
            self.best_loss = float(best_loss)
            if best_weights is not None:
                self.best_weights = torch.as_tensor(best_weights).clone()

    @property
    def history(self) -> List[float]:
        """Chronological smoothed losses."""
        return list(reversed(self.smoothed))

    @property
    def acc_history(self) -> List[float]:
        return list(reversed(self.smoothed_accs))


def async_fit_result(checker: LossChecker, w0: torch.Tensor, t_start: float,
                     updates: int, batch_size: int, n_samples: int) -> FitResult:
    """An async fit's FitResult from the checker: the BEST weights, not the
    last (MasterAsync.scala:87-94), an infinite best loss as nan, and
    epochs_run computed back from the update count."""
    best = checker.best_weights if checker.best_weights is not None else w0
    result = FitResult(state=GradState(
        weights=best,
        loss=checker.best_loss if checker.best_loss != float("inf") else float("nan"),
        start=t_start,
        updates=updates,
    ).finish())
    result.test_losses = checker.history
    result.test_accuracies = checker.acc_history
    result.epochs_run = updates * batch_size // max(n_samples, 1)
    return result
