"""The async loss checker: leaky smoothing and best-weights tracking.

The port's own copy of the JAX package's core/loss_check.py (after the
reference's MasterAsync.scala:96-162), shared by the Hogwild and local SGD
engines: ``smoothed_t = c * raw + (1 - c) * smoothed_{t-1}`` (the first
check takes the raw value as its predecessor), a newest-first smoothed
history for the stopping criterion, and the best (loss, weights) so far.

Persisting the best weights (the JAX checker's ``checkpointer``) is not
ported yet: a checkpointer raises.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from distributed_sgd_tpu_torch.core.early_stopping import Criterion
from distributed_sgd_tpu_torch.core.grad_state import GradState
from distributed_sgd_tpu_torch.core.trainer import FitResult


class LossChecker:
    def __init__(self, leaky_loss: float, criterion: Optional[Criterion] = None,
                 checkpointer=None):
        if not (0.0 <= leaky_loss <= 1.0):
            raise ValueError("leaking coefficient must be between 0 and 1")
        if checkpointer is not None:
            raise NotImplementedError(
                "async checkpoints are not ported yet (ROADMAP.md Queue A: "
                "'async checkpoint resume')")
        self.leaky = leaky_loss
        self.criterion = criterion
        self.smoothed: List[float] = []  # newest first
        self.smoothed_accs: List[float] = []  # newest first
        self.best_loss = float("inf")
        self.best_weights: Optional[torch.Tensor] = None

    def check(self, raw_loss: float, raw_acc: float, weights) -> bool:
        """Record one evaluation; True when training should stop."""
        prev = self.smoothed[0] if self.smoothed else raw_loss
        loss = self.leaky * raw_loss + (1 - self.leaky) * prev
        prev_acc = self.smoothed_accs[0] if self.smoothed_accs else raw_acc
        acc = self.leaky * raw_acc + (1 - self.leaky) * prev_acc
        self.smoothed.insert(0, loss)
        self.smoothed_accs.insert(0, acc)
        if loss < self.best_loss:  # MasterAsync.scala:130-139
            self.best_loss = loss
            self.best_weights = torch.as_tensor(weights).clone()
        return self.criterion is not None and self.criterion(self.smoothed)

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
