"""Immutable training-state record.

Equivalent of the reference's ``GradState``
(core/ml/GradState.scala:6-24): weights + running loss + wall-clock
start/end + update count.  ``update`` applies a delta ``w <- w - d`` and
bumps the counter (GradState.scala:8); ``finish`` stamps the end time
(GradState.scala:12).  Weights may be a numpy array or a torch tensor.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True, eq=False)  # eq=False: array-valued weights break generated __eq__
class GradState:
    weights: Any
    loss: float = float("nan")
    start: float = dataclasses.field(default_factory=time.time)
    updates: int = 0
    end: Optional[float] = None

    def update(self, delta: Any) -> "GradState":
        return dataclasses.replace(self, weights=self.weights - delta, updates=self.updates + 1)

    def replace_weights(self, weights: Any, loss: Optional[float] = None) -> "GradState":
        kw = {"weights": weights, "updates": self.updates + 1}
        if loss is not None:
            kw["loss"] = loss
        return dataclasses.replace(self, **kw)

    def finish(self) -> "GradState":
        return dataclasses.replace(self, end=time.time())

    @property
    def duration(self) -> Optional[float]:
        return None if self.end is None else self.end - self.start
