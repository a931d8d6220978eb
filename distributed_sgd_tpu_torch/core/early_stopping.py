"""Early-stopping criteria over newest-first loss sequences.

Faithful re-implementation of the reference's ``EarlyStopping``
(core/ml/EarlyStopping.scala:7-46).  A criterion is a callable
``losses -> bool`` where ``losses[0]`` is the NEWEST loss.

The ``no_improvement`` tolerance scan reproduces the reference's quirk
exactly (EarlyStopping.scala:18-28): the fold accepts any value within
``min_delta`` of the running minimum as the new minimum, so a *later*
near-tie wins the min index — this makes the criterion more patient with
plateaus than a strict argmin would be.  Training stops when the winning
index is >= ``patience`` (i.e. the effective min is at least `patience`
evaluations old).
"""

from __future__ import annotations

import sys
from typing import Callable, Optional, Sequence

Criterion = Callable[[Sequence[float]], bool]


def target(target_loss: float) -> Criterion:
    """Stop once the newest loss is <= target. EarlyStopping.scala:11."""

    def criterion(losses: Sequence[float]) -> bool:
        return len(losses) > 0 and losses[0] <= target_loss

    return criterion


def no_improvement(
    patience: int = 5,
    min_delta: float = 1e-3,
    min_steps: Optional[int] = None,
) -> Criterion:
    """Stop when the (tolerance-scanned) min loss is >= `patience` old.

    EarlyStopping.scala:13-46, including the fold-based findMin quirk.
    """
    abs_min_delta = abs(min_delta)

    def find_min_index(losses: Sequence[float]) -> int:
        cur_min, idx_min = sys.float_info.max, -1
        for i, v in enumerate(losses):
            if (v - cur_min) <= abs_min_delta:  # accepts later near-ties
                cur_min, idx_min = v, i
        return idx_min

    def criterion(losses: Sequence[float]) -> bool:
        if not losses:
            return False
        # minSteps semantics reproduced verbatim from EarlyStopping.scala:45
        # (`if (steps < losses.size) false else check`): the check only runs
        # while the history is no longer than min_steps, and is permanently
        # disabled once it grows past it.  This looks inverted from the
        # intent, but the reference always passes minSteps=None
        # (Main.scala:88-107), so the quirk is latent; we keep it for parity.
        if min_steps is not None and min_steps < len(losses):
            return False
        idx_min = find_min_index(losses)
        if idx_min == 0:  # newest is the min -> still improving
            return False
        return idx_min >= patience

    return criterion
