"""Contiguous per-worker sample split, the reference's vanilla strategy.

The port's own copy of ``vanilla_split`` from the JAX package
(distributed_sgd_tpu/core/split.py, after the reference's
SplitStrategy.scala:13-14): contiguous chunks of ceil(n / n_workers)
samples.  The Hogwild engine gives each worker one chunk of the train
split (parallel/hogwild.py).
"""

from __future__ import annotations

import math
from typing import List

import numpy as np


def vanilla_split(n_samples: int, n_workers: int) -> List[np.ndarray]:
    """Contiguous ``grouped(ceil(n/k))`` split.

    The final group may be short, and when k does not divide n the number
    of non-empty groups can be < n_workers; the sizes are the reference's,
    and n_workers entries always come back (trailing ones may be empty).
    """
    idx = np.arange(n_samples, dtype=np.int64)
    size = max(1, math.ceil(n_samples / n_workers))
    groups = [idx[i : i + size] for i in range(0, n_samples, size)]
    while len(groups) < n_workers:
        groups.append(np.empty(0, dtype=np.int64))
    return groups[:n_workers]
