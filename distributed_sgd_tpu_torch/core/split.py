"""Per-worker sample splits (the reference's SplitStrategy.scala).

The port's own copy of the JAX package's core/split.py: ``vanilla_split``
(the reference's contiguous chunks of ceil(n / n_workers) samples, which
the Hogwild engine and the RPC master use), ``weighted_split``,
``strided_split``, ``shuffled_split`` and ``sampling_bias_bound``.
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


def sampling_bias_bound(n_samples: int, n_workers: int) -> float:
    """Max per-sample over-weighting ratio under vanilla_split + equal
    per-worker averaging (see vanilla_split's docstring): the largest
    partition size over the smallest NON-EMPTY partition size.  1.0 when
    the split is even; == ceil(n/k) / trailing_size otherwise.  Empty
    trailing partitions are excluded — they hold no samples to bias."""
    if n_samples <= 0 or n_workers <= 0:
        return 1.0
    sizes = [len(p) for p in vanilla_split(n_samples, n_workers) if len(p)]
    return max(sizes) / min(sizes)


def weighted_split(n_samples: int, weights: List[int]) -> List[np.ndarray]:
    """Contiguous partitions with sizes proportional to `weights` — the
    host-granular assignment of the hierarchical topology
    (docs/HIERARCHY.md): a host with D devices gets a D-weighted share of
    the corpus, so every device across the cluster owns the same expected
    row count regardless of how devices are packed into hosts.

    Sizes are largest-remainder rounded (deterministic, ties broken by
    position), so they sum to exactly `n_samples` and differ from the
    exact proportional share by < 1 row.  With equal weights this
    degenerates to an even contiguous split — same coverage as
    `vanilla_split` up to the ceil-vs-even tail (the master only takes
    this path when host shapes actually differ)."""
    if not weights or min(weights) < 1:
        raise ValueError(f"weights must be positive, got {weights}")
    total = float(sum(weights))
    exact = [n_samples * w / total for w in weights]
    sizes = [int(e) for e in exact]
    # largest remainder: hand the leftover rows to the biggest fractions
    leftover = n_samples - sum(sizes)
    order = sorted(range(len(weights)), key=lambda i: exact[i] - sizes[i],
                   reverse=True)
    for i in order[:leftover]:
        sizes[i] += 1
    idx = np.arange(n_samples, dtype=np.int64)
    out, at = [], 0
    for s in sizes:
        out.append(idx[at: at + s])
        at += s
    return out


def strided_split(n_samples: int, n_workers: int) -> List[np.ndarray]:
    """Round-robin split: worker i gets samples i, i+k, i+2k, ..."""
    idx = np.arange(n_samples, dtype=np.int64)
    return [idx[i::n_workers] for i in range(n_workers)]


def shuffled_split(n_samples: int, n_workers: int, seed: int = 0) -> List[np.ndarray]:
    """Uniform random permutation then contiguous chunks."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(n_samples).astype(np.int64)
    size = max(1, math.ceil(n_samples / n_workers))
    groups = [idx[i : i + size] for i in range(0, n_samples, size)]
    while len(groups) < n_workers:
        groups.append(np.empty(0, dtype=np.int64))
    return groups[:n_workers]


STRATEGIES = {
    "vanilla": vanilla_split,
    "strided": strided_split,
    "shuffled": shuffled_split,
}
