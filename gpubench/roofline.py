"""Peaks of the card and the operations and bytes of the work, from shapes.

Each input byte is counted once and each output byte once, whatever the
kernel reads again; rows drawn more than once in a launch are read once
(the expected number of distinct rows of uniform draws with replacement).
Work that depends on the data is counted as these inputs need it, not as
the most it could.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

# the device function of csrc/sync_epoch.cu whose launches sync_epoch_launch
# counts, as the trace names it: "(anonymous namespace)::sync_epoch_kernel(...)"
SYNC_EPOCH_KERNEL = "sync_epoch_kernel("

ROW_BYTES_PER_ENTRY = 8  # an int32 feature id and an f32 value
ID_BYTES = 8  # an int64 sample id


@dataclass(frozen=True)
class Work:
    flops: float = 0.0
    bytes: float = 0.0

    def __add__(self, other: "Work") -> "Work":
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def __mul__(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)

    def least_seconds(self) -> float:
        """The least time the card could take: the larger of the two bounds."""
        return max(self.flops / F32_FLOPS, self.bytes / HBM_BYTES_PER_S)

    def bound_by(self) -> str:
        return "bytes" if self.bytes / HBM_BYTES_PER_S >= self.flops / F32_FLOPS else "flops"


def distinct_draws(draws: int, pool: int) -> float:
    """Expected distinct rows among `draws` uniform draws from `pool` rows."""
    if pool <= 0 or draws <= 0:
        return 0.0
    return pool * -math.expm1(draws * math.log1p(-1.0 / pool)) if pool > 1 else 1.0


def sync_epoch_launch(steps: int, workers: int, batch: int, nnz: int, n_features: int,
                      pool_per_worker: int, n_state: int, reads_dim_sparsity: bool,
                      sweep_ops_per_feature: int) -> Work:
    """One ``sync_epoch`` launch of `steps` steps of `workers` x `batch`
    draws, each worker from its own `pool_per_worker` rows.

    Bytes: the distinct rows drawn (ids and values, and the label), the
    ids, w read and written, dim_sparsity read where the regulariser reads
    it, each optimizer state vector read and written.  Operations: a
    multiply and an add a row entry for the margin and again for the
    scatter, and `sweep_ops_per_feature` a feature a step for an update
    that touches every feature (adam), none for one that touches only the
    drawn features (sgd: folded into the scatter's count)."""
    rows = workers * distinct_draws(steps * batch, pool_per_worker)
    vectors = 2 + (1 if reads_dim_sparsity else 0) + 2 * n_state
    nbytes = rows * (nnz * ROW_BYTES_PER_ENTRY + 4) + steps * workers * batch * ID_BYTES \
        + vectors * 4 * n_features
    flops = 4.0 * nnz * steps * workers * batch + steps * n_features * sweep_ops_per_feature
    return Work(flops, nbytes)


def evaluation(rows: int, nnz: int, n_features: int) -> Work:
    """One evaluation of `rows` rows: each row's entries and label read
    once and w once; a multiply and an add an entry, and four operations a
    row for the prediction, the loss and the hit."""
    return Work(2.0 * nnz * rows + 4.0 * rows,
                rows * (nnz * ROW_BYTES_PER_ENTRY + 4) + 4 * n_features)
