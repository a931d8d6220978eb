"""Powers-of-two shape bucketing for the serving forward pass.

The port's copy of the JAX package's serving/bucketing.py: the same
buckets and the same padded arrays, byte for byte.  In JAX each shape is
one compiled program, so both dimensions round up to powers of two (each
with a floor) to keep the compile cache small and warm; the port's
forward is torch ops and compiles nothing, but it keeps the buckets: the
answers, the device batch shapes and the ``serve.jit.compile`` count
stay the JAX server's (a server that has seen B<=64, nnz<=128 traffic
uses at most 7 x 5 = 35 shapes).

Padding is semantically inert by construction: pad cells are
(index=0, value=0), which contribute 0 * w[0] to a margin (ops/sparse.py),
and all-zero pad ROWS produce margins that are sliced off before replies.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from distributed_sgd_tpu_torch.ops.sparse import pad_rows

# Floors keep the tiniest requests from fragmenting the cache into 1/2/4
# buckets that save no meaningful padding work.
MIN_BATCH_BUCKET = 4
MIN_NNZ_BUCKET = 8


def bucket_dim(n: int, minimum: int) -> int:
    """Smallest power of two >= max(n, minimum)."""
    return 1 << (max(int(n), int(minimum)) - 1).bit_length()


def bucket_shape(batch_size: int, max_nnz: int) -> Tuple[int, int]:
    """(batch bucket, nnz bucket) for a flush of `batch_size` rows whose
    widest row has `max_nnz` nonzeros."""
    return (
        bucket_dim(batch_size, MIN_BATCH_BUCKET),
        bucket_dim(max_nnz, MIN_NNZ_BUCKET),
    )


def pack_rows(
    rows: Sequence[Tuple[np.ndarray, np.ndarray]],
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack variable-nnz (indices, values) rows into bucket-padded arrays.

    Returns (indices int32[B, P], values f32[B, P]) with B, P the bucketed
    dims; rows beyond len(rows) and cells beyond each row's nnz are
    (0, 0.0) pads.  The per-row fill (including the largest-|value|
    truncation policy for rows wider than the bucket) is ops.sparse.pad_rows;
    only the batch-dim padding is serving-specific.
    """
    widths: List[int] = [len(idx) for idx, _ in rows]
    b, p = bucket_shape(len(rows), max(widths, default=0))
    idx, val = pad_rows(rows, p)
    out_idx = np.zeros((b, p), dtype=np.int32)
    out_val = np.zeros((b, p), dtype=np.float32)
    out_idx[: len(rows)] = idx
    out_val[: len(rows)] = val
    return out_idx, out_val
