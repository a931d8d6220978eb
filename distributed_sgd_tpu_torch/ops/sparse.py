"""Padded-sparse batch representation and its two plain torch ops.

    SparseBatch(indices: int32[B, P], values: f32[B, P])

Each row holds one sample's nonzero feature (index, value) pairs padded to
width P with (index=0, value=0).  Zero-valued pads are inert in both ops,
so no explicit mask is carried.

- ``matvec(batch, w) -> f32[B]``: per-sample sparse dot products x_i . w as
  an ``index_select`` gather + multiply + row sum.
- ``scatter_add(batch, coeff, n_features) -> f32[D]``: sum_i coeff_i * x_i
  as one flat ``index_add_``.

``pad_rows`` is the host-side row packer (numpy) that builds such a batch
from variable-nnz rows: the serving batcher's (serving/bucketing.py).

The training step's fused gather + coefficient + scatter for all workers
is the hand-written kernel in ops/worker_grads.py; these ops serve the
evaluation gather and the per-model reference gradient.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch


class SparseBatch(NamedTuple):
    """A batch of sparse rows, padded to a common nnz width.

    indices: int32[B, P] — 0-based feature ids (0 for padding)
    values:  f32[B, P]   — feature values (0.0 for padding)
    """

    indices: torch.Tensor
    values: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.values.shape[0]

    @property
    def pad_width(self) -> int:
        return self.indices.shape[1]


def matvec(batch: SparseBatch, w: torch.Tensor) -> torch.Tensor:
    """Per-row sparse dot product: out[b] = sum_p values[b,p] * w[indices[b,p]].

    Pads contribute 0 * w[0] = 0.  Accumulates in f32.
    """
    gathered = w.index_select(0, batch.indices.reshape(-1)).view(batch.indices.shape)
    return (batch.values.float() * gathered.float()).sum(dim=-1)


def scatter_add(batch: SparseBatch, coeff: torch.Tensor, n_features: int) -> torch.Tensor:
    """out = sum_b coeff[b] * x_b as one flat scatter-add.

    Pads scatter 0.0 into feature 0.
    """
    flat_val = (batch.values.float() * coeff.float()[:, None]).reshape(-1)
    out = torch.zeros(n_features, dtype=torch.float32, device=flat_val.device)
    return out.index_add_(0, batch.indices.reshape(-1), flat_val)


def pad_rows(
    rows: Sequence[Tuple[np.ndarray, np.ndarray]],
    pad_width: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: pack variable-nnz (indices, values) rows into [B, P] arrays.

    Rows longer than `pad_width` are truncated by largest-|value| (keeps the
    heaviest features); shorter rows are zero-padded.
    """
    b = len(rows)
    out_idx = np.zeros((b, pad_width), dtype=np.int32)
    out_val = np.zeros((b, pad_width), dtype=np.float32)
    for i, (idx, val) in enumerate(rows):
        n = len(idx)
        if n > pad_width:
            keep = np.argsort(-np.abs(val))[:pad_width]
            keep.sort()
            idx, val = idx[keep], val[keep]
            n = pad_width
        out_idx[i, :n] = idx
        out_val[i, :n] = val
    return out_idx, out_val
