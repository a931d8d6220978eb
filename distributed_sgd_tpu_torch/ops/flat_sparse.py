"""Flat (CSR-style) sparse batch: the reference's SparseArrayVector analogue.

The port of the JAX package's ops/flat_sparse.py.  One entry per stored
nonzero, each tagged with its row:

    FlatSparseBatch(indices: int32[T], values: f32[T], rows: int32[T], n_rows)

Against the padded ``SparseBatch`` (ops/sparse.py) it wastes no slot on
padding when the rows' nonzero counts vary widely.  Its two ops mirror
ops/sparse.py in plain torch:

- ``matvec``: per-row dots as a gather, a multiply and an ``index_add_``
  over the rows;
- ``scatter_add``: ``sum_i coeff_i * x_i`` as one flat ``index_add_``.

On the card ``index_add_`` adds with atomics, in no fixed order, so two
calls may differ in the last bits of a sum.  T may be padded to a fixed
size with (index 0, value 0, row 0) entries, inert in both ops.  The
constructors flatten on the host and put the result on the card unless
the caller asks for the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import numpy as np
import torch

from distributed_sgd_tpu_torch.ops.sparse import SparseBatch
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device


@dataclass(frozen=True)
class FlatSparseBatch:
    """One entry per stored nonzero, row-tagged; padded entries carry 0s.

    indices: int32[T] -- 0-based feature ids (0 for padding)
    values:  f32[T]   -- feature values (0.0 for padding)
    rows:    int32[T] -- the row of each entry (0 for padding)
    n_rows:  int      -- the batch size B
    """

    indices: torch.Tensor
    values: torch.Tensor
    rows: torch.Tensor
    n_rows: int

    def _replace(self, **kw) -> "FlatSparseBatch":
        return replace(self, **kw)


def matvec(batch: FlatSparseBatch, w: torch.Tensor) -> torch.Tensor:
    """out[b] = sum over the entries of row b of values * w[indices]."""
    prod = batch.values.float() * w.index_select(0, batch.indices).float()
    out = torch.zeros(batch.n_rows, dtype=torch.float32, device=prod.device)
    return out.index_add_(0, batch.rows, prod)


def scatter_add(batch: FlatSparseBatch, coeff: torch.Tensor, n_features: int) -> torch.Tensor:
    """out = sum_b coeff[b] * x_b: ops.sparse.scatter_add for the flat layout."""
    weighted = batch.values.float() * coeff.float().index_select(0, batch.rows)
    out = torch.zeros(n_features, dtype=torch.float32, device=weighted.device)
    return out.index_add_(0, batch.indices, weighted)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _pack(flat_idx: np.ndarray, flat_val: np.ndarray, rows: np.ndarray, n_rows: int,
          total: Optional[int], device: DeviceLike) -> FlatSparseBatch:
    """The flat arrays padded to `total` entries (default: none), on `device`."""
    t = int(total) if total is not None else len(flat_idx)
    if len(flat_idx) > t:
        raise ValueError(f"{len(flat_idx)} stored entries exceed total={t}")
    out_i = np.zeros(t, dtype=np.int32)
    out_v = np.zeros(t, dtype=np.float32)
    out_r = np.zeros(t, dtype=np.int32)
    out_i[: len(flat_idx)] = flat_idx
    out_v[: len(flat_val)] = flat_val
    out_r[: len(rows)] = rows
    dev = resolve_device(device)
    return FlatSparseBatch(indices=torch.from_numpy(out_i).to(dev),
                           values=torch.from_numpy(out_v).to(dev),
                           rows=torch.from_numpy(out_r).to(dev), n_rows=int(n_rows))


def from_padded(batch: SparseBatch, total: Optional[int] = None,
                device: DeviceLike = None) -> FlatSparseBatch:
    """Flatten a padded [B, P] batch (tensors or host arrays), dropping its
    pad slots (value 0), on the host.  `total` pads the flat arrays to a
    fixed T (default: the stored nonzeros); fewer than stored raises."""
    idx, val = _host(batch.indices), _host(batch.values)
    b, p = idx.shape
    keep = val != 0
    rows = np.broadcast_to(np.arange(b, dtype=np.int32)[:, None], (b, p))[keep]
    return _pack(idx[keep].astype(np.int32), val[keep].astype(np.float32), rows, b, total,
                 device)


def from_csr(row_ptr: np.ndarray, col_idx: np.ndarray, values: np.ndarray,
             total: Optional[int] = None, device: DeviceLike = None) -> FlatSparseBatch:
    """Host CSR (the loader's form, data/rcv1.py) as a flat batch."""
    nnz = np.diff(row_ptr).astype(np.int64)
    rows = np.repeat(np.arange(len(nnz), dtype=np.int32), nnz)
    return _pack(np.asarray(col_idx).astype(np.int32), np.asarray(values).astype(np.float32),
                 rows, len(nnz), total, device)
