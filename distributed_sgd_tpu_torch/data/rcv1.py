"""RCV1 dataset loading, packing, and statistics (host-side numpy).

The port's own copy of the JAX package's loader (distributed_sgd_tpu/
data/rcv1.py), kept byte-for-byte in its arithmetic so both packages hand
their engines identical arrays:

- text parsing goes through the native chunked parser
  (data/_native/parser.cpp, built with g++ at first use); where it cannot
  be built (no g++) the loader warns once and parses line by line in
  python (``parse_svm_file_py``), with the same arrays for well-formed
  files.  ``_native.native_loaded()`` says which route runs;
- rows land in flat CSR, then are packed once into fixed-shape
  ``int32[N, P]`` / ``f32[N, P]`` padded arrays, by the native row loop or
  the numpy scatter under the same rule; P defaults to the dataset's max
  nnz (lossless), or can be capped (rows are then truncated by largest
  |value|, ties to the earlier position);
- feature ids are converted to 0-based at parse time;
- label binarization reproduces the reference exactly, including the
  last-topic-wins quirk: the qrels map keeps only the LAST line per doc id,
  so a doc in CCAT *and* any later-sorted topic binarizes to -1;
- the 80/20 split is contiguous (first 80% train).
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from distributed_sgd_tpu_torch.data import _native

log = logging.getLogger("dsgd.data")

N_FEATURES = 47236


@dataclass
class Dataset:
    """A packed sparse dataset: fixed-shape host arrays ready for device."""

    indices: np.ndarray  # int32[N, P], 0-based feature ids, 0-padded
    values: np.ndarray  # f32[N, P], 0.0-padded
    labels: np.ndarray  # int32[N], +/-1 (or float for regression)
    n_features: int

    def __post_init__(self):
        # a zero-width index array IS the dense-layout discriminator
        if self.indices.shape[1] == 0 and self.values.shape[1] != self.n_features:
            raise ValueError(
                "zero-width indices mean dense layout: values must span all "
                f"{self.n_features} features, got width {self.values.shape[1]}"
            )

    def __len__(self) -> int:
        return self.values.shape[0]

    @property
    def pad_width(self) -> int:
        return self.values.shape[1]

    @property
    def is_dense(self) -> bool:
        """Dense layout: no index array (zero-width), values hold every
        feature.  The engines route these rows to the models' matmul path,
        and no int32 index array is ever made for them."""
        return self.indices.shape[1] == 0 and self.values.shape[1] == self.n_features

    @classmethod
    def dense(cls, values: np.ndarray, labels: np.ndarray) -> "Dataset":
        """A dense-layout dataset from values[N, D] and labels[N]."""
        values = np.ascontiguousarray(values, dtype=np.float32)
        return cls(
            indices=np.empty((values.shape[0], 0), dtype=np.int32),
            values=values,
            labels=np.asarray(labels),
            n_features=values.shape[1],
        )

    def slice(self, sel) -> "Dataset":
        return Dataset(self.indices[sel], self.values[sel], self.labels[sel], self.n_features)


def parse_svm_file_py(path: str, index_offset: int = -1):
    """Line parser -> (doc_ids, row_ptr, col_idx, values): the fallback of
    ``parse_svm_file`` and its oracle.

    First token is the doc id, remaining `f:v` tokens are features; tokens
    are split on arbitrary whitespace.  A non-numeric doc id raises (the
    native scan skips such a line and counts it).
    """
    doc_ids: List[int] = []
    row_nnz: List[int] = []
    cols: List[int] = []
    vals: List[float] = []
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            doc_ids.append(int(parts[0]))
            n = 0
            for tok in parts[1:]:
                if ":" not in tok:
                    continue
                k, v = tok.split(":", 1)
                cols.append(int(k) + index_offset)
                vals.append(float(v))
                n += 1
            row_nnz.append(n)
    row_ptr = np.zeros(len(doc_ids) + 1, dtype=np.int64)
    np.cumsum(row_nnz, out=row_ptr[1:])
    return (
        np.asarray(doc_ids, dtype=np.int32),
        row_ptr,
        np.asarray(cols, dtype=np.int32),
        np.asarray(vals, dtype=np.float32),
    )


def parse_svm_file(path: str, index_offset: int = -1, n_threads: int = 0):
    """The native parser (`n_threads` 0: the host's hardware threads), or
    the python parser where the library cannot be had."""
    out = _native.parse_svm_file(path, n_threads=n_threads, index_offset=index_offset)
    if out is None:
        out = parse_svm_file_py(path, index_offset=index_offset)
    return out


def read_labels(path: str) -> Dict[int, int]:
    """qrels 'topic docid 1' -> {docid: +/-1}, CCAT -> +1, last line wins."""
    labels: Dict[int, int] = {}
    with open(path, "r") as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            labels[int(parts[1])] = 1 if parts[0] == "CCAT" else -1
    return labels


def pack_csr(
    row_ptr: np.ndarray,
    col_idx: np.ndarray,
    values: np.ndarray,
    pad_width: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """CSR -> padded [N, P] arrays.

    P defaults to max row nnz (lossless).  If a smaller P is forced, the
    affected rows keep their P largest-|value| features (NaN last, ties:
    earliest wins), in index order.  The native row loop
    (parser.cpp ``dsgd_pack_csr``) packs where the library loads, else the
    numpy scatter (``pack_csr_numpy``), with the same output.
    """
    nnz = np.diff(row_ptr).astype(np.int64)
    n = len(nnz)
    max_nnz = int(nnz.max()) if n else 0
    # width >= 1 always: a zero-width index array is the dense-layout
    # discriminator (Dataset.is_dense)
    p = int(pad_width) if pad_width else max(max_nnz, 1)
    native = _native.pack_csr(row_ptr, col_idx, values, p)
    if native is not None:
        out_idx, out_val, truncated = native
    else:
        out_idx, out_val, truncated = pack_csr_numpy(row_ptr, col_idx, values, p)
    if truncated:
        log.warning("pad_width=%d truncated %d/%d rows (max nnz %d)", p, truncated, n, max_nnz)
    return out_idx, out_val


def pack_csr_numpy(row_ptr: np.ndarray, col_idx: np.ndarray, values: np.ndarray,
                   p: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """The numpy route of ``pack_csr`` at width `p`: (indices, values,
    rows truncated)."""
    nnz = np.diff(row_ptr).astype(np.int64)
    n = len(nnz)
    max_nnz = int(nnz.max()) if n else 0
    out_idx = np.zeros((n, p), dtype=np.int32)
    out_val = np.zeros((n, p), dtype=np.float32)
    pos_in_row = np.arange(len(col_idx), dtype=np.int64) - np.repeat(row_ptr[:-1], nnz)
    row_of = np.repeat(np.arange(n, dtype=np.int64), nnz)
    if max_nnz <= p:
        out_idx[row_of, pos_in_row] = col_idx
        out_val[row_of, pos_in_row] = values
        return out_idx, out_val, 0
    over = np.nonzero(nnz > p)[0]
    keep = pos_in_row < p
    over_mask = np.isin(row_of, over)
    fast = keep & ~over_mask
    out_idx[row_of[fast], pos_in_row[fast]] = col_idx[fast]
    out_val[row_of[fast], pos_in_row[fast]] = values[fast]
    for r in over:  # rare rows: keep heaviest features, index-sorted
        s, e = row_ptr[r], row_ptr[r + 1]
        ci, cv = col_idx[s:e], values[s:e]
        sel = np.argsort(-np.abs(cv), kind="stable")[:p]  # ties: earliest wins
        sel.sort()
        out_idx[r, :p] = ci[sel]
        out_val[r, :p] = cv[sel]
    return out_idx, out_val, len(over)


def merge_parts(parts) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Concatenate per-file (doc_ids, row_ptr, col_idx, values) CSR parts
    into one CSR with a rebuilt global row_ptr."""
    doc_ids = np.concatenate([p[0] for p in parts])
    col_idx = np.concatenate([p[2] for p in parts])
    values = np.concatenate([p[3] for p in parts])
    row_ptr = np.zeros(len(doc_ids) + 1, dtype=np.int64)
    np.cumsum(np.concatenate([np.diff(p[1]) for p in parts]), out=row_ptr[1:])
    return doc_ids, row_ptr, col_idx, values


def dim_sparsity(train: Dataset) -> np.ndarray:
    """Inverse-document-frequency vector: 1/(count_i + 1) where feature i
    appears in the train split, else 0."""
    if train.is_dense:
        counts = (train.values != 0).sum(axis=0)
    else:
        idx = train.indices[train.values != 0]
        counts = np.bincount(idx.ravel(), minlength=train.n_features)
    out = np.zeros(train.n_features, dtype=np.float32)
    nz = counts > 0
    out[nz] = 1.0 / (counts[nz] + 1.0)
    return out


def train_test_split(data: Dataset) -> Tuple[Dataset, Dataset]:
    """Contiguous 80/20 split."""
    cut = int(len(data) * 0.8)
    return data.slice(slice(0, cut)), data.slice(slice(cut, None))


def load_rcv1(
    folder: str,
    full: bool = False,
    n_features: int = N_FEATURES,
    pad_width: Optional[int] = None,
    n_threads: int = 0,
) -> Dataset:
    """Load RCV1 from `folder`: the train vectors file, plus the four test
    parts when `full`, labelled from the topics qrels file."""
    files = [os.path.join(folder, "lyrl2004_vectors_train.dat")]
    if full:
        files += [os.path.join(folder, f"lyrl2004_vectors_test_pt{d}.dat") for d in range(4)]
    labels_map = read_labels(os.path.join(folder, "rcv1-v2.topics.qrels"))

    # With auto threading (n_threads=0) and several files, one parse a file
    # on the shared pool (the native parser releases the GIL inside the
    # ctypes call, so the files parse at once), the cores split between
    # them.  An explicit n_threads is a budget a parse: the files go one
    # after the other.
    cores = os.cpu_count() or 1
    if n_threads == 0 and len(files) > 1 and cores >= 2 * len(files):
        from distributed_sgd_tpu_torch.utils.pool import global_pool

        per_file = cores // len(files)
        parts = global_pool().map(lambda f: parse_svm_file(f, n_threads=per_file), files)
    else:
        parts = [parse_svm_file(f, n_threads=n_threads) for f in files]
    doc_ids, row_ptr, col_idx, values = merge_parts(parts)

    idx, val = pack_csr(row_ptr, col_idx, values, pad_width=pad_width)
    y = np.asarray([labels_map[int(d)] for d in doc_ids], dtype=np.int32)
    return Dataset(indices=idx, values=val, labels=y, n_features=n_features)
