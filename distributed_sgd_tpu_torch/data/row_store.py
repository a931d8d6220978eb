"""mmap-backed binary row store: a file-backed RowReader for the corpus.

The port's copy of the JAX package's data/row_store.py (numpy only), the
same bytes on disk: a store either package writes, the other reads.

- **built once** from a parsed ``Dataset`` (``build_row_store``) or from
  the corpus (``build_from_corpus`` runs ``load_rcv1`` first), every row a
  FIXED-STRIDE record ``idx int32[P] | val f32[P] | label`` (dense layout:
  ``val f32[D] | label``) — the padded representation the engines
  consume, so reading is reshaping, not parsing;
- **offsets sidecar** ``<store>.meta.json`` records the layout (row i
  lives at ``payload_offset + i * row_stride_bytes``), and an optional
  ``<store>.ds.npy`` sidecar the train split's dim-sparsity vector, so a
  worker builds its model without scanning the corpus;
- **read_rows = one contiguous slice of the mmap**: the OS pages in
  exactly the requested extent.  ``rows_read`` / ``bytes_read`` count
  what a spin-up or a reload touched.

A worker role with ``DSGD_ROW_STORE=<store>`` (and ``DSGD_HOST_INDEX=i``)
maps the store and loads ONLY its host slice through ``RowStore.reader``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np

from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.utils.fsio import atomic_write_json

MAGIC = "dsgd-row-store"
VERSION = 1


def meta_path(path: str) -> str:
    """The offsets-sidecar path for a store at `path` — the ONE place the
    naming convention lives (consumers check existence through this)."""
    return path + ".meta.json"


_meta_path = meta_path  # internal alias


def _ds_path(path: str) -> str:
    return path + ".ds.npy"


def _record_dtype(pad_width: int, n_features: int,
                  labels_dtype: str) -> np.dtype:
    """The fixed-stride per-row record.  pad_width == 0 is the dense-layout
    discriminator (data/rcv1.py): no index array, values span every
    feature."""
    lab = np.dtype(labels_dtype)
    if pad_width == 0:
        return np.dtype([("val", "<f4", (n_features,)), ("lab", lab)])
    return np.dtype([("idx", "<i4", (pad_width,)),
                     ("val", "<f4", (pad_width,)), ("lab", lab)])


def build_row_store(data: Dataset, path: str,
                    train_rows: Optional[int] = None,
                    dim_sparsity: Optional[np.ndarray] = None) -> dict:
    """Pack `data` into the store at `path` (+ its meta sidecar); returns
    the written metadata.  `train_rows` records the corpus's contiguous
    train-split cut (Main.scala:52's 0.8 * n) so host slices can be
    computed over the TRAIN rows without re-deriving the split; the
    optional `dim_sparsity` vector lands in the `.ds.npy` sidecar."""
    lab_dtype = np.dtype(data.labels.dtype)
    if lab_dtype not in (np.dtype(np.int32), np.dtype(np.float32)):
        raise ValueError(
            f"labels dtype {lab_dtype} not storable (int32/float32 only)")
    pad_width = 0 if data.is_dense else data.pad_width
    rec = _record_dtype(pad_width, data.n_features, lab_dtype.name)
    arr = np.zeros(len(data), dtype=rec)
    if pad_width:
        arr["idx"] = data.indices
    arr["val"] = data.values
    arr["lab"] = data.labels
    # pid-unique tmp names: concurrent builders (several CLI workers
    # finding the store missing on a shared volume at the same moment)
    # each write their own complete file and the atomic os.replace makes
    # last-writer-wins safe — the build is deterministic from the corpus,
    # so every winner installs identical bytes.  A FIXED tmp name would
    # let the second open() truncate the first writer's partial file and
    # keep writing through the inode the first os.replace installs.
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        arr.tofile(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    meta = {
        "magic": MAGIC,
        "version": VERSION,
        "n_rows": int(len(data)),
        "n_features": int(data.n_features),
        "pad_width": int(pad_width),
        "labels_dtype": lab_dtype.name,
        "row_stride_bytes": int(rec.itemsize),
        "payload_offset": 0,
        # row i's record: payload_offset + i * row_stride_bytes
        "train_rows": int(train_rows if train_rows is not None
                          else len(data)),
    }
    atomic_write_json(_meta_path(path), meta)
    if dim_sparsity is not None:
        # same atomic discipline as the payload/meta: a reader that saw
        # the meta sidecar land must never np.load a half-written vector
        ds_tmp = f"{_ds_path(path)}.tmp.{os.getpid()}.npy"
        np.save(ds_tmp, np.asarray(dim_sparsity, np.float32))
        os.replace(ds_tmp, _ds_path(path))
    return meta


def build_from_corpus(folder: str, path: str, full: bool = False,
                      pad_width: Optional[int] = None) -> dict:
    """Parse the corpus in `folder` (data/rcv1.py load_rcv1) and build the
    store from it, recording the 80/20 train cut and the train split's
    dim-sparsity vector.  This is the ONE parse the store's consumers
    amortize."""
    from distributed_sgd_tpu_torch.data.rcv1 import (
        dim_sparsity,
        load_rcv1,
        train_test_split,
    )

    data = load_rcv1(folder, full=full, pad_width=pad_width)
    train, _ = train_test_split(data)
    return build_row_store(data, path, train_rows=len(train),
                           dim_sparsity=dim_sparsity(train))


class RowStore:
    """Read side: an mmap over the packed records.

    ``read_rows(start, stop)`` returns a zero-copy ``Dataset`` view over
    the record slice — one seek + one contiguous read's worth of pages.
    The instance counts ``rows_read``/``bytes_read``/``calls`` so callers
    can assert exactly how much of the
    corpus a spin-up or reload touched."""

    def __init__(self, path: str):
        if not os.path.exists(_meta_path(path)):
            raise FileNotFoundError(
                f"row store sidecar missing: {_meta_path(path)} (build one "
                f"with data.row_store.build_from_corpus)")
        with open(_meta_path(path)) as f:
            meta = json.load(f)
        if meta.get("magic") != MAGIC or meta.get("version") != VERSION:
            raise ValueError(
                f"not a v{VERSION} {MAGIC} sidecar: {_meta_path(path)}")
        self.path = path
        self.meta = meta
        self.n_rows = int(meta["n_rows"])
        self.n_features = int(meta["n_features"])
        self.pad_width = int(meta["pad_width"])
        self.train_rows = int(meta["train_rows"])
        self.labels_dtype = np.dtype(meta["labels_dtype"])
        self._rec = _record_dtype(self.pad_width, self.n_features,
                                  meta["labels_dtype"])
        if int(meta["row_stride_bytes"]) != self._rec.itemsize:
            raise ValueError(
                f"row stride {meta['row_stride_bytes']} != record size "
                f"{self._rec.itemsize}: sidecar/payload layout mismatch")
        expect = meta["payload_offset"] + self.n_rows * self._rec.itemsize
        actual = os.path.getsize(path)
        if actual < expect:
            raise ValueError(
                f"row store truncated: {actual} bytes < {expect} expected")
        self._mm = np.memmap(path, dtype=self._rec, mode="r",
                             offset=int(meta["payload_offset"]),
                             shape=(self.n_rows,))
        self.rows_read = 0
        self.bytes_read = 0
        self.calls = 0

    def __len__(self) -> int:
        return self.n_rows

    def read_rows(self, start: int, stop: int) -> Dataset:
        """Rows [start, stop) as a Dataset view over the mmap (zero copy:
        consumers that keep the rows copy them into their own buffers,
        e.g. load_host_shard)."""
        if not 0 <= start <= stop <= self.n_rows:
            raise ValueError(
                f"row range [{start}, {stop}) outside [0, {self.n_rows}]")
        view = self._mm[start:stop]
        self.calls += 1
        self.rows_read += stop - start
        self.bytes_read += (stop - start) * self._rec.itemsize
        if self.pad_width == 0:
            idx = np.empty((stop - start, 0), dtype=np.int32)
        else:
            idx = view["idx"]
        return Dataset(indices=idx, values=view["val"], labels=view["lab"],
                       n_features=self.n_features)

    @property
    def reader(self):
        """This store as a data/host_shard.py ``RowReader``."""
        return self.read_rows

    def dim_sparsity(self) -> Optional[np.ndarray]:
        """The train split's dim-sparsity sidecar, or None if the store
        was built without one."""
        if not os.path.exists(_ds_path(self.path)):
            return None
        return np.load(_ds_path(self.path))
