"""Host-local shard loading: no host materializes the global corpus.

The port's copy of the JAX package's data/host_shard.py (numpy only).  A
host hands in a ``RowReader`` — any callable ``read_rows(start, stop) ->
Dataset`` over GLOBAL row ids — and gets back exactly its extent, with the
real rows read in ONE clipped call and every padding row (index >=
n_samples) materialized as an all-zero row with label 0.

The RPC topology's worker (core/worker.py) is the consumer: ``host_slice``
maps a worker's position in the master's contiguous split to the rows it
must load, ``WorkerNode(data_offset=...)`` maps the master's global sample
ids back into the slice, and ``reload_slice`` re-shards it after an
elastic resplit, reading only the uncovered delta.
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np

from distributed_sgd_tpu_torch.data.rcv1 import Dataset

# read_rows(start, stop) -> Dataset holding global rows [start, stop);
# start/stop are pre-clipped to [0, n_samples]
RowReader = Callable[[int, int], Dataset]


def dataset_reader(data: Dataset) -> RowReader:
    """A RowReader over an in-memory dataset (tests, in-process dev
    clusters — the memory win is a no-op there by construction)."""
    return lambda start, stop: data.slice(slice(start, stop))


def _read_into(reader: RowReader, r0: int, r1: int, idx, val, lab,
               dst: slice, pad_width: int, n_features: int) -> None:
    """ONE validated reader call copied into the output buffers at `dst`:
    the single place reader results are checked — row count, packed
    shape, and a lossless labels cast — shared by the initial loader and
    the incremental reload path."""
    part = reader(r0, r1)
    if len(part) != r1 - r0:
        raise ValueError(
            f"reader returned {len(part)} rows for [{r0}, {r1})")
    if (part.indices.shape[1] != pad_width
            or part.n_features != n_features):
        raise ValueError(
            f"reader shape ({part.indices.shape[1]}, "
            f"{part.n_features}) != expected "
            f"({pad_width}, {n_features})")
    if not np.can_cast(part.labels.dtype, lab.dtype, casting="same_kind"):
        # float regression targets into an int buffer would truncate
        # silently — the caller must pass the corpus's labels_dtype
        # (every host the same: the global array needs one dtype)
        raise ValueError(
            f"reader labels are {part.labels.dtype} but the shard "
            f"buffer is {lab.dtype}: pass labels_dtype="
            f"{part.labels.dtype}")
    idx[dst] = part.indices
    val[dst] = part.values
    lab[dst] = part.labels


def load_host_shard(
    reader: RowReader,
    n_samples: int,
    n_features: int,
    pad_width: int,
    start: int,
    end: int,
    labels_dtype=np.int32,
) -> Dataset:
    """Materialize padded rows [start, end) of the engine's padded row
    space: real rows come from ONE ``reader`` call clipped to the corpus,
    padding rows are all-zero with label 0 (a zero row contributes zero
    gradient in every model and the label-0 mask excludes it from eval).

    The returned dataset holds exactly ``end - start`` rows — the host's
    full resident footprint.  Nothing outside [start, min(end, n)) is
    ever requested from the reader.
    """
    if not 0 <= start <= end:
        raise ValueError(f"bad shard bounds [{start}, {end})")
    extent = end - start
    real_start = min(start, n_samples)
    real_stop = min(end, n_samples)
    # pad_width == 0 is the dense-layout discriminator (data/rcv1.py):
    # zero-width indices, values spanning every feature
    val_width = n_features if pad_width == 0 else pad_width
    idx = np.zeros((extent, pad_width), dtype=np.int32)
    val = np.zeros((extent, val_width), dtype=np.float32)
    lab = np.zeros((extent,), dtype=labels_dtype)
    if real_stop > real_start:
        _read_into(reader, real_start, real_stop, idx, val, lab,
                   slice(0, real_stop - real_start), pad_width, n_features)
    return Dataset(indices=idx, values=val, labels=lab,
                   n_features=n_features)


def host_slice(n_samples: int, host_index: int, n_hosts: int,
               weights: Optional[List[int]] = None) -> Tuple[int, int]:
    """[start, end) of host `host_index`'s rows under the master's
    host-granular contiguous split (docs/HIERARCHY.md).

    Mirrors core/split.py exactly: the unweighted form is vanilla_split's
    ``grouped(ceil(n/k))`` bounds; with per-host device `weights` it is
    weighted_split's largest-remainder layout.  A worker that loads only
    this range (``load_host_shard`` + ``WorkerNode(data_offset=start)``)
    serves every sample id the master can ever draw for it — as long as
    membership matches the planned topology (a resplit after a host loss
    redraws partitions the survivors' slices cannot cover; host-local
    deployments pair with on_worker_death='fail' or full reloads).
    """
    if not 0 <= host_index < n_hosts:
        raise ValueError(f"host_index {host_index} outside [0, {n_hosts})")
    # derive bounds from the ACTUAL split functions the master runs —
    # re-implementing their arithmetic here would let the worker's
    # resident slice drift from the master's partitions the moment either
    # changes, and every mismatched sample id is a worker eviction
    from distributed_sgd_tpu_torch.core.split import vanilla_split, weighted_split

    parts = (vanilla_split(n_samples, n_hosts) if weights is None
             else weighted_split(n_samples, weights))
    part = parts[host_index]
    if len(part) == 0:
        at = sum(len(p) for p in parts[:host_index])
        return at, at
    return int(part[0]), int(part[-1]) + 1


def overprovision_margin(span: int, overprovision: float) -> int:
    """Rows of neighbor range loaded beyond each end of a nominal span of
    `span` rows: ceil(f * span), 0 when the knob is off."""
    if overprovision <= 0 or span <= 0:
        return 0
    return int(math.ceil(float(overprovision) * span))


def overprovisioned_slice(
    n_samples: int, host_index: int, n_hosts: int,
    overprovision: float = 0.0,
    weights: Optional[List[int]] = None,
) -> Tuple[int, int, int, int]:
    """(load_start, load_end, start, end): the host's nominal ``host_slice``
    bounds [start, end) widened by ``ceil(f * span)`` rows of NEIGHBOR
    range on each side, clipped to the corpus (DSGD_HOST_OVERPROVISION,
    docs/HIERARCHY.md "Elastic composition").

    The over-provisioned rows are the elastic slack: a membership change
    of up to ``f * n / n_hosts`` rows per boundary (one host joining or
    leaving an H-host split moves each boundary by at most n/H — so
    f >= 1/(H-1) covers a single leave, f >= 1/(H+1) a single join)
    re-splits WITHIN the already-resident range and costs the worker zero
    reload; a bigger shift re-loads only the uncovered delta through the
    worker's RowReader (``reload_slice``)."""
    start, end = host_slice(n_samples, host_index, n_hosts, weights=weights)
    margin = overprovision_margin(end - start, overprovision)
    return (max(0, start - margin), min(n_samples, end + margin),
            start, end)


def reload_slice(
    current: Dataset,
    current_start: int,
    reader: RowReader,
    n_samples: int,
    n_features: int,
    pad_width: int,
    new_start: int,
    new_end: int,
    labels_dtype=None,
) -> Tuple[Dataset, int]:
    """Incremental re-shard: materialize rows [new_start, new_end) reusing
    every overlapping row of `current` (resident rows
    [current_start, current_start + len(current))) and reading ONLY the
    uncovered delta ranges through `reader` — at most two clipped calls
    (left gap, right gap), O(delta) rows total.

    Returns (new resident dataset, rows_read).  Rows at index >=
    n_samples are padding (all-zero, label 0), exactly like
    ``load_host_shard``.
    """
    if not 0 <= new_start <= new_end:
        raise ValueError(f"bad shard bounds [{new_start}, {new_end})")
    if labels_dtype is None:
        labels_dtype = current.labels.dtype
    extent = new_end - new_start
    val_width = n_features if pad_width == 0 else pad_width
    idx = np.zeros((extent, pad_width), dtype=np.int32)
    val = np.zeros((extent, val_width), dtype=np.float32)
    lab = np.zeros((extent,), dtype=labels_dtype)
    cur_end = current_start + len(current)
    # overlap with the resident slice: a pure host-memory copy
    lo = max(new_start, current_start)
    hi = min(new_end, cur_end)
    if lo < hi:
        src = slice(lo - current_start, hi - current_start)
        dst = slice(lo - new_start, hi - new_start)
        if pad_width:
            idx[dst] = current.indices[src]
        val[dst] = current.values[src]
        lab[dst] = current.labels[src]
    rows_read = 0
    # uncovered deltas, clipped to the real corpus (everything past
    # n_samples is padding and costs nothing)
    gaps = []
    if lo >= hi:  # disjoint: the whole new range is one gap
        gaps.append((new_start, new_end))
    else:
        if new_start < lo:
            gaps.append((new_start, lo))
        if hi < new_end:
            gaps.append((hi, new_end))
    for g0, g1 in gaps:
        r0, r1 = min(g0, n_samples), min(g1, n_samples)
        if r0 >= r1:
            continue
        _read_into(reader, r0, r1, idx, val, lab,
                   slice(r0 - new_start, r1 - new_start), pad_width,
                   n_features)
        rows_read += r1 - r0
    return (Dataset(indices=idx, values=val, labels=lab,
                    n_features=n_features), rows_read)
