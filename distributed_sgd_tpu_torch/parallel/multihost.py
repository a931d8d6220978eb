"""Ranks across processes: the port's counterpart of the JAX package's
parallel/multihost.py.

The JAX package spans hosts with ``jax.distributed`` and one global mesh;
the port runs one rank a process, joined by ``torch.distributed``.  Every
process calls `initialize` with the same rendezvous address (under
``torchrun`` its environment supplies all of it); the engines of
parallel/sync.py and parallel/local_sgd.py then read the process group
through parallel/mesh.py, each rank one worker of the JAX mesh's
``workers`` axis, and reduce with its all_reduces.  NCCL serves ranks on
CUDA cards (one rank a card: NCCL refuses two ranks on one device), gloo
ranks on the CPU, or several ranks that share one card.

Host-local loading: `host_shard_bounds` gives this rank's contiguous row
range in the sync engine's padded row space (parallel/sync.py
``padded_layout``), so a loader reads only its slice of the corpus; rows
with index >= n_samples are padding, zero rows with label 0.
`host_local_sharded` loads that range through a row reader
(data/host_shard.py), and ``SyncEngine.bind_host_local`` binds it.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, rank, resolve_device, world_size

log = logging.getLogger("dsgd.multihost")


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device: DeviceLike = None,
) -> torch.device:
    """``dist.init_process_group`` over ``tcp://coordinator_address``
    ("host:port").  Each argument left None falls back to torchrun's
    environment: MASTER_ADDR:MASTER_PORT, WORLD_SIZE and RANK.  `device`
    is this rank's device (the card unless given; a CUDA device becomes
    the process's current one); `backend` None picks NCCL for a CUDA
    device and gloo on the CPU.  Returns the rank's device."""
    device = resolve_device(device)
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
                               f"{os.environ['MASTER_PORT']}")
    if num_processes is None:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        if device.index is None:  # the card: the current one, by its index
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    log.info("distributed initialized: process %d/%d, %d local / %d global devices "
             "(backend %s, device %s)", rank(), world_size(), 1, world_size(), backend,
             device)
    return device


def host_shard_bounds(
    n_samples: int,
    process_id: Optional[int] = None,
    num_processes: Optional[int] = None,
    eval_chunk: int = 4096,
) -> Tuple[int, int]:
    """This rank's contiguous [start, end) row range in the sync engine's
    PADDED row space: the dataset is padded to ``padded_layout(n,
    num_processes, eval_chunk)`` rows and split equally over the ranks, one
    device a process, as the JAX package's bounds at one local device.
    `process_id`/`num_processes` default to the process group's rank and
    world size.  Rows with index >= n_samples are padding."""
    from distributed_sgd_tpu_torch.parallel.sync import padded_layout

    pid = rank() if process_id is None else process_id
    n_proc = world_size() if num_processes is None else num_processes
    total, _ = padded_layout(n_samples, n_proc, eval_chunk)
    per_rank = total // n_proc
    return pid * per_rank, (pid + 1) * per_rank


def host_local_sharded(reader, n_samples: int, n_features: int, pad_width: int,
                       eval_chunk: int = 4096, labels_dtype=None, device: DeviceLike = None,
                       group=None):
    """(ShardedData, chunk) of ONLY this rank's rows of `group` (the
    default process group when None): `load_host_shard` reads the real
    rows of ``host_shard_bounds`` through one clipped `reader` call and
    makes the padding rows zeros, and they go to `device`.  No process
    holds the corpus.  ``pad_width=0`` is the dense layout."""
    from distributed_sgd_tpu_torch.data.host_shard import load_host_shard
    from distributed_sgd_tpu_torch.parallel.sync import ShardedData, padded_layout

    device = resolve_device(device)
    n_proc, pid = world_size(group), rank(group)
    _, chunk = padded_layout(n_samples, n_proc, eval_chunk)
    start, end = host_shard_bounds(n_samples, pid, n_proc, eval_chunk=eval_chunk)
    local = load_host_shard(
        reader, n_samples, n_features, pad_width, start, end,
        labels_dtype=labels_dtype if labels_dtype is not None else np.int32)
    labels_t = torch.int32 if np.issubdtype(local.labels.dtype, np.integer) else torch.float32

    def put(arr, dtype):
        return torch.as_tensor(np.ascontiguousarray(arr), dtype=dtype).to(device)

    sharded = ShardedData(indices=put(local.indices, torch.int32),
                          values=put(local.values, torch.float32),
                          labels=put(local.labels, labels_t), n_true=n_samples)
    return sharded, chunk
