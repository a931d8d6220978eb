"""Device resolution, the process group's reduces, and dataset padding.

The JAX package runs its workers over a ``jax.sharding.Mesh`` and reduces
over it with ``psum``/``pmax``.  The port runs one rank a process (one
card each, or the CPU), joined by ``torch.distributed``
(parallel/multihost.py ``initialize``): `world_size` and `rank` read the
process group, and `all_reduce_sum`/`all_reduce_max` are its all_reduces.
With no process group initialised the world is this one process, and
both reduces return their input.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from distributed_sgd_tpu_torch.data.rcv1 import Dataset

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    CUDA card.  With no device given and no CUDA present this raises: the
    port never drops to the CPU unasked (pass ``device="cpu"`` for that)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain torch path on the CPU")
    return torch.device("cuda")


def distributed() -> bool:
    """True when a process group is initialised in this process."""
    return dist.is_available() and dist.is_initialized()


def world_size(group=None) -> int:
    """Ranks in `group` (the default process group when None); 1 when no
    process group is initialised."""
    return dist.get_world_size(group) if distributed() else 1


def rank(group=None) -> int:
    """This process's rank in `group` (the default process group when
    None); 0 when no process group is initialised."""
    return dist.get_rank(group) if distributed() else 0


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum over the ranks of `group` of each rank's `t` (the JAX engines'
    ``psum``), as a new tensor: every rank gets the same bits.  `t` itself
    is left as it was.  With no process group, `t`."""
    if not distributed():
        return t
    out = t.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def all_reduce_max(n: int, group=None) -> int:
    """Maximum over the ranks of `group` of each rank's integer `n` (the
    JAX engines' ``pmax``), reduced as an int64 scalar on the CPU (gloo)
    or on this rank's card (NCCL).  With no process group, `n`."""
    if not distributed():
        return n
    dev = torch.device("cuda", torch.cuda.current_device()) if (
        dist.get_backend(group) == "nccl") else torch.device("cpu")
    t = torch.tensor(int(n), dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def all_gather_cat(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equally shaped `t`, concatenated along dim 0 in rank
    order (every rank gets all of it), on `t`'s device.  Gloo gathers no
    CUDA tensor, so a card's tensor goes through the host there.  With no
    process group, `t`."""
    if not distributed():
        return t
    src = t.cpu() if t.is_cuda and dist.get_backend(group) == "gloo" else t
    parts = [torch.empty_like(src) for _ in range(world_size(group))]
    dist.all_gather(parts, src.contiguous(), group=group)
    return torch.cat(parts).to(t.device)


def barrier(group=None) -> None:
    """Wait for every rank of `group`; nothing without a process group."""
    if distributed():
        dist.barrier(group=group)


def local_device_groups(devices: Sequence[DeviceLike], n_workers: int,
                        host_devices: int) -> List[List[torch.device]]:
    """Contiguous device groups for hierarchical in-process clusters, as
    the JAX package's: worker i gets devices [i*D, (i+1)*D), each group
    backing one WorkerNode's in-host engine (parallel/hier.py).  The list
    may name one device more than once.  Raises when the devices cannot
    host the topology."""
    devices = [torch.device(d) for d in devices]
    need = n_workers * host_devices
    if len(devices) < need:
        raise ValueError(
            f"{n_workers} workers x {host_devices} devices need {need} "
            f"devices, found {len(devices)}")
    return [devices[i * host_devices:(i + 1) * host_devices] for i in range(n_workers)]


def pad_rows(data: Dataset, rem: int) -> Dataset:
    """Append `rem` inert rows (all-zero features, label 0).

    Label 0 doubles as the validity mask: real labels are +/-1 (or nonzero
    float targets), so evaluation masks on `labels != 0`.
    """
    if rem == 0:
        return data
    return Dataset(
        indices=np.concatenate(
            [data.indices, np.zeros((rem, data.indices.shape[1]), dtype=data.indices.dtype)]),
        values=np.concatenate(
            [data.values, np.zeros((rem, data.values.shape[1]), dtype=data.values.dtype)]),
        labels=np.concatenate([data.labels, np.zeros((rem,), dtype=data.labels.dtype)]),
        n_features=data.n_features,
    )


def pad_to_multiple(data: Dataset, k: int) -> Dataset:
    """Pad with inert rows so len % k == 0."""
    return pad_rows(data, (-len(data)) % k)
