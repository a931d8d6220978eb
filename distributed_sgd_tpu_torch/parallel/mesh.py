"""Device resolution, the worker reduce, and dataset padding.

The JAX package runs its workers over a 1-D ``jax.sharding.Mesh``; this
port runs on one CUDA card (world size 1), where each step's reduce over
workers is the identity.  `all_reduce_sum` is the one place a
``torch.distributed`` all_reduce goes once the port spans several cards.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch

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


def world_size() -> int:
    """Number of cards the workers span: one."""
    return 1


def rank() -> int:
    """This process's position among the cards: always 0 on one card."""
    return 0


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Sum over cards of a per-card partial (the JAX engines' ``psum``
    over the workers axis).  Identity at world size 1."""
    return t


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
