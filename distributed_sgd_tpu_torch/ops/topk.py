"""Magnitude top-k selection (gradient compression support).

The port of the JAX package's ops/topk.py, whose selection is
``lax.top_k`` of |x| under ``jax.jit`` (an XLA program, not a Pallas
kernel).  Here it is torch on the card: the k largest-|x| coordinates,
the support sorted ascending so that the wire's coordinate list (and the
decode's scatter) walk memory forward.  Used by compress/ to pick the
sparsification support on the device the delta already lives on.

Ties break as ``lax.top_k`` breaks them: among equal magnitudes the lower
index is taken.  ``torch.topk`` gives no such promise (on the CPU or the
card), and a sparse delta has fewer nonzeros than k more often than not,
so the zeros tie at the boundary; a stable descending sort of |x| keeps
the lower index first among equals on both devices.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device


def resolve_k(k: float, dim: int) -> int:
    """Config's DSGD_COMPRESS_K: a fraction of dim when < 1 (the paper-style
    k/dim density), an absolute coordinate count when >= 1; clamped to
    [1, dim]."""
    if k <= 0:
        raise ValueError(f"top-k needs k > 0, got {k}")
    n = int(round(k * dim)) if k < 1.0 else int(k)
    return max(1, min(n, dim))


def select(x: torch.Tensor, k: int) -> torch.Tensor:
    """int64 indices of the k largest |x|, ascending, the lower index first
    among equal magnitudes, on x's device."""
    order = torch.sort(x.abs(), descending=True, stable=True).indices[:k]
    return torch.sort(order).values


def topk_magnitude(x, k: int, device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """(indices, values) of the k largest-|x| coordinates, indices ascending.

    Accepts a numpy array or a tensor, and selects on `device`: a tensor's
    own device when None, else the card (raises without one; pass
    ``device="cpu"`` for the CPU).  Returns host numpy (int32, float32)
    ready for the wire codec."""
    if device is None and isinstance(x, torch.Tensor):
        dev = x.device
    else:
        dev = resolve_device(device)
    xt = torch.as_tensor(x, dtype=torch.float32).to(dev)
    n = int(xt.shape[0])
    idx = select(xt, min(max(1, int(k)), n))
    return (idx.to(torch.int32).cpu().numpy(),
            xt.index_select(0, idx).cpu().numpy())
