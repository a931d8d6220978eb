"""Weights and models carried across from the JAX package.

The JAX package keeps weights either flat ``[D]`` or in the TPU's
lane-blocked ``[R, 128]`` view (R = ceil(D/128) rounded up to a multiple
of 8, zero-padded).  The port keeps them flat ``f32[D]`` on the device.
These adapters work on numpy arrays, so neither package imports the other.
"""

from __future__ import annotations

import numpy as np
import torch

from distributed_sgd_tpu_torch.models.linear import LinearModel, make_model
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device

LANES = 128
SUBLANES = 8


def n_blocks(n_features: int) -> int:
    """Rows R of the blocked view: ceil(D/128), rounded up to a multiple of 8."""
    r = -(-int(n_features) // LANES)
    return -(-r // SUBLANES) * SUBLANES


def to_blocked(w: np.ndarray, n_features: int) -> np.ndarray:
    """[..., D] -> [..., R, 128], zero-padded."""
    w = np.asarray(w, dtype=np.float32)
    r = n_blocks(n_features)
    pad = [(0, 0)] * (w.ndim - 1) + [(0, r * LANES - n_features)]
    return np.pad(w, pad).reshape(w.shape[:-1] + (r, LANES))


def from_blocked(w2: np.ndarray, n_features: int) -> np.ndarray:
    """[..., R, 128] -> [..., D]."""
    w2 = np.asarray(w2, dtype=np.float32)
    return w2.reshape(w2.shape[:-2] + (-1,))[..., :n_features]


def weights_from_jax(w: np.ndarray, n_features: int, device: DeviceLike = None) -> torch.Tensor:
    """JAX weights, flat [D] or blocked [R, 128] -> the port's f32[D]."""
    w = np.asarray(w, dtype=np.float32)
    if w.shape == (n_features,):
        flat = w
    elif w.shape == (n_blocks(n_features), LANES):
        flat = from_blocked(w, n_features)
    else:
        raise ValueError(
            f"weights of shape {w.shape} are neither [{n_features}] nor "
            f"[{n_blocks(n_features)}, {LANES}]")
    return torch.tensor(flat, device=resolve_device(device))  # copies


def weights_to_jax(w: torch.Tensor, blocked: bool = False) -> np.ndarray:
    """The port's f32[D] -> numpy flat [D], or blocked [R, 128]."""
    flat = w.detach().float().cpu().numpy()
    return to_blocked(flat, flat.shape[0]) if blocked else flat


def model_from_jax(name: str, lam: float, n_features: int, dim_sparsity=None,
                   regularizer=None, device: DeviceLike = None) -> LinearModel:
    """The port's model with the JAX model's parameters (its `make_model`
    arguments, the dim-sparsity vector as numpy)."""
    ds = None if dim_sparsity is None else np.asarray(dim_sparsity, dtype=np.float32)
    return make_model(name, lam, n_features, dim_sparsity=ds,
                      regularizer=regularizer, device=device)
