"""Synthetic RCV1-shaped data for tests, the CLI and the chip smoke run.

`rcv1_like` generates a packed sparse classification set with RCV1-shaped
statistics (cosine-normalized rows, ~76 nnz per row over 47,236 features by
default) from a planted linear separator with label noise.  It draws the
same numpy stream as the JAX package's generator, so one seed gives
bit-identical arrays in both packages.
"""

from __future__ import annotations

import numpy as np

from distributed_sgd_tpu_torch.data.rcv1 import Dataset


def rcv1_like(
    n_samples: int,
    n_features: int = 47236,
    nnz: int = 76,
    noise: float = 0.05,
    seed: int = 0,
    idf_values: bool = False,
) -> Dataset:
    """Planted-separator sparse classification data, packed [N, P].

    `idf_values=True` weights each entry by its feature's inverse document
    frequency (log(N/df)) before the cosine normalization — the ltc
    (log-TF x IDF, cosine) scheme the real RCV1-v2 vectors use.
    """
    rng = np.random.default_rng(seed)
    # Zipf-ish feature popularity like term frequencies
    pop = 1.0 / np.arange(1, n_features + 1, dtype=np.float64)
    pop /= pop.sum()
    idx = rng.choice(n_features, size=(n_samples, nnz), p=pop).astype(np.int32)
    idx.sort(axis=1)
    val = np.abs(rng.normal(size=(n_samples, nnz))).astype(np.float32)
    # real RCV1 rows cannot hold duplicate feature ids: zero out repeat
    # draws, leaving inert pad slots
    dup = np.zeros_like(idx, dtype=bool)
    dup[:, 1:] = idx[:, 1:] == idx[:, :-1]
    if idf_values:
        # DOCUMENT frequency: each feature counts once per row
        df = np.bincount(idx[~dup], minlength=n_features)
        idf = np.log(n_samples / np.maximum(df, 1.0)).astype(np.float32)
        val *= idf[idx]
    val[dup] = 0.0
    val /= np.maximum(np.linalg.norm(val, axis=1, keepdims=True), 1e-12)  # cosine norm

    w_true = rng.normal(size=n_features).astype(np.float32)
    margins = np.einsum("np,np->n", val, w_true[idx])
    y = np.where(margins > np.median(margins), 1, -1).astype(np.int32)
    flip = rng.random(n_samples) < noise
    y[flip] = -y[flip]
    return Dataset(indices=idx, values=val, labels=y, n_features=n_features)
