"""The port's plain sparse ops (distributed_sgd_tpu_torch/ops/sparse.py)
against the JAX package's ops/sparse.py on the same numpy inputs, with
duplicate ids and pad slots.  rtol 1e-5 / atol 1e-6: f32 sums in another
order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.ops import sparse as jsparse
from distributed_sgd_tpu_torch.ops import sparse as tsparse

torch.set_num_threads(1)


def _batch(b, p, d, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (b, p)).astype(np.int32)
    val = rng.normal(size=(b, p)).astype(np.float32)
    if p > 2:
        idx[0, 1] = idx[0, 0]  # duplicate id within a row
        idx[:, -1], val[:, -1] = 0, 0.0  # pad slots
    return idx, val


@pytest.mark.parametrize("b,p,d", [(1, 1, 5), (9, 4, 50), (64, 33, 1000)])
def test_matvec_matches_jax(b, p, d):
    idx, val = _batch(b, p, d, seed=b)
    w = np.random.default_rng(0).normal(size=d).astype(np.float32)
    got = tsparse.matvec(tsparse.SparseBatch(torch.from_numpy(idx), torch.from_numpy(val)),
                         torch.from_numpy(w))
    want = jsparse.matvec(jsparse.SparseBatch(jnp.asarray(idx), jnp.asarray(val)), jnp.asarray(w))
    assert got.dtype == torch.float32 and got.shape == (b,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("b,p,d", [(1, 1, 5), (9, 4, 50), (64, 33, 1000)])
def test_scatter_add_matches_jax(b, p, d):
    idx, val = _batch(b, p, d, seed=b + 1)
    coeff = np.random.default_rng(1).normal(size=b).astype(np.float32)
    got = tsparse.scatter_add(tsparse.SparseBatch(torch.from_numpy(idx), torch.from_numpy(val)),
                              torch.from_numpy(coeff), d)
    want = jsparse.scatter_add(jsparse.SparseBatch(jnp.asarray(idx), jnp.asarray(val)),
                               jnp.asarray(coeff), d)
    assert got.shape == (d,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
