"""The port's linear models (distributed_sgd_tpu_torch/models/linear.py)
and weight adapters (convert.py) against the JAX package's models, on the
same numpy inputs.  Elementwise rules are held to rtol 1e-6 (the same f32
arithmetic); sums over a batch to rtol 1e-5 / atol 1e-6 (another f32
summation order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.ops import mxu
from distributed_sgd_tpu.ops.sparse import SparseBatch as JBatch
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch as TBatch

torch.set_num_threads(1)

D, B, P = 300, 16, 7
NAMES = ["hinge", "logistic", "least_squares"]


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, (B, P)).astype(np.int32)
    val = rng.normal(size=(B, P)).astype(np.float32)
    val[:, -1] = 0.0  # a pad slot in every row
    y = rng.choice([-1, 1], B).astype(np.int32)
    w = (rng.normal(size=D) * 0.3).astype(np.float32)
    ds = np.where(rng.random(D) < 0.7, 1.0 / rng.integers(2, 50, D), 0.0).astype(np.float32)
    return idx, val, y, w, ds


def _pair(name, ds, regularizer):
    jm = jax_make_model(name, 1e-3, D, dim_sparsity=jnp.asarray(ds), regularizer=regularizer)
    tm = convert.model_from_jax(name, 1e-3, D, ds, regularizer, device="cpu")
    return jm, tm


@pytest.mark.parametrize("name", NAMES)
def test_margins_predict_losses_and_coeff_match_jax(name):
    idx, val, y, w, ds = _inputs(1)
    jm, tm = _pair(name, ds, "dim_sparsity")
    jb, tb = JBatch(jnp.asarray(idx), jnp.asarray(val)), TBatch(torch.from_numpy(idx), torch.from_numpy(val))
    jw, tw = jnp.asarray(w), torch.from_numpy(w)

    m_j, m_t = np.array(jm.margins(jw, jb)), tm.margins(tw, tb)
    np.testing.assert_allclose(m_t.numpy(), m_j, rtol=1e-5, atol=1e-6)
    m = jnp.asarray(m_j)  # both sides take the same margins from here
    mt = torch.from_numpy(m_j)
    np.testing.assert_array_equal(tm.predict(mt).numpy(), np.asarray(jm.predict(m)))
    np.testing.assert_allclose(tm.losses_from_margins(mt, torch.from_numpy(y)).numpy(),
                               np.asarray(jm.losses_from_margins(m, jnp.asarray(y))), rtol=1e-6)
    np.testing.assert_allclose(tm.grad_coeff(mt, torch.from_numpy(y)).numpy(),
                               np.asarray(jm.grad_coeff(m, jnp.asarray(y))), rtol=1e-6)
    np.testing.assert_allclose(tm.grad_sum(tw, tb, torch.from_numpy(y)).numpy(),
                               np.asarray(jm.grad_sum(jw, jb, jnp.asarray(y))),
                               rtol=1e-5, atol=1e-6)


def test_hinge_predict_keeps_the_reference_sign_quirk():
    _, tm = _pair("hinge", np.ones(D, np.float32), "dim_sparsity")
    m = torch.tensor([2.0, -0.5, 0.0])
    np.testing.assert_array_equal(tm.predict(m).numpy(), [-1.0, 1.0, -0.0])


@pytest.mark.parametrize("regularizer", ["dim_sparsity", "l2", "none"])
def test_regularize_matches_jax_per_worker(regularizer):
    _, _, _, w, ds = _inputs(2)
    rng = np.random.default_rng(3)
    g = rng.normal(size=(3, D)).astype(np.float32)
    g[rng.random((3, D)) < 0.5] = 0.0  # the g != 0 mask matters
    g[1, :] = 0.0  # a worker with an all-zero sum stays zero
    jm, tm = _pair("hinge", ds, regularizer)
    got = tm.regularize(torch.from_numpy(g), torch.from_numpy(w)).numpy()
    for k in range(3):
        want = np.asarray(jm.regularize(jnp.asarray(g[k]), jnp.asarray(w)))
        np.testing.assert_allclose(got[k], want, rtol=1e-6, atol=1e-7)


def test_dim_sparsity_mask_adds_the_scalar_only_where_the_gradient_is_nonzero():
    w = np.full(D, 0.5, np.float32)
    ds = np.full(D, 0.01, np.float32)
    _, tm = _pair("hinge", ds, "dim_sparsity")
    g = np.zeros((2, D), np.float32)
    g[0, 5], g[1, 9] = 1.0, -0.0  # -0.0 compares equal to 0: no mask
    got = tm.regularize(torch.from_numpy(g), torch.from_numpy(w)).numpy()
    scalar = 1e-3 * 2.0 * float(np.dot(w, ds))
    want = g.copy()
    want[0, 5] += scalar
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert np.count_nonzero(got) == 1


def test_make_model_rejects_unknown_names_and_a_missing_dim_sparsity():
    with pytest.raises(ValueError, match="unknown model"):
        convert.model_from_jax("perceptron", 1e-3, D, device="cpu")
    with pytest.raises(ValueError, match="dim_sparsity"):
        convert.model_from_jax("hinge", 1e-3, D, None, "dim_sparsity", device="cpu")


@pytest.mark.parametrize("n_features", [300, 47236])
def test_weights_cross_between_flat_and_blocked_layouts(n_features):
    w = np.random.default_rng(4).normal(size=n_features).astype(np.float32)
    w2 = np.asarray(mxu.to_blocked(jnp.asarray(w), n_features))
    assert convert.n_blocks(n_features) == mxu.n_blocks(n_features)
    np.testing.assert_array_equal(convert.to_blocked(w, n_features), w2)
    for src in (w, w2):
        t = convert.weights_from_jax(src, n_features, device="cpu")
        assert t.dtype == torch.float32 and t.shape == (n_features,)
        np.testing.assert_array_equal(t.numpy(), w)
    np.testing.assert_array_equal(convert.weights_to_jax(torch.from_numpy(w)), w)
    np.testing.assert_array_equal(convert.weights_to_jax(torch.from_numpy(w), blocked=True), w2)
    with pytest.raises(ValueError, match="neither"):
        convert.weights_from_jax(w[:-1], n_features, device="cpu")
