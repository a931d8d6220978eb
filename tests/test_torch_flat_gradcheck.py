"""The port's ops/gradcheck.py (the reference's F utility) and
ops/flat_sparse.py (its SparseArrayVector) against the JAX package's, on
the CPU: the 8 cases of tests/test_gradcheck_and_flat.py, each on the same
numpy inputs through both packages.

Tolerances: the numeric gradients of both packages within 1e-4 of each
other (f32 central differences of the same function, eps 1e-2), the flat
ops within 1e-5 of JAX's and of the padded ops (f32 sums in another
order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.models.linear import LeastSquares as JLeastSquares
from distributed_sgd_tpu.models.linear import LogisticRegression as JLogistic
from distributed_sgd_tpu.ops import flat_sparse as jflat
from distributed_sgd_tpu.ops.gradcheck import check_grad as jcheck_grad
from distributed_sgd_tpu.ops.gradcheck import numeric_grad as jnumeric_grad
from distributed_sgd_tpu.ops.sparse import SparseBatch as JBatch
from distributed_sgd_tpu_torch.models.linear import LeastSquares, LogisticRegression
from distributed_sgd_tpu_torch.ops import flat_sparse
from distributed_sgd_tpu_torch.ops.gradcheck import check_grad, numeric_grad
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch, matvec, scatter_add

torch.set_num_threads(1)

NUM_ATOL = 1e-4  # the two packages' numeric gradients of one function
FLAT_ATOL = 1e-5  # flat ops against JAX's and the padded ops


def _rand(b=6, p=5, d=40, seed=0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (b, p)).astype(np.int32)
    val = rng.normal(size=(b, p)).astype(np.float32)
    val[rng.random((b, p)) < 0.2] = 0.0  # some explicit pads
    y = rng.choice([-1, 1], b).astype(np.int32)
    return idx, val, y, d


def _batch(idx, val):
    return SparseBatch(torch.from_numpy(idx), torch.from_numpy(val))


class TestNumericGrad:
    def test_quadratic(self):
        x = np.random.default_rng(0).normal(size=8).astype(np.float32)
        g = numeric_grad(lambda v: torch.sum(v ** 2), torch.from_numpy(x), eps=1e-2)
        want = jnumeric_grad(lambda v: jnp.sum(v ** 2), jnp.asarray(x), eps=1e-2)
        assert np.allclose(g.numpy(), 2 * x, atol=1e-2)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=NUM_ATOL)

    def test_coords_subset(self):
        x = np.arange(5, dtype=np.float32)
        g = numeric_grad(lambda v: torch.sum(v ** 2), torch.from_numpy(x), eps=1e-2,
                         coords=[1, 3])
        want = jnumeric_grad(lambda v: jnp.sum(v ** 2), jnp.asarray(x), eps=1e-2,
                             coords=jnp.asarray([1, 3]))
        assert g.shape == (2,)
        assert np.allclose(g.numpy(), [2.0, 6.0], atol=1e-2)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=NUM_ATOL)

    @pytest.mark.parametrize("cls,jcls", [(LogisticRegression, JLogistic),
                                          (LeastSquares, JLeastSquares)])
    def test_model_grads_match_numeric(self, cls, jcls):
        # smooth models: analytic grad_mean == d objective/dw with lam=0
        idx, val, y, d = _rand(seed=3)
        model = cls(lam=0.0, n_features=d, regularizer="none", device="cpu")
        jmodel = jcls(lam=0.0, n_features=d, regularizer="none")
        w = (np.random.default_rng(1).normal(size=d) * 0.1).astype(np.float32)
        probe = np.unique(idx)[:12]
        batch, yt = _batch(idx, val), torch.from_numpy(y)
        jbatch, jy = JBatch(jnp.asarray(idx), jnp.asarray(val)), jnp.asarray(y)
        kw = dict(eps=1e-2, atol=5e-3, rtol=5e-2)
        assert check_grad(lambda v: model.objective(v, batch, yt),
                          lambda v: model.grad_mean(v, batch, yt), torch.from_numpy(w),
                          coords=probe.tolist(), **kw)
        assert jcheck_grad(lambda v: jmodel.objective(v, jbatch, jy),
                           lambda v: jmodel.grad_mean(v, jbatch, jy), jnp.asarray(w),
                           coords=jnp.asarray(probe), **kw)
        got = numeric_grad(lambda v: model.objective(v, batch, yt), torch.from_numpy(w),
                           eps=1e-2, coords=probe.tolist())
        want = jnumeric_grad(lambda v: jmodel.objective(v, jbatch, jy), jnp.asarray(w),
                             eps=1e-2, coords=jnp.asarray(probe))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=NUM_ATOL)
        # a wrong analytic gradient fails the check
        assert not check_grad(lambda v: model.objective(v, batch, yt),
                              lambda v: -model.grad_mean(v, batch, yt), torch.from_numpy(w),
                              coords=probe.tolist(), **kw)


class TestFlatSparse:
    def test_matvec_matches_padded(self):
        idx, val, _, d = _rand(seed=5)
        flat = flat_sparse.from_padded(_batch(idx, val), device="cpu")
        jf = jflat.from_padded(JBatch(jnp.asarray(idx), jnp.asarray(val)))
        w = np.random.default_rng(2).normal(size=d).astype(np.float32)
        got = flat_sparse.matvec(flat, torch.from_numpy(w)).numpy()
        np.testing.assert_allclose(got, matvec(_batch(idx, val), torch.from_numpy(w)).numpy(),
                                   rtol=1e-5, atol=FLAT_ATOL)
        np.testing.assert_allclose(got, np.asarray(jflat.matvec(jf, jnp.asarray(w))),
                                   atol=FLAT_ATOL)
        for a, b in ((flat.indices, jf.indices), (flat.values, jf.values),
                     (flat.rows, jf.rows)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert flat.n_rows == jf.n_rows

    def test_scatter_matches_padded(self):
        idx, val, _, d = _rand(seed=6)
        flat = flat_sparse.from_padded(_batch(idx, val), device="cpu")
        jf = jflat.from_padded(JBatch(jnp.asarray(idx), jnp.asarray(val)))
        coeff = np.random.default_rng(3).normal(size=idx.shape[0]).astype(np.float32)
        got = flat_sparse.scatter_add(flat, torch.from_numpy(coeff), d).numpy()
        np.testing.assert_allclose(
            got, scatter_add(_batch(idx, val), torch.from_numpy(coeff), d).numpy(),
            rtol=1e-5, atol=FLAT_ATOL)
        np.testing.assert_allclose(got, np.asarray(jflat.scatter_add(jf, jnp.asarray(coeff), d)),
                                   atol=FLAT_ATOL)

    def test_padding_to_total_is_inert(self):
        idx, val, _, d = _rand(seed=7)
        w = torch.from_numpy(np.random.default_rng(4).normal(size=d).astype(np.float32))
        tight = flat_sparse.from_padded(_batch(idx, val), device="cpu")
        padded = flat_sparse.from_padded(_batch(idx, val), total=int(tight.indices.shape[0]) + 17,
                                         device="cpu")
        jpadded = jflat.from_padded(JBatch(jnp.asarray(idx), jnp.asarray(val)),
                                    total=int(tight.indices.shape[0]) + 17)
        np.testing.assert_array_equal(padded.indices.numpy(), np.asarray(jpadded.indices))
        np.testing.assert_allclose(flat_sparse.matvec(padded, w).numpy(),
                                   flat_sparse.matvec(tight, w).numpy(), rtol=1e-6)
        coeff = torch.ones(idx.shape[0])
        np.testing.assert_allclose(flat_sparse.scatter_add(padded, coeff, d).numpy(),
                                   flat_sparse.scatter_add(tight, coeff, d).numpy(), rtol=1e-6)

    def test_from_csr_roundtrip(self):
        rng = np.random.default_rng(8)
        row_ptr = np.array([0, 3, 3, 7], dtype=np.int64)  # middle row empty
        col_idx = rng.integers(0, 30, 7).astype(np.int32)
        values = rng.normal(size=7).astype(np.float32)
        flat = flat_sparse.from_csr(row_ptr, col_idx, values, device="cpu")
        jf = jflat.from_csr(row_ptr, col_idx, values)
        assert flat.n_rows == jf.n_rows == 3
        w = rng.normal(size=30).astype(np.float32)
        out = flat_sparse.matvec(flat, torch.from_numpy(w)).numpy()
        expect = np.zeros(3, dtype=np.float32)
        for r in range(3):
            s, e = row_ptr[r], row_ptr[r + 1]
            expect[r] = (values[s:e] * w[col_idx[s:e]]).sum()
        np.testing.assert_allclose(out, expect, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out, np.asarray(jflat.matvec(jf, jnp.asarray(w))),
                                   atol=FLAT_ATOL)

    def test_overflow_raises(self):
        idx, val, _, _ = _rand(seed=9)
        with pytest.raises(ValueError) as got:
            flat_sparse.from_padded(_batch(idx, val), total=1, device="cpu")
        with pytest.raises(ValueError) as want:
            jflat.from_padded(JBatch(jnp.asarray(idx), jnp.asarray(val)), total=1)
        assert str(got.value) == str(want.value)
