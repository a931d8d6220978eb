"""The port's sync engine (distributed_sgd_tpu_torch/parallel/sync.py)
against the JAX package's BoundSync, fed the same sample ids.

The JAX engine accepts injected ids through its `_sample_ids` method,
replaced on the instance before the first epoch; the port's takes the
whole epoch's ids from its own `_sample_ids`.  Weights after one epoch are
held to atol 1e-5 (f32 gradient sums in another order over 20 steps);
evaluate() to rtol 1e-5 (chunk sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.data.rcv1 import dim_sparsity
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel import mesh as jmesh
from distributed_sgd_tpu.parallel import sync as jsync
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.parallel import mesh as tmesh
from distributed_sgd_tpu_torch.parallel import sync as tsync

torch.set_num_threads(1)

N, D, NNZ, K, B, LR = 3000, 2000, 20, 3, 50, 0.5


def _torch_dataset(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _engines(n=N, k=K, b=B, kernel="mxu", sampling="fresh", model="hinge", seed=5):
    data = rcv1_like(n, n_features=D, nnz=NNZ, seed=seed, idf_values=True)
    ds = dim_sparsity(data)
    jm = jax_make_model(model, 1e-4, D, dim_sparsity=jnp.asarray(ds))
    tm = convert.model_from_jax(model, 1e-4, D, ds, device="cpu")
    jb = jsync.SyncEngine(jm, make_mesh(1), batch_size=b, learning_rate=LR,
                          kernel=kernel, virtual_workers=k, sampling=sampling).bind(data)
    tb = tsync.SyncEngine(tm, batch_size=b, learning_rate=LR, virtual_workers=k,
                          sampling=sampling, device="cpu").bind(_torch_dataset(data))
    return jb, tb


def _owned_ids(bound, seed=0):
    """[steps, K, B] ids, each worker drawing from its own sub-shard."""
    sub, starts, sizes = bound._subshards()
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, sub, (bound.steps_per_epoch, bound.virtual_workers, bound.batch_size))
    return sel % np.minimum(sub, sizes)[:, None] + starts[:, None]


@pytest.mark.parametrize("kernel,model", [("mxu", "hinge"), ("pallas", "hinge"),
                                          ("mxu", "logistic")])
def test_one_epoch_with_injected_ids_matches_jax(kernel, model):
    jb, tb = _engines(kernel=kernel, model=model)
    assert jb.steps_per_epoch == tb.steps_per_epoch == 20
    ids = _owned_ids(tb)
    jb._sample_ids = lambda key, step: jnp.asarray(ids, jnp.int32)[step]
    tb._sample_ids = lambda key: torch.from_numpy(ids)

    w_j = np.asarray(jb.epoch(jnp.zeros(D, jnp.float32), jax.random.PRNGKey(0)))
    w_t = tb.epoch(torch.zeros(D), key=0)
    assert np.abs(w_j).max() > 1e-2  # the epoch moved the weights
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=1e-5)

    np.testing.assert_allclose(tb.evaluate(w_t), jb.evaluate(jnp.asarray(w_j)), rtol=1e-5)
    # the same weights give the same predictions
    np.testing.assert_array_equal(
        tb.predict(convert.weights_from_jax(w_j, D, device="cpu")),
        jb.predict(jnp.asarray(w_j)))


def test_step_and_multi_epoch_follow_the_epoch_keys():
    _, tb = _engines()
    w0 = torch.zeros(D)
    ids = tb._sample_ids(tsync.fold_in(9, 0))
    np.testing.assert_array_equal(tb.step(w0, 9).numpy(), tb._one_step(w0, ids[0]).numpy())
    two = tb.epoch(tb.epoch(w0, tsync.fold_in(4, 0)), tsync.fold_in(4, 1))
    np.testing.assert_array_equal(tb.multi_epoch(w0, 4, 2).numpy(), two.numpy())


def test_fresh_draws_are_seeded_and_stay_in_each_workers_subshard():
    _, tb = _engines(n=1000, b=20)
    a, b = tb._sample_ids(1), tb._sample_ids(1)
    assert torch.equal(a, b) and not torch.equal(a, tb._sample_ids(2))
    sub, starts, sizes = tb._subshards()
    for k in range(K):
        lo, hi = starts[k], starts[k] + min(sub, sizes[k])
        assert ((a[:, k] >= lo) & (a[:, k] < hi)).all()


@pytest.mark.parametrize("sampling", ["fresh", "epoch"])
def test_sample_id_arithmetic_matches_jax_with_the_random_source_replaced(sampling, monkeypatch):
    # 1000 rows over 3 workers: a ragged trailing sub-shard (332 < 334)
    # whose out-of-range draws wrap in by modulo
    jb, tb = _engines(n=1000, b=20, sampling=sampling)
    assert jb.steps_per_epoch == tb.steps_per_epoch == 17
    sub, _, sizes = tb._subshards()
    assert (sub, int(sizes[-1])) == (334, 332)
    steps = tb.steps_per_epoch
    rng = np.random.default_rng(0)
    raw = rng.integers(0, sub, (steps, K, B := 20)).astype(np.int32)
    raw[0, -1, :3] = (333, 332, 0)  # draws the trailing worker must wrap
    perms = np.stack([rng.permutation(sub) for _ in range(K)]).astype(np.int32)
    step_now = {"s": 0}

    def randint(key, shape, minval, maxval):
        assert shape == (K, B) and (minval, maxval) == (0, sub)
        return jnp.asarray(raw[step_now["s"]])

    monkeypatch.setattr(jax.random, "randint", randint)
    monkeypatch.setattr(jax.random, "split", lambda key, num: jnp.arange(num))
    monkeypatch.setattr(jax.random, "permutation", lambda i, n: jnp.asarray(perms)[i])
    monkeypatch.setattr(tsync, "_uniform_draws",
                        lambda gen, shape, high, device: torch.from_numpy(raw).long())
    monkeypatch.setattr(tsync, "_permutations",
                        lambda gen, k, n, device: torch.from_numpy(perms).long())

    got = tb._sample_ids(0).numpy()
    assert got.shape == (steps, K, B)
    key = jax.random.PRNGKey(0)
    for s in range(steps):
        step_now["s"] = s
        np.testing.assert_array_equal(got[s], np.asarray(jb._sample_ids(key, jnp.int32(s))))


def test_bind_pads_to_the_eval_chunk_and_checks_trainability():
    data = rcv1_like(5000, n_features=D, nnz=NNZ, seed=1)
    tm = convert.model_from_jax("hinge", 1e-4, D, dim_sparsity(data), device="cpu")
    eng = tsync.SyncEngine(tm, batch_size=50, learning_rate=LR, virtual_workers=3, device="cpu")
    tb = eng.bind(_torch_dataset(data))
    assert tsync.padded_layout(5000, 1) == (8192, 4096)
    assert tb.shard_n == 8192 and tb.eval_chunk == 4096
    assert int((tb.data.labels == 0).sum()) == 8192 - 5000
    assert tb.steps_per_epoch == tsync.steps_per_epoch_for(5000, 1, 3, 50) == 34
    small = tsync.SyncEngine(tm, batch_size=50, learning_rate=LR, virtual_workers=3,
                             sampling="epoch", device="cpu").bind(_torch_dataset(data.slice(slice(0, 90))))
    with pytest.raises(ValueError, match="sampling='epoch'"):
        small.epoch(torch.zeros(D), 0)
    adam = tsync.SyncEngine(tm, batch_size=50, learning_rate=LR, optimizer="adam",
                            device="cpu").bind(_torch_dataset(data))
    assert [tuple(x.shape) for x in adam.opt_state_leaves()] == [(), (D,), (D,)]
    with pytest.raises(ValueError, match="optimizer"):
        tsync.SyncEngine(tm, batch_size=50, learning_rate=LR, optimizer="rmsprop", device="cpu")


@pytest.mark.parametrize("n", [12, 13, 16])
def test_pad_to_multiple_matches_jax(n):
    data = rcv1_like(n, n_features=D, nnz=5, seed=n)
    got = tmesh.pad_to_multiple(_torch_dataset(data), 4)
    want = jmesh.pad_to_multiple(data, 4)
    for name in ("indices", "values", "labels"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
