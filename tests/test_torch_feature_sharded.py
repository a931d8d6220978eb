"""The port's dp x tp engine (parallel/feature_sharded.py) against the JAX
package's on a 2-D mesh, on the CPU.

The port's W x F grid is W * F gloo ranks, each a process of its own that
imports only the port (tests/torch_ranks.py); the JAX engine runs here on
``make_mesh_2d(W, F)`` over the test process's CPU devices.  Both are fed
the same ids: the JAX engine draws each step's ids with
``jax.random.randint(fold_in(fold_in(key, w), step))`` inside its epoch,
so the test replaces ``fold_in`` by ``k * 1000 + d`` and ``randint`` by a
read of the id table at (w, step), with the epoch key 0; each port rank
reads its data rank's row.  The weights (gathered over the feature ranks)
are held to atol 1e-5 and the evaluations to rtol 1e-5.  Every test has a
SIGALRM limit of its own; the ranks have theirs."""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ranks
from distributed_sgd_tpu.config import Config as JaxConfig
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import dense_regression, rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel import feature_sharded as jfs
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.parallel import feature_sharded as tfs
from distributed_sgd_tpu_torch.parallel.sync import padded_layout

LIMIT_S = 60
D, NNZ, B, LR = 2000, 20, 32, 0.5


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _ids(n_true, w, b, rng):
    """[W, steps, B] ids into each data rank's padded shard."""
    shard_n = padded_layout(n_true, w)[0] // w
    steps = max(1, -(-(-(-n_true // w)) // b))
    return rng.integers(0, shard_n, (w, steps, b)).astype(np.int64)


def _jax_epoch(eng, ids, monkeypatch):
    """The JAX engine's epoch from zeros with `ids` injected."""
    with monkeypatch.context() as m:
        m.setattr(jax.random, "fold_in", lambda k, d: k * 1000 + d)
        m.setattr(jax.random, "randint",
                  lambda k, shape, lo, hi: jnp.asarray(ids)[k // 1000, k % 1000])
        return eng.epoch(eng.init_weights(), jnp.int32(0))


@pytest.fixture(scope="module")
def sparse():
    train, test = train_test_split(rcv1_like(2400, n_features=D, nnz=NNZ, seed=7,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


@pytest.fixture(scope="module")
def dense():
    data = dense_regression(900, n_features=300, seed=5)
    return data.slice(slice(0, 720)), data.slice(slice(720, 900))


@pytest.fixture(scope="module")
def grids(sparse, dense, tmp_path_factory):
    """The (1, 2) cases in one world of 2 ranks and the (2, 2) ones in a
    world of 4."""
    train, test, ds = sparse
    dtrain, dtest = dense
    out, ids = {}, {}
    for w, f in ((1, 2), (2, 2)):
        d = str(tmp_path_factory.mktemp(f"grid{w}x{f}"))
        rng = np.random.default_rng(w * 10 + f)
        ids[w, f, "sparse"] = _ids(len(train), w, B, rng)
        torch_ranks.write_case(
            d, "sparse", dict(kind="feature_sharded", model="hinge", lam=1e-4,
                              reg="dim_sparsity", batch=B, lr=LR, w=w, f=f),
            ids=ids[w, f, "sparse"], ds=ds, **torch_ranks.dataset_arrays("train", train),
            **torch_ranks.dataset_arrays("test", test))
        ids[w, f, "dense"] = _ids(len(dtrain), w, 8, rng)
        torch_ranks.write_case(
            d, "dense", dict(kind="feature_sharded", model="least_squares", lam=1e-4,
                             reg="l2", batch=8, lr=1e-4, w=w, f=f),
            ids=ids[w, f, "dense"], ds=np.zeros(300, np.float32),
            **torch_ranks.dataset_arrays("train", dtrain),
            **torch_ranks.dataset_arrays("test", dtest))
        cases = ["sparse", "dense"]
        if (w, f) == (1, 2):
            torch_ranks.write_case(
                d, "resume", dict(kind="fs_resume", model="hinge", lam=1e-4,
                                  reg="dim_sparsity", batch=B, lr=LR, w=w, f=f),
                ds=ds, **torch_ranks.dataset_arrays("train", train),
                **torch_ranks.dataset_arrays("test", test))
            cases.append("resume")
        got = torch_ranks.spawn(d, w * f, cases, timeout=120)
        for name in cases:
            out[w, f, name] = got[name]
    return out, ids


@pytest.mark.parametrize("w,f", [(1, 2), (2, 2)])
def test_the_grid_with_dim_sparsity_matches_the_jax_engine(grids, sparse, monkeypatch, w, f):
    train, test, ds = sparse
    out, ids = grids
    jm = jax_make_model("hinge", 1e-4, D, dim_sparsity=jnp.asarray(ds))
    jeng = jfs.FeatureShardedEngine(jm, jfs.make_mesh_2d(w, f), B, LR).bind(train)
    w_j = _jax_epoch(jeng, ids[w, f, "sparse"], monkeypatch)
    ranks = out[w, f, "sparse"]
    # the feature ranks hold the JAX engine's row ranges, x 128, clipped
    for r, got in enumerate(ranks):
        lo = min((r % f) * jeng.r_local * 128, D)
        assert got["bounds"].tolist() == [lo, min(lo + jeng.r_local * 128, D), jeng.shard_n,
                                          jeng.steps_per_epoch]
        np.testing.assert_array_equal(got["w"], ranks[0]["w"])  # every rank gathers one w
        np.testing.assert_array_equal(got["train_eval"], ranks[0]["train_eval"])
    want = jeng.to_dense(w_j)
    assert np.abs(want).max() > 1e-2
    np.testing.assert_allclose(ranks[0]["w"], want, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["train_eval"], jeng.evaluate(w_j), rtol=1e-5)
    jt = jfs.FeatureShardedEngine(jm, jfs.make_mesh_2d(w, f), B, LR).bind(test)
    np.testing.assert_allclose(ranks[0]["test_eval"], jt.evaluate(jt.from_dense(want)),
                               rtol=1e-5)
    assert ranks[0]["preds"].shape == (len(test),)
    # the predictions of the port's weights are the 1-D engine's of them
    tm = convert.model_from_jax("hinge", 1e-4, D, ds, device="cpu")
    one = tfs.FeatureShardedEngine(tm, tfs.make_mesh_2d(1, 1, device="cpu"), B, LR).bind(
        _torch(test))
    np.testing.assert_array_equal(ranks[0]["preds"],
                                  one.predict(one.from_dense(ranks[0]["w"])))


@pytest.mark.parametrize("w,f", [(1, 2), (2, 2)])
def test_the_grid_on_the_dense_layout_matches_the_jax_engine(grids, dense, monkeypatch, w, f):
    dtrain, dtest = dense
    out, ids = grids
    jm = jax_make_model("least_squares", 1e-4, 300, regularizer="l2")
    jeng = jfs.FeatureShardedEngine(jm, jfs.make_mesh_2d(w, f), 8, 1e-4).bind(dtrain)
    w_j = _jax_epoch(jeng, ids[w, f, "dense"], monkeypatch)
    ranks = out[w, f, "dense"]
    want = jeng.to_dense(w_j)
    assert np.abs(want).max() > 1e-3
    for got in ranks:
        np.testing.assert_array_equal(got["w"], ranks[0]["w"])
    np.testing.assert_allclose(ranks[0]["w"], want, atol=1e-5)
    np.testing.assert_allclose(ranks[0]["train_eval"], jeng.evaluate(w_j), rtol=1e-5)


def test_a_grid_snapshot_resumes_in_the_sync_trainer(grids):
    got = grids[0][1, 2, "resume"]
    for r in got:
        # 2 epochs on the grid, the third in the 1-D trainer from its snapshot
        assert r["steps"].tolist() == [1, 2, 3]
        assert int(r["sync_epochs"]) == 3
        assert len(r["sync_losses"]) == 1 and len(r["fs_losses"]) == 2
        assert r["sync_losses"][0] < r["fs_losses"][0]
    np.testing.assert_array_equal(got[0]["fs_w"], got[1]["fs_w"])


def test_a_sync_trainer_snapshot_resumes_on_the_grid(sparse, tmp_path):
    from distributed_sgd_tpu_torch.checkpoint import Checkpointer
    from distributed_sgd_tpu_torch.core.trainer import SyncTrainer

    train, test, ds = sparse
    tm = convert.model_from_jax("hinge", 1e-4, D, ds, device="cpu")
    first = SyncTrainer(tm, B, LR, seed=1, checkpointer=Checkpointer(str(tmp_path)),
                        device="cpu").fit(_torch(train), _torch(test), 1)
    eng = tfs.FeatureShardedEngine(tm, tfs.make_mesh_2d(1, 1, device="cpu"), B, LR)
    res = eng.fit(_torch(train), _torch(test), 2, checkpointer=Checkpointer(str(tmp_path)),
                  seed=1)
    assert res.epochs_run == 2 and len(res.test_losses) == 1
    assert res.test_losses[0] < first.test_losses[0]
    assert sorted(os.listdir(tmp_path)) == ["1.npz", "2.npz"]
    # nothing left to run: the restored weights and the epochs already run
    again = tfs.FeatureShardedEngine(tm, tfs.make_mesh_2d(1, 1, device="cpu"), B, LR).fit(
        _torch(train), _torch(test), 2, checkpointer=Checkpointer(str(tmp_path)))
    assert again.epochs_run == 2
    np.testing.assert_array_equal(again.weights.numpy(), res.weights.numpy())


def test_the_grid_refuses_what_jax_refuses(sparse):
    train, _, ds = sparse
    tm = convert.model_from_jax("hinge", 1e-4, D, ds, device="cpu")
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        tfs.make_mesh_2d(1, 2, device="cpu")
    for kw in (dict(feature_shards=2, use_async=True), dict(feature_shards=2, engine="rpc"),
               dict(feature_shards=2, optimizer="adam"), dict(feature_shards=0)):
        with pytest.raises(ValueError) as jerr:
            JaxConfig(**kw)
        with pytest.raises(ValueError) as terr:
            Config(**kw)
        assert str(terr.value) == str(jerr.value)
    assert Config(feature_shards=4).feature_shards == 4
    # the grid's bounds: the JAX engine's 8-aligned blocked rows, in features
    eng = tfs.FeatureShardedEngine(tm, tfs.make_mesh_2d(1, 1, device="cpu"), B, LR)
    assert (eng.lo, eng.hi, eng.r_total) == (0, D, 16)


def test_the_cli_routes_feature_shards_over_a_two_rank_world(tmp_path):
    env = {"DSGD_SYNTHETIC": "3000", "DSGD_MAX_EPOCHS": "2", "DSGD_FEATURE_SHARDS": "2"}
    outs, logs = torch_ranks.cli_world(tmp_path, 2, env)
    np.testing.assert_array_equal(outs[0]["w"], outs[1]["w"])
    assert int(outs[0]["epochs"]) == 2 and outs[0]["losses"][-1] < 1.0
    assert "engine=mesh 2-D dp=1 x tp=2 (feature_shards)" in logs[0]
    # F must divide the world
    env["DSGD_FEATURE_SHARDS"] = "3"
    with pytest.raises(AssertionError, match="does not divide the world of 2 rank"):
        torch_ranks.cli_world(tmp_path, 2, env)
