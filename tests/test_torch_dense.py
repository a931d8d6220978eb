"""The port's dense layout (Dataset.dense, the models' matmul path, the
engines' dense backend) against the JAX package's, on the CPU.

A counterpart of each test of tests/test_dense_path.py.  The same numpy
rows go through the JAX function and the port's.  Where an engine draws
ids, both sides get the same draws (numpy's for the sync engine, JAX's own
for Hogwild and local SGD): the port's dense path then lands within 1e-5
of the JAX engine and within 1e-5 of the same rows in the sparse layout
(indices arange(D)) through the port's sparse path.  f32 sums in another
order set the tolerances: 1e-5 on weights and losses, rtol 1e-6 on
objectives, as stated at each assert."""

import signal
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.data.rcv1 import Dataset as JDataset
from distributed_sgd_tpu.data.rcv1 import dim_sparsity as jdim_sparsity
from distributed_sgd_tpu.data.synthetic import dense_regression as jdense_regression
from distributed_sgd_tpu.models.linear import make_model as jmake_model
from distributed_sgd_tpu.ops.sparse import SparseBatch as JBatch
from distributed_sgd_tpu.parallel import hogwild as jhog
from distributed_sgd_tpu.parallel.local_sgd import LocalSGDEngine as JLocalSGD
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu.parallel.sync import SyncEngine as JSyncEngine
from distributed_sgd_tpu.utils.metrics import Metrics as JMetrics
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity, pack_csr
from distributed_sgd_tpu_torch.data.synthetic import dense_regression
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch
from distributed_sgd_tpu_torch.parallel import hogwild as thog
from distributed_sgd_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distributed_sgd_tpu_torch.parallel.sync import BoundSync, ShardedData, SyncEngine
from distributed_sgd_tpu_torch.utils.metrics import Metrics


LIMIT_S = 120  # each test's own time limit, seconds


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)

torch.set_num_threads(1)

ATOL = 1e-5  # weights, margins, gradients and losses: f32 sums in another order
OBJ_RTOL = 1e-6  # an objective or accuracy against JAX's on the same rows


def _pair(n=32, d=16, seed=0, labels="cls"):
    """The same data in dense and sparse layouts (port datasets)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d)).astype(np.float32)
    if labels == "cls":
        y = np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32)
    else:
        y = rng.normal(size=n).astype(np.float32)
    dense = Dataset.dense(x, y)
    idx = np.broadcast_to(np.arange(d, dtype=np.int32), (n, d)).copy()
    sparse = Dataset(indices=idx, values=x.copy(), labels=y, n_features=d)
    return dense, sparse


def _jax(ds) -> JDataset:
    return JDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _batch(ds):
    return SparseBatch(torch.from_numpy(ds.indices), torch.from_numpy(ds.values))


def _jbatch(ds):
    return JBatch(jnp.asarray(ds.indices), jnp.asarray(ds.values))


def _models(name, lam, d, reg="l2"):
    return (jmake_model(name, lam, d, regularizer=reg),
            make_model(name, lam, d, regularizer=reg, device="cpu"))


def test_dense_layout_properties():
    dense, sparse = _pair()
    assert dense.is_dense and not sparse.is_dense
    assert len(dense) == len(sparse)
    assert dense.pad_width == dense.n_features
    assert dense.indices.shape == (32, 0)
    sl = dense.slice(slice(0, 8))
    assert sl.is_dense and len(sl) == 8
    want = JDataset.dense(dense.values, dense.labels)
    for a, b in ((dense.indices, want.indices), (dense.values, want.values),
                 (dense.labels, want.labels)):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("model_name,labels", [
    ("hinge", "cls"), ("logistic", "cls"), ("least_squares", "reg"),
])
def test_dense_model_math_matches_sparse(model_name, labels):
    dense, sparse = _pair(labels=labels)
    jm, tm = _models(model_name, 1e-3, dense.n_features)
    w_np = np.random.default_rng(1).normal(size=dense.n_features).astype(np.float32)
    w, jw = torch.from_numpy(w_np), jnp.asarray(w_np)
    y, jy = torch.from_numpy(dense.labels), jnp.asarray(dense.labels)
    x = torch.from_numpy(dense.values)

    m_dense = tm.margins_dense(w, x)
    np.testing.assert_allclose(m_dense.numpy(), np.asarray(jm.margins_dense(jw, jnp.asarray(
        dense.values))), atol=ATOL)
    np.testing.assert_allclose(m_dense.numpy(), tm.margins(w, _batch(sparse)).numpy(),
                               atol=ATOL)
    for reduce in ("sum", "mean"):
        g = tm.grad_dense(w, x, y, reduce=reduce).numpy()
        want = np.asarray(jm.grad_dense(jw, jnp.asarray(dense.values), jy, reduce=reduce))
        np.testing.assert_allclose(g, want, atol=ATOL)
        twin = (tm.grad_sum(w, _batch(sparse), y) if reduce == "sum"
                else tm.grad_mean(w, _batch(sparse), y))
        np.testing.assert_allclose(g, twin.numpy(), atol=ATOL)
    # grad_regularized routes a dense batch by its layout
    g_auto = tm.grad_regularized(w, _batch(dense), y).numpy()
    np.testing.assert_allclose(g_auto, np.asarray(jm.grad_regularized(
        jw, _jbatch(dense), jy, blocked=True)), atol=ATOL)
    np.testing.assert_allclose(g_auto, tm.regularize(tm.grad_sum(w, _batch(sparse), y),
                                                     w).numpy(), atol=ATOL)


def test_sync_engine_auto_selects_dense_kernel():
    dense, sparse = _pair(n=64, d=16)
    _, tm = _models("hinge", 1e-3, 16)
    bound = SyncEngine(tm, batch_size=4, learning_rate=0.1, device="cpu").bind(dense)
    assert bound.kernel == "dense" and not bound.epoch_kernel
    assert SyncEngine(tm, 4, 0.1, device="cpu").bind(sparse).kernel == "sparse"


def test_dense_kernel_layout_mismatch_raises():
    """The port's layout picks the kernel, so the mismatch that JAX refuses
    (kernel='dense' on sparse rows) cannot be asked for.  What is refused
    is dense rows that do not span the model's features, at bind time."""
    dense, sparse = _pair(n=64, d=16)
    jm, tm = _models("hinge", 1e-3, 24)
    with pytest.raises(ValueError, match="dense"):
        JSyncEngine(jm, make_mesh(2), batch_size=4, learning_rate=0.1,
                    kernel="dense").bind(_jax(sparse))

    def shard(ds):
        return ShardedData(torch.from_numpy(ds.indices), torch.from_numpy(ds.values),
                           torch.from_numpy(ds.labels), n_true=len(ds))

    with pytest.raises(ValueError, match="dense"):
        BoundSync(tm, shard(dense), 4, 0.1, eval_chunk=64)
    with pytest.raises(ValueError, match="dense"):
        SyncEngine(tm, 4, 0.1, device="cpu").bind(dense)
    assert BoundSync(tm, shard(sparse), 4, 0.1, eval_chunk=64).kernel == "sparse"


def _draws(bound, rng, k, b):
    sub, starts, sizes = bound._subshards()
    sel = rng.integers(0, sub, (bound.steps_per_epoch, k, b))
    return sel % np.minimum(sub, sizes)[:, None] + starts[:, None]


@pytest.mark.parametrize("virtual_workers", [1, 3])
def test_sync_epoch_dense_matches_sparse(virtual_workers):
    dense, sparse = _pair(n=64, d=16, labels="reg")
    jm, tm = _models("least_squares", 0.0, 16, reg="none")
    kw = dict(batch_size=4, learning_rate=0.05, virtual_workers=virtual_workers)
    jb = JSyncEngine(jm, make_mesh(1), **kw).bind(_jax(dense))
    tb = SyncEngine(tm, device="cpu", **kw).bind(dense)
    ts = SyncEngine(tm, device="cpu", **kw).bind(sparse)
    assert jb.kernel == tb.kernel == "dense"
    ids = _draws(tb, np.random.default_rng(7), virtual_workers, 4)
    jb._sample_ids = lambda key, step, a=jnp.asarray(ids, jnp.int32): a[step]
    for b in (tb, ts):
        b._sample_ids = lambda key, a=torch.from_numpy(ids): a
    w_jax = np.asarray(jb.epoch(jnp.zeros(16, jnp.float32), jax.random.PRNGKey(0)))
    w_dense = tb.epoch(torch.zeros(16), 0)
    w_sparse = ts.epoch(torch.zeros(16), 0)
    assert np.abs(w_jax).max() > 1e-2
    np.testing.assert_allclose(w_dense.numpy(), w_jax, atol=ATOL)
    np.testing.assert_allclose(w_dense.numpy(), w_sparse.numpy(), atol=ATOL)
    loss_d, loss_s = tb.evaluate(w_dense)[0], ts.evaluate(w_sparse)[0]
    assert abs(loss_d - loss_s) < ATOL
    assert abs(loss_d - float(jb.evaluate(jnp.asarray(w_jax))[0])) < ATOL
    # step, multi_epoch and the optimizer's leaves work on dense data too
    assert tb.step(w_dense, 1).shape == (16,)
    adam = SyncEngine(tm, optimizer="adam", device="cpu", **kw).bind(dense)
    w2 = adam.multi_epoch(torch.zeros(16), 3, 2)
    assert bool(torch.isfinite(w2).all()) and int(adam.opt_state_leaves()[0]) == 2 * (
        adam.steps_per_epoch)


def test_sync_eval_and_predict_dense():
    dense, sparse = _pair(n=64, d=16)
    jm, tm = _models("hinge", 1e-3, 16)
    w_np = np.random.default_rng(3).normal(size=16).astype(np.float32)
    bd = SyncEngine(tm, 4, 0.1, device="cpu").bind(dense)
    bs = SyncEngine(tm, 4, 0.1, device="cpu").bind(sparse)
    jd = JSyncEngine(jm, make_mesh(1), 4, 0.1).bind(_jax(dense))
    loss_d, acc_d = bd.evaluate(torch.from_numpy(w_np))
    loss_s, acc_s = bs.evaluate(torch.from_numpy(w_np))
    loss_j, acc_j = jd.evaluate(jnp.asarray(w_np))
    assert abs(loss_d - loss_s) < ATOL and acc_d == acc_s
    assert abs(loss_d - float(loss_j)) < ATOL and acc_d == pytest.approx(float(acc_j),
                                                                          rel=OBJ_RTOL)
    np.testing.assert_array_equal(bd.predict(torch.from_numpy(w_np)),
                                  bs.predict(torch.from_numpy(w_np)))
    np.testing.assert_array_equal(bd.predict(torch.from_numpy(w_np)),
                                  np.asarray(jd.predict(jnp.asarray(w_np))))


def test_dense_regression_uses_dense_layout():
    ds = dense_regression(16, n_features=8, seed=0)
    assert ds.is_dense
    assert ds.indices.shape == (16, 0)
    want = jdense_regression(16, n_features=8, seed=0)
    assert ds.values.tobytes() == want.values.tobytes()
    assert ds.labels.tobytes() == want.labels.tobytes()


def _jax_local_sgd_draws(seed, n_rounds, h, b, shard_n):
    """The ids of a one-device JAX LocalSGDEngine fit, round by round."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_rounds):
        key, rk = jax.random.split(key)
        dk = jax.random.fold_in(rk, 0)
        out.append(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(dk, t), (b,),
                                                           0, shard_n))
                             for t in range(h)])[:, None, :].astype(np.int64))
    return out


def test_local_sgd_dense():
    dense, sparse = _pair(n=64, d=16, labels="reg")
    jm, tm = _models("least_squares", 0.0, 16, reg="none")
    kw = dict(batch_size=4, learning_rate=0.05, sync_period=4, check_every=32, seed=2)
    jr = JLocalSGD(jm, make_mesh(1), metrics=JMetrics(), **kw).fit(
        _jax(dense.slice(slice(0, 48))), _jax(dense.slice(slice(48, 64))), max_epochs=2)
    draws = _jax_local_sgd_draws(2, 24, 4, 4, 48)
    got = {}
    for name, ds in (("dense", dense), ("sparse", sparse)):
        eng = LocalSGDEngine(tm, metrics=Metrics(), device="cpu", **kw)
        eng._sample_ids = lambda rnd, shard_n: torch.from_numpy(draws[rnd])
        got[name] = eng.fit(ds.slice(slice(0, 48)), ds.slice(slice(48, 64)), max_epochs=2)
    res = got["dense"]
    assert res.state.updates == jr.state.updates > 0
    assert np.isfinite(res.test_losses[-1])
    np.testing.assert_allclose(res.test_losses, jr.test_losses, atol=ATOL)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jr.weights), atol=ATOL)
    np.testing.assert_allclose(res.weights.numpy(), got["sparse"].weights.numpy(), atol=ATOL)


def test_hogwild_dense():
    dense, sparse = _pair(n=64, d=16, labels="reg")
    jm, tm = _models("least_squares", 0.0, 16, reg="none")
    b, k = 4, 8
    shard = dense.slice(slice(0, 32))
    jw = jhog._Worker(0, jm, _jax(shard), jax.devices()[0], b, 0.05, 0, JMetrics(),
                      steps_per_dispatch=k)
    w0 = (np.random.default_rng(1).normal(size=16) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jw._step(jnp.asarray(w0), None, jw._idx, jw._val, jw._y, key)[0])
    ids = np.stack([np.asarray(jax.random.randint(kk, (b,), 0, len(shard)))
                    for kk in jax.random.split(key, k)])[:, None, :].astype(np.int64)
    deltas = []
    for ds in (shard, sparse.slice(slice(0, 32))):
        sd = ShardedData(torch.from_numpy(ds.indices), torch.from_numpy(ds.values),
                         torch.from_numpy(ds.labels).float(), n_true=len(ds))
        tw = thog._Worker(0, tm, sd, b, 0.05, 0, Metrics(), steps_per_dispatch=k)
        deltas.append(tw._step(torch.from_numpy(w0), torch.from_numpy(ids)).numpy())
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(deltas[0], want, atol=ATOL)
    np.testing.assert_allclose(deltas[0], deltas[1], atol=ATOL)
    # and a whole fit trains
    eng = thog.HogwildEngine(tm, n_workers=2, batch_size=4, learning_rate=0.05,
                             check_every=16, device="cpu")
    res = eng.fit(dense.slice(slice(0, 48)), dense.slice(slice(48, 64)), max_epochs=1)
    assert res.state.updates > 0


def test_forward_and_objective_route_dense():
    """forward/objective/accuracy on a dense batch match the sparse layout
    and JAX: the RPC worker's Forward body sees real margins."""
    dense, sparse = _pair(n=32, d=16)
    jm, tm = _models("hinge", 1e-3, 16)
    w_np = np.random.default_rng(2).normal(size=16).astype(np.float32)
    w, jw = torch.from_numpy(w_np), jnp.asarray(w_np)
    y, jy = torch.from_numpy(dense.labels), jnp.asarray(dense.labels)
    db, sb = _batch(dense), _batch(sparse)
    np.testing.assert_array_equal(tm.forward(w, db).numpy(), tm.forward(w, sb).numpy())
    np.testing.assert_array_equal(tm.forward(w, db).numpy(),
                                  np.asarray(jm.forward(jw, _jbatch(dense))))
    assert not np.all(tm.forward(w, db).numpy() == 0.0)
    for fn in ("objective", "accuracy"):
        got = float(getattr(tm, fn)(w, db, y))
        assert got == pytest.approx(float(getattr(tm, fn)(w, sb, y)), rel=OBJ_RTOL)
        assert got == pytest.approx(float(getattr(jm, fn)(jw, _jbatch(dense), jy)),
                                    rel=OBJ_RTOL)


def test_zero_width_sparse_is_unambiguous():
    row_ptr = np.array([0, 0, 0], dtype=np.int64)
    idx, val = pack_csr(row_ptr, np.empty(0, np.int32), np.empty(0, np.float32))
    assert idx.shape == (2, 1)  # width >= 1, not 0
    with pytest.raises(ValueError, match="dense layout"):
        Dataset(indices=np.empty((2, 0), np.int32), values=np.empty((2, 0), np.float32),
                labels=np.zeros(2, np.int32), n_features=5)


def test_dim_sparsity_dense_matches_sparse():
    dense, sparse = _pair(n=32, d=16)
    dense.values[dense.values < -1.0] = 0.0
    sparse.values[sparse.values < -1.0] = 0.0
    np.testing.assert_allclose(dim_sparsity(dense), dim_sparsity(sparse))
    np.testing.assert_array_equal(dim_sparsity(dense), jdim_sparsity(_jax(dense)))


def test_feature_sharded_trains_dense(monkeypatch):
    """The feature-sharded engine trains dense rows in both packages: at one
    data rank and one feature rank (no process group) the port's epoch
    over column tiles equals the JAX engine's on a 1 x 1 mesh within 1e-5,
    both fed the same ids (the JAX engine's randint replaced, see
    tests/test_torch_feature_sharded.py), and so do their evaluations."""
    from distributed_sgd_tpu.parallel import feature_sharded as jfs
    from distributed_sgd_tpu_torch.parallel import feature_sharded as tfs

    dense = dense_regression(300, n_features=40, seed=4)
    train = dense.slice(slice(0, 240))
    jm, tm = _models("least_squares", 1e-4, 40, reg="l2")
    jeng = jfs.FeatureShardedEngine(jm, jfs.make_mesh_2d(1, 1), 8, 0.01).bind(_jax(train))
    teng = tfs.FeatureShardedEngine(tm, tfs.make_mesh_2d(1, 1, device="cpu"), 8, 0.01)
    teng.bind(train)
    ids = np.random.default_rng(0).integers(0, teng.shard_n, (1, teng.steps_per_epoch, 8))
    monkeypatch.setattr(jax.random, "fold_in", lambda k, d: k * 1000 + d)
    monkeypatch.setattr(jax.random, "randint",
                        lambda k, shape, lo, hi: jnp.asarray(ids)[k // 1000, k % 1000])
    w_j = jeng.epoch(jeng.init_weights(), jnp.int32(0))
    teng._sample_ids = lambda key: torch.from_numpy(ids[0])
    w_t = teng.epoch(teng.init_weights(), 0)
    assert np.abs(jeng.to_dense(w_j)).max() > 1e-3  # the epoch moved the weights
    np.testing.assert_allclose(teng.to_dense(w_t), jeng.to_dense(w_j), atol=1e-5)
    np.testing.assert_allclose(teng.evaluate(w_t), jeng.evaluate(w_j), rtol=1e-5)


def test_a_jax_master_trains_dense_rows_on_torch_workers():
    """The RPC worker's bodies route dense rows too (Gradient through
    ``grad_regularized``, Forward through ``margins``): a JAX master's sync
    fit over 2 torch workers is the JAX cluster's within 1e-5."""
    from distributed_sgd_tpu.core.cluster import DevCluster as JCluster
    from distributed_sgd_tpu.core.master import MasterNode as JMaster
    from distributed_sgd_tpu_torch.core.worker import WorkerNode

    dense = dense_regression(200, n_features=16, seed=3)
    train, test = dense.slice(slice(0, 160)), dense.slice(slice(160, 200))
    jm, tm = _models("least_squares", 0.0, 16, reg="none")
    with JCluster(jm, _jax(train), _jax(test), n_workers=2, seed=0) as c:
        want = c.master.fit_sync(2, 8, 0.005)
    master = JMaster("127.0.0.1", 0, _jax(train), _jax(test), jm, expected_workers=2,
                     seed=0, metrics=JMetrics()).start()
    workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, train, tm, seed=i,
                          metrics=Metrics()) for i in range(2)]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        got = master.fit_sync(2, 8, 0.005, grad_timeout_s=15.0)
        preds = master.predict(np.asarray(got.weights))
    finally:
        for w in workers:
            w.stop()
        master.stop()
    assert want.test_losses[-1] < want.test_losses[0]
    np.testing.assert_allclose(got.test_losses, want.test_losses, rtol=ATOL)
    np.testing.assert_allclose(np.asarray(got.weights), np.asarray(want.weights), atol=ATOL)
    np.testing.assert_allclose(preds, train.values @ np.asarray(got.weights), atol=ATOL)
