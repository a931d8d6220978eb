"""The port's async fit over RPC (core/master.py ``fit_async``,
core/worker.py's async seams) against the JAX package's, on the CPU over
real loopback gRPC.

One worker dispatch, fed the JAX worker's own ``jax.random`` draws
through the ``_draw_ids`` seam, equals the JAX worker's k-step body
(``grad_regularized`` with the mean, then ``local_update``) within 1e-6:
the delta, the weights and the optimizer state, for sgd, momentum and
adam.  Whole fits are not repeatable in either package (the workers race),
so a port cluster, a JAX one and both mixed clusters are held to the
JAX tests' band around a sync fit's final test loss.  The rest mirrors
the JAX package's async tests: amortized dispatches, a worker killed
mid-fit, all workers dead, a stall the watchdog mends, a resume past the
budget, and the batch-drain inbox."""

import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core.cluster import DevCluster as JaxCluster
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.ops.sparse import SparseBatch as JaxBatch
from distributed_sgd_tpu.parallel import sync as jsync
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.loss_check import LossChecker
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.parallel import sync as tsync
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import WorkerStub, new_channel
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod
from distributed_sgd_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

D, LAM, B, K = 300, 1e-4, 32, 8
EPOCHS, LR = 1, 0.1  # the async budget: n_train local steps of B samples
# the anchor: a sync fit of 3 epochs, 3 workers, B and LR, as
# tests/test_async_convergence.py's; and that test's band around it
SYNC_EPOCHS, SYNC_WORKERS = 3, 3
ASYNC_TOL = 0.12
OPT_LR = {"sgd": 0.5, "momentum": 0.05, "adam": 0.001}
FAST = dict(check_every=200, backoff_s=0.02)


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


@pytest.fixture(scope="module")
def data():
    train, test = train_test_split(rcv1_like(2400, n_features=D, nnz=12, noise=0.02, seed=21,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _models(data, name="hinge"):
    _, _, ds = data
    return (jax_make_model(name, LAM, D, dim_sparsity=jnp.asarray(ds)),
            make_model(name, LAM, D, dim_sparsity=ds, device="cpu"))


_anchor = {}


def _sync_loss(data):
    """The sync anchor's final test loss on the same data and step."""
    if "sync" not in _anchor:
        train, test, _ = data
        tr = SyncTrainer(_models(data)[1], batch_size=B, learning_rate=LR, seed=0,
                         virtual_workers=SYNC_WORKERS, device="cpu")
        _anchor["sync"] = tr.fit(_torch(train), _torch(test),
                                 max_epochs=SYNC_EPOCHS).test_losses[-1]
    return _anchor["sync"]


def _jax_best(data):
    """The JAX DevCluster's async fit: its best smoothed test loss."""
    if "jax" not in _anchor:
        train, test, _ = data
        with JaxCluster(_models(data)[0], train, test, n_workers=2,
                        steps_per_dispatch=K) as c:
            res = c.master.fit_async(EPOCHS, B, LR, **FAST)
        _anchor["jax"] = (float(res.state.loss), res.state.updates)
    return _anchor["jax"]


def _async_threads():
    return [t.name for t in threading.enumerate() if t.name.startswith("async-")]


# -- one dispatch against the JAX worker's k-step body ------------------------


def _jax_dispatch(jmodel, train, assignment, w0, key, opt_name, lr):
    """The JAX worker's first dispatch (core/worker.py _async_loop_impl):
    its draws from PRNGKey(seed + port), then the scan body step by step.
    Returns (the ids it drew, the summed delta, w_k, the optimizer state)."""
    key, kk = jax.random.split(key)
    rows = np.stack([assignment[np.asarray(jax.random.randint(s, (B,), 0, len(assignment)))]
                     for s in jax.random.split(kk, K)])
    opt = jsync.resolve_optimizer(opt_name, lr, 0.9)
    w = jnp.asarray(w0)
    state = opt.init(w) if opt is not None else None
    acc = jnp.zeros_like(w)
    idx, val, y = (jnp.asarray(a) for a in (train.indices, train.values, train.labels))
    for ids in rows:
        g = jmodel.grad_regularized(w, JaxBatch(idx[ids], val[ids]), y[ids], reduce="mean")
        w, state, delta = jsync.local_update(opt, lr, g, w, state)
        acc = acc + delta
    return rows, np.asarray(acc), np.asarray(w), state


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("name", ["hinge", "logistic"])
def test_one_worker_dispatch_matches_the_jax_worker(data, name, opt):
    train, _, _ = data
    jmodel, tmodel = _models(data, name)
    node = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), tmodel, seed=4,
                      steps_per_dispatch=K)
    try:
        assignment = np.arange(300, 1100)
        w0 = (np.random.default_rng(1).normal(size=D) * 0.1).astype(np.float32)
        rows, want_delta, want_w, jstate = _jax_dispatch(
            jmodel, train, assignment, w0, jax.random.PRNGKey(4 + node.port), opt, OPT_LR[opt])
        node._prepare_async(w0, assignment, B, OPT_LR[opt], opt, 0.9)
        node._draw_ids = lambda k: torch.from_numpy(rows[:k, None, :].astype(np.int64))
        delta, state = node._dispatch(node._steps.init_state())
        got_w = node._w.numpy()
    finally:
        node.server.stop(None)
        node._master_channel.close()
    assert np.abs(want_delta).max() > 1e-4
    np.testing.assert_allclose(delta, want_delta, atol=1e-6)
    np.testing.assert_allclose(got_w, want_w, atol=1e-6)
    want_state = convert.opt_state_from_jax(jax.tree_util.tree_leaves(jstate), opt, D, "cpu")
    assert state.count == want_state.count
    for a, b in zip(state.vectors, want_state.vectors, strict=True):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_the_worker_draws_its_ids_from_its_assignment(data):
    train, _, _ = data
    node = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), _models(data)[1],
                      seed=2, steps_per_dispatch=5)
    try:
        assignment = np.arange(100, 160)
        node._prepare_async(np.zeros(D, np.float32), assignment, 8, 0.5, "", 0.9)
        first = node._draw_ids(5)
        node._prepare_async(np.zeros(D, np.float32), assignment, 8, 0.5, "", 0.9)
        again = node._draw_ids(5)  # reseeded by the StartAsync: seed + port
        with pytest.raises(ValueError, match="outside"):
            node._prepare_async(np.zeros(D, np.float32), [len(train)], 8, 0.5, "", 0.9)
        with pytest.raises(ValueError, match="optimizer"):
            node._prepare_async(np.zeros(D, np.float32), assignment, 8, 0.5, "rmsprop", 0.9)
    finally:
        node.server.stop(None)
        node._master_channel.close()
    assert first.shape == (5, 1, 8) and first.dtype == torch.int64
    assert torch.equal(first, again)
    assert set(first.flatten().tolist()) <= set(assignment.tolist())


# -- whole fits: port, JAX and mixed clusters ---------------------------------


@pytest.mark.parametrize("cluster", ["torch", "jax_master", "torch_master_jax_workers", "jax"])
def test_async_fits_land_in_the_jax_band(data, cluster):
    train, test, _ = data
    jmodel, tmodel = _models(data)
    sync_loss = _sync_loss(data)
    jax_best, jax_updates = _jax_best(data)
    assert abs(jax_best - sync_loss) <= ASYNC_TOL
    if cluster == "jax":
        assert jax_updates >= len(train) * EPOCHS
        return
    if cluster == "torch":
        with DevCluster(tmodel, _torch(train), _torch(test), n_workers=3,
                        steps_per_dispatch=K) as c:
            res = c.master.fit_async(EPOCHS, B, LR, **FAST)
            assert _async_threads() == []  # every worker's loop ended with the fit
            assert not any(w._running_async.is_set() for w in c.workers)
            assert isinstance(res.state.weights, np.ndarray)
    else:
        if cluster == "jax_master":
            master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=2).start()
            workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train),
                                  tmodel, seed=i, steps_per_dispatch=K) for i in range(2)]
        else:
            master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                                expected_workers=2).start()
            workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                                 seed=i, steps_per_dispatch=K) for i in range(2)]
        try:
            for w in workers:
                w.start(wait_registered=True)
            assert master.await_ready(30)
            res = master.fit_async(EPOCHS, B, LR, **FAST)
        finally:
            for w in workers:
                w.stop()
            master.stop()
    best = float(res.state.loss)
    assert res.state.updates >= len(train) * EPOCHS
    assert abs(best - sync_loss) <= ASYNC_TOL, (best, sync_loss)
    assert abs(best - jax_best) <= ASYNC_TOL, (best, jax_best)


def test_each_dispatch_is_one_mean_mode_launch_and_the_master_counts_steps(data, monkeypatch):
    train, test, _ = data
    calls = []
    real = tsync.sync_epoch
    monkeypatch.setattr(tsync, "sync_epoch", lambda *a, **kw: calls.append(
        (a[1].shape, kw["grad_divisor"], kw["n_total_workers"])) or real(*a, **kw))
    m = Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2,
                    steps_per_dispatch=4, metrics=m) as c:
        res = c.master.fit_async(EPOCHS, 8, 0.02, **FAST)
    # the budget counts local steps, k of them a message
    assert res.state.updates >= len(train) * EPOCHS and res.state.updates % 4 == 0
    batches = m.counter("slave.async.batch").value
    assert batches >= res.state.updates and batches % 4 == 0
    assert len(calls) == batches // 4  # one launch a dispatch
    assert set(calls) == {((4, 1, 8), 8, 1)}  # ids[k, 1, B] in the mean mode
    assert m.counter("master.async.grad.bytes").value > 0
    assert np.isfinite(np.asarray(res.state.weights)).all()


def test_the_async_fit_returns_the_best_weights(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2,
                    steps_per_dispatch=K) as c:
        res = c.master.fit_async(1, 8, 0.05, check_every=100, backoff_s=0.02)
        loss, _ = c.master.local_loss(res.state.weights, test=True)
    assert len(res.test_losses) >= 2
    assert res.state.loss == pytest.approx(min(res.test_losses), rel=1e-6)
    assert np.isfinite(loss)


# -- faults (as tests/test_async_fault_tolerance.py) --------------------------


def _hard_kill_async(worker):
    """A crash: the loop and the server go, with no unregistration."""
    worker._stopped.set()
    worker._running_async.clear()
    if worker._async_thread is not None:
        worker._async_thread.join()
    worker.server.stop(grace=0)


def _await(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _fit_in_thread(master, **kw):
    box = {}

    def run():
        try:
            box["res"] = master.fit_async(**kw)
        except Exception as e:  # noqa: BLE001 - surfaced to the test
            box["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


@pytest.mark.parametrize("how", ["kill", "leave"])
def test_one_of_three_workers_gone_mid_fit_and_the_budget_completes(data, how):
    train, test, _ = data
    max_epochs = 2
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=3,
                    steps_per_dispatch=K) as c:
        t, box = _fit_in_thread(c.master, max_epochs=max_epochs, batch_size=8,
                                learning_rate=0.02, check_every=400, backoff_s=0.02)
        _await(lambda: c.master._updates > 50, msg="first updates")
        gone = c.workers[0]
        if how == "kill":
            _hard_kill_async(gone)
        else:
            gone.stop()  # unregisters: its rows are re-issued at once
        t.join(timeout=120)
        assert not t.is_alive(), "fit_async did not end"
        assert "exc" not in box, box.get("exc")
        assert box["res"].state.updates >= len(train) * max_epochs
        if how == "leave":
            sizes = [len(w._assignment) for w in c.workers[1:]]
            assert any(s > -(-len(train) // 3) for s in sizes), sizes  # a survivor took them
        c.workers = c.workers[1:]  # stopped already


def test_all_workers_dead_raises_promptly(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2) as c:
        t, box = _fit_in_thread(c.master, max_epochs=100_000, batch_size=8,
                                learning_rate=0.02, check_every=10_000, backoff_s=0.05,
                                stall_window_s=0.5)
        _await(lambda: c.master._updates > 0, msg="first updates")
        for w in c.workers:
            _hard_kill_async(w)
        t.join(timeout=60)
        assert not t.is_alive(), "fit_async spun instead of ending"
        assert isinstance(box.get("exc"), RuntimeError)
        assert "lost" in str(box["exc"]) or "stalled" in str(box["exc"])


def test_a_stall_with_live_workers_is_mended_by_the_watchdog(data):
    # every loop stopped, every server up: the watchdog's probes all
    # answer, so it re-issues every StartAsync with the current weights
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2,
                    steps_per_dispatch=K) as c:
        t, box = _fit_in_thread(c.master, max_epochs=1, batch_size=8, learning_rate=0.02,
                                check_every=400, backoff_s=0.05, stall_window_s=0.5)
        _await(lambda: c.master._updates > 50, msg="first updates")
        for w in c.workers:
            w.stop_async()
        t.join(timeout=60)
        assert not t.is_alive()
        assert "exc" not in box, box.get("exc")
        assert box["res"].state.updates >= len(train)


def test_a_resume_past_the_budget_short_circuits(data, tmp_path):
    train, test, _ = data
    n = len(train)
    w_best = np.full(D, 4.0, np.float32)
    ckpt = Checkpointer(str(tmp_path / "ck"))
    LossChecker(1.0, checkpointer=ckpt, save_every=1).check(0.2, 0.9, w_best, step=n)
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2) as c:
        res = c.master.fit_async(1, 8, 0.1, checkpointer=Checkpointer(str(tmp_path / "ck")))
        assert res.state.updates == n
        np.testing.assert_array_equal(np.asarray(res.state.weights), w_best)
        assert not c.master._async_running.is_set()  # no worker was started
        assert all(w._async_thread is None for w in c.workers)


# -- the batch-drain inbox ---------------------------------------------------


def test_the_batch_drain_equals_the_per_message_apply(data):
    train, test, _ = data
    rng = np.random.default_rng(9)
    deltas = [(rng.normal(size=D) * 0.01).astype(np.float32) for _ in range(50)]
    m = Metrics()
    master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), _models(data)[1],
                        expected_workers=1, metrics=m)
    try:
        master._w_async, master._max_steps = torch.zeros(D), 10 ** 9
        for d in deltas:
            master._update_grad(d, n_steps=4)
        per_message = master._w_async.numpy().copy()
        master._w_async, master._updates = torch.zeros(D), 0
        master._drain_on = True
        assert all(master._inbox_put(d, 4) for d in deltas)
        assert m.gauge(metrics_mod.HEALTH_DRAIN_BACKLOG).value == len(deltas)
        master._drain_on = False
        master._drain_loop()  # drains what is buffered, then ends
        np.testing.assert_allclose(master._w_async.numpy(), per_message, atol=1e-6)
        assert master._updates == 4 * len(deltas)
        assert m.counter(metrics_mod.ASYNC_DRAINS).value == 1
        # a full inbox declines, counted, and the caller applies it itself
        master._drain_on = True
        master._inbox = [(deltas[0], 1)] * master.ASYNC_INBOX_CAP
        assert not master._inbox_put(deltas[1], 1)
        assert m.counter(metrics_mod.ASYNC_DRAIN_FALLBACK).value == 1
        master._drain_on, master._inbox = False, []
        assert not master._inbox_put(deltas[1], 1)  # off: declined, not counted
        assert m.counter(metrics_mod.ASYNC_DRAIN_FALLBACK).value == 1
    finally:
        master.server.stop(None)


def test_a_batch_drain_fit_converges(data):
    train, test, _ = data
    m = Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=3,
                    steps_per_dispatch=K, metrics=m) as c:
        res = c.master.fit_async(EPOCHS, B, LR, batch_drain=True, **FAST)
    assert m.counter(metrics_mod.ASYNC_DRAINS).value > 0
    assert res.state.updates >= len(train) * EPOCHS
    assert abs(float(res.state.loss) - _sync_loss(data)) <= ASYNC_TOL


# -- the wire and the CLI -------------------------------------------------------


def test_the_worker_serves_the_async_methods(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        w = c.workers[0]
        ch = new_channel("127.0.0.1", w.port)
        stub = WorkerStub(ch)
        try:
            with pytest.raises(grpc.RpcError) as e:  # an unknown optimizer fails the call
                stub.StartAsync(pb.StartAsyncRequest(
                    weights=codec.encode_tensor(np.zeros(D, np.float32)), samples=[0, 1],
                    batch_size=4, learning_rate=0.1, optimizer="rmsprop"), timeout=10)
            assert e.value.code() == grpc.StatusCode.UNKNOWN
            assert w._async_thread is None
            delta = np.zeros(D, np.float32)
            delta[3] = 0.25
            stub.StartAsync(pb.StartAsyncRequest(
                weights=codec.encode_tensor(np.ones(D, np.float32)), samples=[0, 1],
                batch_size=4, learning_rate=0.0, optimizer="sgd"), timeout=10)
            stub.StopAsync(pb.Empty(), timeout=10)
            assert not w._async_thread.is_alive()
            stub.UpdateGrad(codec.encode_grad(delta), timeout=10)
            got = w._w.numpy()
        finally:
            ch.close()
    want = np.ones(D, np.float32)
    want[3] = 0.75  # lr 0 moves nothing; the delta is subtracted
    np.testing.assert_array_equal(got, want)


def test_fit_async_refuses_an_optimizer_object_and_a_second_run(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        with pytest.raises(ValueError, match="by NAME"):
            c.master.fit_async(1, 8, 0.1, optimizer=object())
        with pytest.raises(ValueError):
            c.master.fit_async(1, 8, 0.1, optimizer="rmsprop")
        c.master._async_running.set()
        with pytest.raises(RuntimeError, match="already running"):
            c.master.fit_async(1, 8, 0.1)
        c.master._async_running.clear()


@pytest.mark.parametrize("drain", ["0", "1"])
def test_the_async_rpc_engine_runs_through_main(monkeypatch, drain):
    monkeypatch.setenv("DSGD_SYNTHETIC", "900")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "1")
    monkeypatch.setenv("DSGD_ENGINE", "rpc")
    monkeypatch.setenv("DSGD_ASYNC", "1")
    monkeypatch.setenv("DSGD_ASYNC_DRAIN", drain)
    monkeypatch.setenv("DSGD_NODE_COUNT", "2")
    monkeypatch.setenv("DSGD_STEPS_PER_DISPATCH", "8")
    monkeypatch.setenv("DSGD_CHECK_EVERY", "50")
    run = tmain.main(device="cpu")
    assert run.fit.state.updates >= 720 and np.isfinite(run.fit.state.loss)
    assert isinstance(run.fit.weights, np.ndarray)


def test_the_master_and_worker_roles_run_the_async_fit_through_main(monkeypatch):
    import socket

    monkeypatch.setenv("DSGD_SYNTHETIC", "900")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    common = dict(master_host="127.0.0.1", master_port=port, node_count=2, max_epochs=1,
                  use_async=True, steps_per_dispatch=8, check_every=50)
    box = {}

    def run(name, cfg):
        try:
            box[name] = tmain.main(device="cpu", cfg=cfg)
        except Exception as e:  # noqa: BLE001 - surfaced below
            box[name] = e

    threads = [threading.Thread(target=run, args=("master", Config(
        host="127.0.0.1", port=port, **common)), daemon=True)]
    for i in range(2):
        threads.append(threading.Thread(target=run, args=(f"w{i}", Config(
            host="127.0.0.1", port=0, **common)), daemon=True))
    for t in threads:
        t.start()
    threads[0].join(timeout=120)
    tmain.stop_workers()
    for t in threads[1:]:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    res = box["master"]
    assert not isinstance(res, Exception), res
    assert res.fit.state.updates >= 720 and len(res.fit.test_losses) >= 1
    for i in range(2):
        assert not isinstance(box[f"w{i}"], Exception), box[f"w{i}"]


@pytest.mark.parametrize("stopper", ["stop_async", "stop"])
def test_a_stop_that_lands_while_start_async_prepares_wins(data, stopper):
    """A StopAsync (or the node's stop) that arrives while a StartAsync is
    still preparing returns at once, and the StartAsync then starts no
    loop; a later StartAsync starts one as before."""
    train, _, _ = data
    w = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), _models(data)[1])
    entered, release = threading.Event(), threading.Event()
    prepare = w._prepare_async

    def slow_prepare(*a, **kw):
        entered.set()
        release.wait(30)
        return prepare(*a, **kw)

    w._prepare_async = slow_prepare
    args = (np.zeros(D, np.float32), np.arange(64), B, LR)
    starter = threading.Thread(target=w.start_async, args=args)
    starter.start()
    try:
        assert entered.wait(30)
        getattr(w, stopper)()
        release.set()
        starter.join(30)
        assert not starter.is_alive()
        assert w._async_thread is None and not w._running_async.is_set()
        if stopper == "stop_async":
            w._prepare_async = prepare
            w.start_async(*args)
            assert w._async_thread.is_alive() and w._running_async.is_set()
    finally:
        release.set()
        w.stop()
    assert w._async_thread is None or not w._async_thread.is_alive()
