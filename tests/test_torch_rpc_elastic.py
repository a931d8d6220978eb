"""The port's elastic membership and crash-safe fit state (core/master.py
``fit_async(elastic=True)``, the re-registration kick, ``fit_sync(
fit_state_path=, fit_state_every=)``; core/worker.py's master watch;
core/cluster.py's ``add_worker``) against the JAX package's, on the CPU
over real loopback gRPC.

Mirrors tests/test_elastic.py: a member that registers again is kicked
with a fresh StartAsync, an elastic join re-splits without stopping the
world, a finished snapshot runs nothing and an exhausted one resumes when
the budget is raised, snapshots do not change the result, a master that
crashes mid-fit and a new one that resumes from the snapshot land bit
for bit where the run through lands, and the workers of a restarted
master register again through their watch.  A snapshot crosses packages
both ways: a JAX master's resumed by the port's, and the port's by the
JAX master's, over JAX workers, equal to the JAX run through bit for
bit (both masters draw the same ids from the same generator state, sum
the same replies in send order and apply the same numpy update)."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core import master as jmaster_mod
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu_torch.checkpoint import (
    fit_state_path,
    restore_fit_state,
    save_fit_state,
)
from distributed_sgd_tpu_torch.core import master as master_mod
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

D, LAM, B, LR = 200, 1e-5, 16, 0.5
OPT_LR = {"sgd": 0.5, "adam": 0.001}
K = 8  # local steps a dispatch of the async fits


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


@pytest.fixture(scope="module")
def data():
    train, test = train_test_split(rcv1_like(1200, n_features=D, nnz=8, noise=0.0, seed=33,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _models(data, name="logistic"):
    _, _, ds = data
    return (jax_make_model(name, LAM, D, dim_sparsity=jnp.asarray(ds)),
            make_model(name, LAM, D, dim_sparsity=ds, device="cpu"))


def _cluster(data, n, **kw):
    train, test, _ = data
    return DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=n, **kw)


def _snapshot(path):
    """(epoch, window cursor, fit tokens) of a fit-state file."""
    with np.load(path) as z:
        return int(z["epoch"]), int(z["batch"]), [int(t) for t in z["fit_tokens"]]


def _await(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {msg}")


def _hard_kill_async(worker):
    """A crash, not a leave: the loop and the server go, no unregistration."""
    worker._stopped.set()
    worker._running_async.clear()
    if worker._async_thread is not None:
        worker._async_thread.join()
    worker.server.stop(grace=0)


def _fit_async_in_thread(master, **kw):
    box = {}

    def run():
        try:
            box["res"] = master.fit_async(**kw)
        except Exception as e:  # noqa: BLE001 - surfaced to the test
            box["exc"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t, box


# -- elastic membership and re-registration -----------------------------------


def test_rereg_same_endpoint_rekicks_async_loop(data):
    """A worker process restarted on the same endpoint registers while
    still a member: no membership change shows it, so the registration
    itself queues a StartAsync kick and re-introduces its peers."""
    train, _, _ = data
    with _cluster(data, 2, steps_per_dispatch=K) as c:
        t, box = _fit_async_in_thread(c.master, max_epochs=6, batch_size=8,
                                      learning_rate=0.02, check_every=1000, backoff_s=0.05)
        _await(lambda: c.master._updates > 20, msg="first updates")
        w1 = c.workers[1]
        # the restarted process: no loop, no peers, its server up
        w1.stop_async()
        _await(lambda: not w1._running_async.is_set(), msg="loop stopped")
        with w1._peers_lock:
            w1._peers.clear()
            w1._gossip.clear()
        c.master.register_worker(w1.host, w1.port)
        assert len(w1.peers) == 1, "re-registration must re-introduce the peers"
        _await(lambda: not t.is_alive() or w1._running_async.is_set(), timeout=30,
               msg="re-registered endpoint re-kicked")
        t.join(timeout=240)
        assert not t.is_alive() and "exc" not in box, box.get("exc")
        assert box["res"].state.updates >= len(train) * 6


def test_elastic_join_resplits_without_stopping_the_world(data):
    """A join alone re-splits an elastic fit: the fit starts on 2 of 3
    slots, a third worker registers mid-fit and gets an assignment."""
    train, _, _ = data
    m = mm.Metrics()
    with _cluster(data, 3, heartbeat_s=0.2, metrics=m, steps_per_dispatch=K) as c:
        gone = c.workers.pop(2)
        _hard_kill_async(gone)
        _await(lambda: (gone.host, gone.port) not in c.master.members, timeout=60,
               msg="pre-fit eviction")
        t, box = _fit_async_in_thread(c.master, max_epochs=4, batch_size=8,
                                      learning_rate=0.02, check_every=200, backoff_s=0.05,
                                      stall_checks=4, elastic=True)
        _await(lambda: c.master._updates > 20, msg="first updates")
        joined = c.add_worker(seed=77)
        _await(lambda: not t.is_alive() or joined._assignment is not None, timeout=60,
               msg="joiner received StartAsync via resplit")
        t.join(timeout=240)
        assert not t.is_alive() and "exc" not in box, box.get("exc")
        assert box["res"].state.updates >= len(train) * 4
        assert m.counter(mm.ASYNC_RESPLITS).value >= 1
        assert joined._assignment is not None, "the joiner never got an assignment"


def test_elastic_leave_and_join_complete_the_budget(data):
    """A leave and a join under elastic: two resplits, each re-issuing
    only the changed slices, and the budget completes on the new
    membership; no async loop is left."""
    train, _, _ = data
    m = mm.Metrics()
    with _cluster(data, 3, metrics=m, steps_per_dispatch=K) as c:
        t, box = _fit_async_in_thread(c.master, max_epochs=12, batch_size=8,
                                      learning_rate=0.02, check_every=2000, backoff_s=0.05,
                                      elastic=True)
        _await(lambda: c.master._updates > 200, msg="first updates")
        c.leave_worker(0)
        _await(lambda: m.counter(mm.ASYNC_RESPLITS).value >= 1, msg="the leave's resplit")
        joined = c.add_worker(seed=5)
        _await(lambda: not t.is_alive() or joined._assignment is not None, timeout=60,
               msg="the joiner's assignment")
        t.join(timeout=240)
        assert not t.is_alive() and "exc" not in box, box.get("exc")
        assert box["res"].state.updates >= len(train) * 12
        assert m.counter(mm.ASYNC_RESPLITS).value >= 2
        sizes = sorted(len(w._assignment) for w in c.workers)
        assert sum(sizes) == len(train) and sizes[-1] - sizes[0] <= 1
    assert not [x.name for x in threading.enumerate() if x.name.startswith("async-")
                and x.is_alive()]


def test_knobs_off_paths_stay_untouched(data, tmp_path):
    """Defaults engage none of this: no master watch, no heartbeat, no
    resplit, no snapshot file."""
    train, _, _ = data
    m = mm.Metrics()
    with _cluster(data, 2, metrics=m, steps_per_dispatch=K) as c:
        assert all(w._master_watch_s is None for w in c.workers)
        assert c.master._hb_thread is None
        res = c.master.fit_async(max_epochs=4, batch_size=8, learning_rate=0.02,
                                 check_every=300, backoff_s=0.05)
        c.master.fit_sync(1, B, LR)
    assert res.state.updates >= len(train) * 4
    assert m.counter(mm.ASYNC_RESPLITS).value == 0
    assert list(tmp_path.iterdir()) == []


# -- the crash-safe fit state -------------------------------------------------


def test_finished_snapshot_resumes_to_nothing_to_run(data, tmp_path):
    path = fit_state_path(str(tmp_path))
    rng = np.random.default_rng(5)
    w = rng.normal(size=D).astype(np.float32)
    save_fit_state(path, weights=w, epoch=1, batch=0, rng_state=rng.bit_generator.state,
                   test_losses_nf=[0.4, 0.5], opt_kind="sgd", opt_leaves=[], fit_tokens=[11],
                   finished=True)
    with _cluster(data, 2) as c:
        res = c.master.fit_sync(8, B, LR, grad_timeout_s=5.0, fit_state_path=path,
                                fit_state_every=1)
    assert res.epochs_run == 1
    np.testing.assert_array_equal(res.weights, w)


def test_budget_exhausted_snapshot_resumes_when_budget_raised(data, tmp_path):
    path = str(tmp_path / "fit_state.npz")
    kw = dict(grad_timeout_s=5.0, fit_state_path=path, fit_state_every=1)
    with _cluster(data, 2) as c:
        first = c.master.fit_sync(1, B, LR, **kw)
    fs = restore_fit_state(path, "sgd", [])
    assert fs.epoch == 1 and not fs.finished
    with _cluster(data, 2) as c:
        second = c.master.fit_sync(2, B, LR, **kw)
    assert second.epochs_run == 2
    assert not np.array_equal(second.weights, first.weights)


def test_fit_state_snapshot_is_pure_observation(data, tmp_path):
    with _cluster(data, 2) as c:
        plain = c.master.fit_sync(2, B, LR, grad_timeout_s=5.0)
    path = str(tmp_path / "fit_state.npz")
    with _cluster(data, 2) as c:
        snap = c.master.fit_sync(2, B, LR, grad_timeout_s=5.0, fit_state_path=path,
                                 fit_state_every=1)
    np.testing.assert_array_equal(plain.weights, snap.weights)
    fs = restore_fit_state(path, "sgd", [])
    assert (fs.epoch, fs.batch) == (2, 0) and len(fs.fit_tokens) == 1
    np.testing.assert_array_equal(fs.weights, snap.weights)


def _crashing_save(monkeypatch, module, at: int):
    """`module.save_fit_state` raises after its `at`-th snapshot: the
    master dies between two windows."""
    real = module.save_fit_state
    calls = {"n": 0}

    def crashing(*args, **kw):
        real(*args, **kw)
        calls["n"] += 1
        if calls["n"] == at:
            raise RuntimeError("injected master crash")

    monkeypatch.setattr(module, "save_fit_state", crashing)
    return real


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_master_crash_resume_is_bit_identical(data, tmp_path, monkeypatch, opt):
    kw = dict(max_epochs=3, batch_size=B, learning_rate=OPT_LR[opt], grad_timeout_s=5.0,
              optimizer=opt)
    with _cluster(data, 2) as c:
        ref = c.master.fit_sync(**kw)
    path = str(tmp_path / "fit_state.npz")
    real = _crashing_save(monkeypatch, master_mod, 3)
    with _cluster(data, 2) as c:
        with pytest.raises(RuntimeError, match="injected master crash"):
            c.master.fit_sync(fit_state_path=path, fit_state_every=7, **kw)
    monkeypatch.setattr(master_mod, "save_fit_state", real)
    epoch, batch, _ = _snapshot(path)
    assert (epoch, batch) != (3, 0) and batch > 0
    with _cluster(data, 2) as c:
        res = c.master.fit_sync(fit_state_path=path, fit_state_every=7, **kw)
    np.testing.assert_array_equal(res.weights, ref.weights)
    tokens = _snapshot(path)[2]
    assert len(tokens) == 2 and tokens[0] != tokens[1]


def test_master_restart_workers_rereg_through_watch(data):
    """The master dies and a new one binds its port: the workers' watch
    registers them with the new master, which then runs a fit."""
    train, test, _ = data
    with _cluster(data, 2, master_watch_s=0.2) as c:
        port = c.master.port
        c.master._hb_stop.set()
        c.master.server.stop(grace=0)  # a kill: no unregistration
        m2 = None
        for _ in range(50):  # the OS may free the port late
            try:
                m2 = MasterNode("127.0.0.1", port, _torch(train), _torch(test),
                                _models(data)[1], expected_workers=2, seed=0)
            except RuntimeError:
                m2 = None
            if m2 is not None and m2.server.bound_port:
                break
            if m2 is not None:
                m2.server.stop(grace=0)
            m2 = None
            time.sleep(0.2)
        assert m2 is not None, f"could not rebind master port {port}"
        m2.start()
        try:
            assert m2.await_ready(timeout=60), "the workers never registered again"
            res = m2.fit_sync(1, B, LR, grad_timeout_s=5.0)
            assert res.epochs_run == 1 and np.isfinite(res.losses[-1])
        finally:
            m2.stop()


# -- a snapshot across packages ---------------------------------------------


def _jax_cluster_master(data, master_side, port=0):
    """A master of `master_side` over 2 JAX workers on loopback."""
    train, test, _ = data
    jmodel, tmodel = _models(data)
    if master_side == "jax":
        master = JaxMaster("127.0.0.1", port, train, test, jmodel, expected_workers=2, seed=0)
    else:
        master = MasterNode("127.0.0.1", port, _torch(train), _torch(test), tmodel,
                            expected_workers=2, seed=0)
    master.start()
    devs = jax.devices()
    workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                         device=devs[i % len(devs)], seed=i) for i in range(2)]
    for w in workers:
        w.start(wait_registered=True)
    assert master.await_ready(30)
    return master, workers


def _stop(master, workers):
    for w in workers:
        w.stop()
    master.stop()


@pytest.mark.parametrize("crash_side,resume_side", [("jax", "torch"), ("torch", "jax")])
def test_a_fit_state_crosses_packages(data, tmp_path, monkeypatch, crash_side, resume_side):
    kw = dict(max_epochs=2, batch_size=B, learning_rate=LR, grad_timeout_s=5.0)
    master, workers = _jax_cluster_master(data, "jax")
    try:
        ref = master.fit_sync(**kw)
    finally:
        _stop(master, workers)
    path = str(tmp_path / "fit_state.npz")
    module = jmaster_mod if crash_side == "jax" else master_mod
    real = _crashing_save(monkeypatch, module, 2)
    master, workers = _jax_cluster_master(data, crash_side)
    try:
        with pytest.raises(RuntimeError, match="injected master crash"):
            master.fit_sync(fit_state_path=path, fit_state_every=9, **kw)
    finally:
        _stop(master, workers)
    monkeypatch.setattr(module, "save_fit_state", real)
    master, workers = _jax_cluster_master(data, resume_side)
    try:
        res = master.fit_sync(fit_state_path=path, fit_state_every=9, **kw)
    finally:
        _stop(master, workers)
    np.testing.assert_array_equal(np.asarray(res.weights), np.asarray(ref.weights))
    assert len(_snapshot(path)[2]) == 2
