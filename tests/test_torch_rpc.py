"""The port's RPC engine (distributed_sgd_tpu_torch/rpc, core/worker.py,
core/master.py, core/cluster.py) against the JAX package's, on the CPU
over real loopback gRPC.

The wire is the JAX package's byte for byte: the codec gives the same
bytes and the descriptor is the same, so a JAX master drives torch workers
and a torch master drives JAX workers.  The sync fit of a port cluster,
and of both mixed clusters, lands within rtol 1e-5 (test losses) and atol
1e-5 (weights) of a JAX cluster's on the same numpy data and seed, for
sgd, momentum and adam: both masters draw the same sample ids from the
same numpy generator, sum the replies in send order and apply the same
update."""

import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.checkpoint import Checkpointer as JaxCheckpointer
from distributed_sgd_tpu.core.cluster import DevCluster as JaxCluster
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.rpc import codec as jcodec
from distributed_sgd_tpu.rpc import dsgd_pb2 as jpb
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import MasterStub, WorkerStub, new_channel

torch.set_num_threads(1)

D, LAM, B, EPOCHS, WORKERS = 300, 1e-4, 40, 2, 3
OPT_LR = {"sgd": 0.5, "momentum": 0.05, "adam": 0.001}


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


@pytest.fixture(scope="module")
def data():
    train, test = train_test_split(rcv1_like(2400, n_features=D, nnz=12, seed=3,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _models(data, name="hinge"):
    train, _, ds = data
    return (jax_make_model(name, LAM, D, dim_sparsity=jnp.asarray(ds)),
            make_model(name, LAM, D, dim_sparsity=ds, device="cpu"))


def _fit(master, opt):
    return master.fit_sync(EPOCHS, B, OPT_LR[opt], optimizer=opt)


_reference = {}


def _jax_reference(data, opt):
    """The JAX DevCluster's fit, computed once per optimizer."""
    if opt not in _reference:
        train, test, _ = data
        with JaxCluster(_models(data)[0], train, test, n_workers=WORKERS, seed=0) as c:
            _reference[opt] = _fit(c.master, opt)
    return _reference[opt]


def _assert_same_fit(got, want):
    assert got.epochs_run == want.epochs_run == EPOCHS
    np.testing.assert_allclose(got.test_losses, want.test_losses, rtol=1e-5)
    np.testing.assert_allclose(got.losses, want.losses, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.weights), np.asarray(want.weights), atol=1e-5)


# -- the wire --------------------------------------------------------------


def test_the_descriptor_is_the_jax_packages_and_shares_its_classes():
    assert pb.DESCRIPTOR.serialized_pb == jpb.DESCRIPTOR.serialized_pb
    assert pb.GradUpdate is jpb.GradUpdate and pb.PredictRequest is jpb.PredictRequest


@pytest.mark.parametrize("kind", ["dense", "sparse", "empty", "tensor"])
def test_codec_gives_the_jax_bytes(kind):
    rng = np.random.default_rng(5)
    x = rng.normal(size=1000).astype(np.float32)
    if kind == "sparse":
        x[rng.random(1000) > 0.1] = 0.0
    if kind == "empty":
        x[:] = 0.0
    if kind == "tensor":
        got, want = codec.encode_tensor(x), jcodec.encode_tensor(x)
        np.testing.assert_array_equal(codec.decode_tensor(want), x)
    else:
        got, want = codec.encode_grad(x), jcodec.encode_grad(x)
        np.testing.assert_array_equal(codec.decode_grad(want), x)
        np.testing.assert_array_equal(jcodec.decode_grad(got), x)
        assert got.WhichOneof("grad") == ("dense" if kind == "dense" else "sparse")
    assert got.SerializeToString() == want.SerializeToString()


# -- membership ------------------------------------------------------------


def test_cluster_forms_and_is_ready(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=3) as c:
        assert c.master.cluster_ready.is_set()
        assert len(c.master.members) == 3
        for w in c.workers:  # full-mesh introduction
            assert len(w.peers) == 2


def test_register_beyond_capacity_is_refused(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2) as c:
        ch = new_channel("127.0.0.1", c.master.port)
        with pytest.raises(grpc.RpcError) as e:
            MasterStub(ch).RegisterSlave(pb.Node(host="127.0.0.1", port=59999), timeout=5.0)
        ch.close()
        assert e.value.code() == grpc.StatusCode.FAILED_PRECONDITION


def test_unregister_is_broadcast(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=3) as c:
        gone = c.workers[0]
        gone.stop()
        deadline = time.time() + 5
        while time.time() < deadline and any(
                (gone.host, gone.port) in w.peers for w in c.workers[1:]):
            time.sleep(0.05)
        for w in c.workers[1:]:
            assert (gone.host, gone.port) not in w.peers
        assert (gone.host, gone.port) not in c.master.members
        c.workers = c.workers[1:]  # don't stop it twice


# -- the sync fit against the JAX package's -------------------------------


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
def test_port_cluster_fit_matches_the_jax_cluster(data, opt):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS,
                    seed=0) as c:
        got = _fit(c.master, opt)
    _assert_same_fit(got, _jax_reference(data, opt))


@pytest.mark.parametrize("opt", ["sgd", "momentum", "adam"])
@pytest.mark.parametrize("master_side", ["jax", "torch"])
def test_mixed_cluster_fit_matches_the_jax_cluster(data, master_side, opt):
    train, test, _ = data
    jmodel, tmodel = _models(data)
    if master_side == "jax":
        master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=WORKERS,
                           seed=0).start()
        workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train),
                              tmodel, seed=i) for i in range(WORKERS)]
    else:
        master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                            expected_workers=WORKERS, seed=0).start()
        devs = jax.devices()
        workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                             device=devs[i % len(devs)], seed=i) for i in range(WORKERS)]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        got = _fit(master, opt)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    _assert_same_fit(got, _jax_reference(data, opt))


@pytest.mark.parametrize("name", ["hinge", "logistic", "least_squares"])
def test_distributed_eval_matches_the_jax_master(data, name):
    train, test, _ = data
    jmodel, tmodel = _models(data, name)
    w = np.random.default_rng(7).normal(size=D).astype(np.float32) * 0.3
    with DevCluster(tmodel, _torch(train), _torch(test), n_workers=2) as c:
        loss, acc = c.master.distributed_loss(w), c.master.distributed_accuracy(w)
        local = c.master.local_loss(w)
        preds, margins = c.master.predict(w, return_margins=True)
    with JaxCluster(jmodel, train, test, n_workers=2) as c:
        jloss, jacc = c.master.distributed_loss(w), c.master.distributed_accuracy(w)
        jpreds, jmargins = c.master.predict(w, return_margins=True)
    assert loss == pytest.approx(jloss, rel=1e-5)
    assert acc == jacc
    assert loss == pytest.approx(local[0], rel=1e-4) and acc == pytest.approx(local[1])
    np.testing.assert_allclose(preds, jpreds, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(margins, jmargins, rtol=1e-5, atol=1e-6)


def test_the_worker_gradient_is_worker_grads_plus_the_regularizer(data):
    """The Gradient body is ops.worker_grads at K=1 (its plain version on
    the CPU) and `regularize`, against the JAX model's grad_regularized."""
    train, _, ds = data
    jmodel, tmodel = _models(data)
    w = np.random.default_rng(2).normal(size=D).astype(np.float32) * 0.1
    ids = np.random.default_rng(3).choice(len(train), 64, replace=False)
    from distributed_sgd_tpu.ops.sparse import SparseBatch as JBatch

    want = np.asarray(jmodel.grad_regularized(
        jnp.asarray(w), JBatch(jnp.asarray(train.indices[ids]), jnp.asarray(train.values[ids])),
        jnp.asarray(train.labels[ids].astype(np.float32))))
    node = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), tmodel)
    try:
        before = wg.worker_grads.launches
        got = node.compute_gradient(w, ids)
        assert wg.worker_grads.launches == before  # the CPU runs the plain version
    finally:
        node.server.stop(None)
        node._master_channel.close()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert np.array_equal(got == 0, want == 0)


# -- what the worker does not serve yet -------------------------------------


@pytest.mark.parametrize("field", ["shard_count", "agg_parent", "Metrics", "AggregateGrad"])
def test_unserved_requests_answer_unimplemented_with_their_roadmap_item(data, field):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        w = c.workers[0]
        ch = new_channel("127.0.0.1", w.port)
        stub = WorkerStub(ch)
        req = pb.GradientRequest(samples=[0, 1], weights=codec.encode_tensor(np.zeros(D)))
        call = stub.Gradient
        if field == "shard_count":
            req.shard_count = 2
        elif field == "agg_parent":
            req.agg_parent = "127.0.0.1:1"
        elif field == "Metrics":
            call, req = stub.Metrics, pb.Empty()
        else:
            call, req = stub.AggregateGrad, pb.AggGrad()
        with pytest.raises(grpc.RpcError) as e:
            call(req, timeout=10)
        ch.close()
    assert e.value.code() == grpc.StatusCode.UNIMPLEMENTED
    assert "ROADMAP.md Queue A" in e.value.details()


@pytest.mark.parametrize("field", ["hedge", "ef_rollback_version"])
def test_the_worker_serves_the_quorum_barriers_requests(data, field):
    """A JAX master under a quorum sends `hedge` to a donor (the plain
    body on another worker's ids, counted) and `ef_rollback_version` to
    a straggler (a no-op: the port's worker keeps no residual): both
    reply the gradient the plain request gets."""
    train, test, _ = data
    w = np.random.default_rng(6).normal(size=D).astype(np.float32) * 0.1
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        ch = new_channel("127.0.0.1", c.workers[0].port)
        stub = WorkerStub(ch)
        plain = pb.GradientRequest(samples=[0, 1, 5], weights=codec.encode_tensor(w),
                                   fit_token=7, step_version=3)
        req = pb.GradientRequest()
        req.CopyFrom(plain)
        setattr(req, field, True if field == "hedge" else 2)
        before = c.workers[0].metrics.counter("slave.sync.hedge").value
        got, want = stub.Gradient(req, timeout=10), stub.Gradient(plain, timeout=10)
        hedges = c.workers[0].metrics.counter("slave.sync.hedge").value - before
        replica = c.workers[0]._replica
        ch.close()
    np.testing.assert_array_equal(codec.decode_grad(got), codec.decode_grad(want))
    assert hedges == (1 if field == "hedge" else 0)
    assert replica[:2] == (7, 3)  # the install arm: (fit_token, step_version)


@pytest.mark.parametrize("kw", [
    {"agg_tree": "fanout:2"}, {"master_shards": 2}, {"health": object()}],
    ids=lambda kw: "+".join(kw))
def test_fit_sync_levers_not_ported_raise(data, kw):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A"):
            c.master.fit_sync(1, B, 0.5, **kw)


@pytest.mark.parametrize("kw", [
    {"quorum": 1}, {"straggler_soft_s": 1.0}, {"fit_state_path": "fit_state.npz"}],
    ids=lambda kw: next(iter(kw)))
def test_fit_sync_fault_tolerance_levers_run(data, kw, tmp_path):
    """Each of them once refused: a quorum of 1 over 1 worker, a soft
    deadline that only observes, and a fit-state path (with snapshots)
    give the plain fit's weights bit for bit."""
    train, test, _ = data
    if "fit_state_path" in kw:
        kw = {"fit_state_path": str(tmp_path / kw["fit_state_path"]), "fit_state_every": 5}
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        plain = c.master.fit_sync(1, B, 0.5)
        got = c.master.fit_sync(1, B, 0.5, **kw)
    np.testing.assert_array_equal(got.weights, plain.weights)
    if "fit_state_path" in kw:
        with np.load(kw["fit_state_path"]) as z:
            assert (int(z["epoch"]), int(z["batch"])) == (1, 0)
    with pytest.raises(ValueError):
        MasterNode.fit_sync(c.master, 1, B, 0.5, quorum=0)


# -- fault tolerance (as tests/test_fault_tolerance.py) ---------------------


def _hard_kill(worker):
    """A crash: the gRPC server goes with no unregistration."""
    worker._stopped.set()
    worker.server.stop(grace=0)


def _fit_with_midfit_kill(cluster, **kw):
    gone = cluster.workers[0]
    first_call = threading.Event()
    orig = gone.compute_gradient

    def traced(w, ids):
        first_call.set()
        return orig(w, ids)

    gone.compute_gradient = traced
    box = {}

    def run():
        try:
            box["result"] = cluster.master.fit_sync(**kw)
        except Exception as e:  # noqa: BLE001 - surfaced to the test
            box["error"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()
    assert first_call.wait(30), "the fit never reached a worker"
    _hard_kill(gone)
    t.join(timeout=120)
    return box, not t.is_alive()


@pytest.mark.parametrize("mode", ["resplit", "fail", "all_lost"])
def test_sync_fit_on_worker_death(data, mode):
    train, test, _ = data
    n = {"resplit": 3, "fail": 2, "all_lost": 1}[mode]
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=n) as c:
        box, joined = _fit_with_midfit_kill(
            c, max_epochs=3, batch_size=16, learning_rate=0.5, grad_timeout_s=5.0,
            on_worker_death="fail" if mode == "fail" else "resplit")
        assert joined, "fit_sync hung after a worker died"
        if mode == "resplit":
            assert "error" not in box, box.get("error")
            res = box["result"]
            assert res.epochs_run == 3 and res.losses[-1] < res.losses[0]
            assert len(c.master.members) == 2
        elif mode == "fail":
            assert isinstance(box.get("error"), RuntimeError)
            assert len(c.master.members) == 2  # membership untouched
        else:
            assert isinstance(box.get("error"), RuntimeError)
            assert "all workers lost" in str(box["error"])


def test_predict_survives_worker_death(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=3) as c:
        _hard_kill(c.workers[0])
        preds = c.master.predict(np.zeros(D, np.float32), timeout_s=5.0)
        assert preds.shape == (len(train),)
        assert len(c.master.members) == 2


# -- checkpoints (as tests/test_control_plane.py) ---------------------------


def test_rpc_fit_resumes_from_its_checkpoint(data, tmp_path):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2) as c:
        through = c.master.fit_sync(3, 16, 0.5)
        c.master.fit_sync(1, 16, 0.5, checkpointer=Checkpointer(str(tmp_path)))
        ck = Checkpointer(str(tmp_path))
        assert ck.latest_step() == 1
        resumed = c.master.fit_sync(3, 16, 0.5, checkpointer=ck)
        assert resumed.epochs_run == 3 and len(resumed.losses) == 2
        assert ck.latest_step() == 3
        # nothing left to run: zero epochs, the restored weights' loss
        again = c.master.fit_sync(3, 16, 0.5, checkpointer=Checkpointer(str(tmp_path)))
        assert again.epochs_run == 3 and np.isfinite(again.state.loss)
    np.testing.assert_array_equal(resumed.weights, through.weights)
    np.testing.assert_allclose(resumed.test_losses, through.test_losses[1:], rtol=1e-6)


def test_rpc_momentum_snapshot_keeps_its_state_and_refuses_another_optimizer(data, tmp_path):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2) as c:
        c.master.fit_sync(1, 16, 0.05, optimizer="momentum",
                          checkpointer=Checkpointer(str(tmp_path)))
        _, state = Checkpointer(str(tmp_path)).restore_latest()
        assert "opt_0" in state and np.shape(state["opt_0"]) == (D,)
        with pytest.raises(ValueError, match="optimizer"):
            c.master.fit_sync(2, 16, 0.05, optimizer="adam",
                              checkpointer=Checkpointer(str(tmp_path)))


def test_rpc_snapshot_resumes_in_the_sync_trainer_and_the_jax_master(data, tmp_path):
    train, test, ds = data
    jmodel, tmodel = _models(data)
    with DevCluster(tmodel, _torch(train), _torch(test), n_workers=2) as c:
        c.master.fit_sync(1, 16, 0.5, checkpointer=Checkpointer(str(tmp_path / "a")))
        c.master.fit_sync(1, 16, 0.5, checkpointer=JaxCheckpointer(str(tmp_path / "b")))
    res = SyncTrainer(tmodel, batch_size=16, learning_rate=0.5, device="cpu",
                      checkpointer=Checkpointer(str(tmp_path / "a"))).fit(
        _torch(train), _torch(test), 2)
    assert res.epochs_run == 2 and len(res.losses) == 1 and np.isfinite(res.state.loss)
    with JaxCluster(jmodel, train, test, n_workers=2) as c:
        jres = c.master.fit_sync(2, 16, 0.5, checkpointer=JaxCheckpointer(str(tmp_path / "b")))
    assert jres.epochs_run == 2 and len(jres.losses) == 1


# -- the CLI's rpc engine and roles -----------------------------------------


def test_the_rpc_engine_runs_through_main(monkeypatch):
    monkeypatch.setenv("DSGD_SYNTHETIC", "900")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "1")
    monkeypatch.setenv("DSGD_ENGINE", "rpc")
    monkeypatch.setenv("DSGD_NODE_COUNT", "2")
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 1 and run.fit.test_losses[0] < 1.0
    assert isinstance(run.fit.weights, np.ndarray)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_the_master_and_worker_roles_run_through_main(monkeypatch):
    monkeypatch.setenv("DSGD_SYNTHETIC", "900")
    port = _free_port()
    common = dict(master_host="127.0.0.1", master_port=port, node_count=2, max_epochs=2)
    master_cfg = Config(host="127.0.0.1", port=port, **common)
    assert master_cfg.role == "master"
    box = {}

    def run(name, cfg):
        try:
            box[name] = tmain.main(device="cpu", cfg=cfg)
        except Exception as e:  # noqa: BLE001 - surfaced below
            box[name] = e

    threads = [threading.Thread(target=run, args=("master", master_cfg), daemon=True)]
    for i in range(2):
        cfg = Config(host="127.0.0.1", port=0, **common)
        assert cfg.role == "worker"
        threads.append(threading.Thread(target=run, args=(f"w{i}", cfg), daemon=True))
    for t in threads:
        t.start()
    threads[0].join(timeout=120)
    tmain.stop_workers()
    for t in threads[1:]:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    res = box["master"]
    assert not isinstance(res, Exception), res
    assert res.fit.epochs_run == 2 and res.fit.test_losses[-1] < 1.0
    for i in range(2):
        assert not isinstance(box[f"w{i}"], Exception), box[f"w{i}"]
        assert box[f"w{i}"].fit is None
