"""The port's hierarchical worker host (parallel/hier.py, DSGD_HOST_DEVICES)
against the JAX package's, on the CPU.

The JAX engine groups the test process's CPU devices (tests/conftest.py);
the port's group names the CPU once a device, as a group on one card
names the card.  The in-host reply is held to the JAX engine's and to the
flat worker's within rtol 1e-5 (f32 sums in another order), a
hierarchical cluster's fit to the JAX cluster's within 1e-5, and a JAX
worker host of 2 devices registers with the port's master, whose split
weights it by its devices as the JAX master's does.  Every test has a
SIGALRM limit of its own."""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core.cluster import DevCluster as JaxCluster
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.split import strided_split as jstrided
from distributed_sgd_tpu.core.split import vanilla_split as jvanilla
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import SparseSVM as JaxSVM
from distributed_sgd_tpu.parallel.hier import HostMeshEngine as JaxHostMesh
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.split import strided_split, vanilla_split
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.host_shard import dataset_reader
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch
from distributed_sgd_tpu_torch.parallel.hier import HostMeshEngine

torch.set_num_threads(1)

LIMIT_S = 60
DIM, N = 256, 200


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


@pytest.fixture(scope="module")
def data():
    return rcv1_like(N, n_features=DIM, nnz=6, seed=0, idf_values=True)


@pytest.fixture(scope="module")
def models():
    ds = np.full(DIM, 0.01, np.float32)
    return (JaxSVM(lam=1e-4, n_features=DIM, dim_sparsity=jnp.asarray(ds)),
            convert.model_from_jax("hinge", 1e-4, DIM, ds, device="cpu"))


@pytest.mark.parametrize("n_devices", [2, 4])
def test_the_host_engine_gradient_matches_jax_and_the_flat_worker(data, models, n_devices):
    jm, tm = models
    jeng = JaxHostMesh(jm, jax.devices()[:n_devices], data)
    teng = HostMeshEngine(tm, ["cpu"] * n_devices, _torch(data))
    rng = np.random.default_rng(1)
    w = rng.normal(size=DIM).astype(np.float32)
    for size in (1, 7, 37):
        ids = rng.choice(N, size=size, replace=False)
        assert teng.pad_capacity(size) == jeng.pad_capacity(size)
        for a, b in zip(teng.pad_ids(ids), jeng.pad_ids(ids)):
            np.testing.assert_array_equal(a, b)
        got = teng.grad(w.copy(), ids)
        np.testing.assert_allclose(got, jeng.grad(w.copy(), ids), rtol=1e-5, atol=1e-6)
        # the flat worker's reply: the sum over the whole batch, regularized once
        rows = torch.from_numpy(ids.astype(np.int64))
        flat = tm.grad_regularized(
            torch.from_numpy(w), SparseBatch(torch.from_numpy(data.indices)[rows],
                                             torch.from_numpy(data.values)[rows]),
            torch.from_numpy(data.labels.astype(np.float32))[rows]).numpy()
        np.testing.assert_allclose(got, flat, rtol=1e-5, atol=1e-6)
        if size > 1:
            assert np.any(got != 0.0)


@pytest.mark.parametrize("n_devices", [2, 4])
def test_the_host_engine_window_matches_jax(data, models, n_devices):
    jm, tm = models
    jeng = JaxHostMesh(jm, jax.devices()[:n_devices], data)
    teng = HostMeshEngine(tm, ["cpu"] * n_devices, _torch(data))
    rng = np.random.default_rng(2)
    w = rng.normal(size=DIM).astype(np.float32)
    k, bs, lr = 3, 8, 0.3
    ids = rng.choice(N, size=k * bs - 5, replace=False)  # a short tail batch
    got = teng.local_window(w.copy(), ids, k, bs, lr)
    np.testing.assert_allclose(got, jeng.local_window(w.copy(), ids, k, bs, lr),
                               rtol=1e-5, atol=1e-6)
    assert np.any(got != 0.0)


def test_the_host_engine_refuses_what_jax_refuses(data, models):
    jm, tm = models
    for make, devs in ((JaxHostMesh, jax.devices()[:1]), (HostMeshEngine, ["cpu"])):
        with pytest.raises(ValueError, match=r"a host mesh needs >= 2 devices, got 1 "
                                             r"\(host_devices=1 is the flat"):
            make(jm if make is JaxHostMesh else tm, devs, data if make is JaxHostMesh
                 else _torch(data))
    with pytest.raises(ValueError, match="row_reader is incompatible with host_devices > 1"):
        WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(data), tm, data_offset=0,
                   row_reader=dataset_reader(_torch(data)), total_rows=N, host_devices=2)
    # a CPU worker's local devices are the CPU once
    with pytest.raises(ValueError, match="host_devices=2 but only 1 local device"):
        WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(data), tm, host_devices=2)


def test_a_hierarchical_cluster_matches_the_jax_clusters_fit(data, models):
    """2 hosts x 2 devices with host-local slices, as the JAX package's
    tests/test_hierarchy.py::test_hierarchical_cluster_end_to_end: both
    masters draw the same ids, so the fits agree within 1e-5; predict spans
    the slices, and the master knows the host shapes.  The fit matches a
    flat cluster's at equal global batch as the JAX test bounds it."""
    jm, tm = models
    with JaxCluster(jm, data, data, n_workers=2, host_devices=2, host_local=True) as c:
        want = c.master.fit_sync(max_epochs=3, batch_size=20, learning_rate=0.25)
    with DevCluster(tm, _torch(data), _torch(data), n_workers=4) as c:
        flat = c.master.fit_sync(max_epochs=3, batch_size=10, learning_rate=0.5)
    with DevCluster(tm, _torch(data), _torch(data), n_workers=2, host_devices=2,
                    host_local=True) as c:
        assert all(w._hier is not None and w._hier.n_devices == 2 for w in c.workers)
        assert [w.n_rows for w in c.workers] == [100, 100]  # each holds only its slice
        assert dict(c.master._worker_devices) == {k: 2 for k in c.master._worker_devices}
        assert len(c.master._worker_devices) == 2
        hier = c.master.fit_sync(max_epochs=3, batch_size=20, learning_rate=0.25)
        w_h = hier.state.weights.numpy() if torch.is_tensor(hier.state.weights) else \
            np.asarray(hier.state.weights)
        preds = c.master.predict(w_h)
        assert preds.shape == (N,)
        _, acc_local = c.master.local_loss(w_h)
        assert float((preds == data.labels).mean()) == pytest.approx(acc_local, abs=1e-6)
        backward = sum(w.metrics.counter("slave.sync.backward").value for w in c.workers)
    np.testing.assert_allclose(w_h, np.asarray(want.state.weights), atol=1e-5)
    np.testing.assert_allclose(hier.losses, want.losses, rtol=1e-5)
    assert hier.losses[-1] <= max(1.02 * flat.losses[-1], flat.losses[-1] + 0.02)
    assert backward > 0


def test_the_cli_dev_cluster_runs_hierarchical_hosts(monkeypatch):
    # DSGD_HOST_DEVICES=2 on the dev rpc engine: each in-process worker is
    # a host of two devices (the CPU twice here)
    cfg = Config(engine="rpc", node_count=2, host_devices=2, max_epochs=2)
    monkeypatch.setenv("DSGD_SYNTHETIC", "600")
    seen = []
    init = HostMeshEngine.__init__

    def spy(self, model, devices, data):
        seen.append(len(devices))
        init(self, model, devices, data)

    monkeypatch.setattr(HostMeshEngine, "__init__", spy)
    run = tmain.main(device="cpu", cfg=cfg)
    assert seen == [2, 2]
    assert run.fit.epochs_run == 2 and run.fit.test_losses[-1] < 1.0




def test_a_jax_worker_host_of_two_devices_trains_under_the_port_master(data, models):
    """A JAX WorkerNode with host_devices=2 and a flat torch worker
    register with the port's master (the parent refused the JAX host with
    UNIMPLEMENTED): the split is weighted by devices, 2:1, as the JAX
    master's over the same members, and a short fit lands within 1e-5 of
    the JAX master's over the same workers, from the same ids."""
    jm, tm = models
    devs = jax.devices()

    def fit(master_kind):
        if master_kind == "port":
            master = MasterNode("127.0.0.1", 0, _torch(data), _torch(data), tm,
                                expected_workers=2, seed=0).start()
        else:
            master = JaxMaster("127.0.0.1", 0, data, data, jm, expected_workers=2,
                               seed=0).start()
        workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, data, jm,
                             host_devices=2, devices=devs[:2], seed=0),
                   WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(data), tm,
                              seed=1)]
        try:
            for w in workers:  # host order: the split follows registration
                w.start(wait_registered=True)
            assert master.await_ready(30)
            members = master._members()
            port = master_kind == "port"
            parts = [np.asarray(p) for p in master._split_parts(
                vanilla_split if port else jvanilla, members)]
            strided = [np.asarray(p) for p in master._split_parts(
                strided_split if port else jstrided, members)]
            res = master.fit_sync(2, 10, 0.25)
        finally:
            for w in workers:
                w.stop()
            master.stop()
        w_end = res.state.weights
        return parts, strided, np.asarray(w_end.cpu() if torch.is_tensor(w_end) else w_end), res

    p_parts, p_strided, p_w, p_res = fit("port")
    j_parts, j_strided, j_w, j_res = fit("jax")
    assert [len(p) for p in p_parts] == [len(p) for p in j_parts] == [133, 67]
    for a, b in zip(p_parts, j_parts):
        np.testing.assert_array_equal(a, b)
    # a custom split is never re-weighted
    for a, b in zip(p_strided, j_strided):
        np.testing.assert_array_equal(a, b)
    assert p_res.epochs_run == j_res.epochs_run == 2
    assert np.abs(p_w).max() > 1e-2
    np.testing.assert_allclose(p_w, j_w, atol=1e-5)
    np.testing.assert_allclose(p_res.test_losses, j_res.test_losses, rtol=1e-5)
