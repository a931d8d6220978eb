"""The port's cluster telemetry plane (distributed_sgd_tpu_torch/telemetry/
aggregate.py, DSGD_TELEMETRY) against the JAX package's, on the CPU over
real loopback gRPC.

One registry content gives byte-equal snapshots in both packages, and the
merged cluster text of mixed snapshots is JAX's text.  A JAX master under
telemetry scrapes three torch workers with no error (before the port
served Metrics it counted three errors a scrape and kept no snapshot), a
port master scrapes JAX workers, and routers of either package scrape
replicas of the other.  A torch worker's health gauge is the norm of its
last reply, a hedge publishes none, and with telemetry off no ``health.*``
instrument registers.  DSGD_TELEMETRY acts through ``main`` in the master
and worker roles; DSGD_HEALTH_ACTION gives the dev rpc fit its monitor.
Each test runs under a time limit of its own (`LIMIT_S`)."""

import re
import signal
import socket
import threading
import time
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.rpc import dsgd_pb2 as jpb
from distributed_sgd_tpu.serving.router import ServingRouter as JaxRouter
from distributed_sgd_tpu.serving.server import ServingServer as JaxServingServer
from distributed_sgd_tpu.telemetry import aggregate as jagg
from distributed_sgd_tpu.utils import metrics as jmm
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import ServeStub, WorkerStub, new_channel
from distributed_sgd_tpu_torch.serving.router import ServingRouter
from distributed_sgd_tpu_torch.serving.server import ServingServer
from distributed_sgd_tpu_torch.telemetry import aggregate as tagg
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

D, LAM, B, LR, WORKERS = 200, 1e-4, 16, 0.5, 3
LIMIT_S = 90  # each test's own time limit, seconds
NORM_RTOL = 1e-6  # a gauge is the f64 norm of the reply, sent as a double


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
    train, test = train_test_split(rcv1_like(600, n_features=D, nnz=10, seed=11,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _models(data):
    _, _, ds = data
    return (jax_make_model("hinge", LAM, D, dim_sparsity=jnp.asarray(ds)),
            make_model("hinge", LAM, D, dim_sparsity=ds, device="cpu"))


def _fill(m):
    """One registry content, the same calls in either package."""
    m.counter("slave.sync.backward").increment(7)
    m.counter("master.sync.rounds").increment(3)
    m.gauge(mm.HEALTH_GRAD_NORM).set(2.5)
    m.gauge("g.never_set")  # NaN: stays off the wire
    h = m.histogram("rpc.wait")
    for v in (1e-5, 0.003, 0.7, 42.0, 1e9):
        h.record(v)
    m.histogram("h.empty")  # count 0: skipped
    return m


def _http(port: int) -> str:
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=30) as r:
        return r.read().decode()


def _health_series(text: str) -> dict:
    return {lab: float(v) for lab, v in
            re.findall(r'health_grad_norm\{role="worker",worker="([^"]+)"\} (\S+)', text)}


# -- the wire and the merge -----------------------------------------------------


def test_the_bucket_bounds_and_names_are_the_jax_ones():
    # cross-package bucket sums are exact only over one tuple of bounds
    assert mm.Histogram.BUCKET_BOUNDS == jmm.Histogram.BUCKET_BOUNDS
    for name in ("TELEMETRY_SCRAPES", "TELEMETRY_SCRAPE_ERRORS", "TELEMETRY_SCRAPE_SKIPPED",
                 "TELEMETRY_WORKERS", "HEALTH_GRAD_NORM", "HEALTH_STALENESS",
                 "HEALTH_EF_RESIDUAL_NORM"):
        assert getattr(mm, name) == getattr(jmm, name), name


def test_snapshots_are_byte_equal_across_packages():
    got = tagg.snapshot_metrics(_fill(mm.Metrics()), "worker", "127.0.0.1:7")
    want = jagg.snapshot_metrics(_fill(jmm.Metrics()), "worker", "127.0.0.1:7")
    assert got.SerializeToString() == want.SerializeToString()
    assert {g.name for g in got.gauges} == {mm.HEALTH_GRAD_NORM}
    assert [h.name for h in got.hists] == ["rpc.wait"]


def test_the_cluster_text_is_the_jax_text_on_mixed_snapshots():
    a, b = mm.Metrics(), jmm.Metrics()
    _fill(a)
    _fill(b)
    b.counter("slave.sync.backward").increment(5)
    b.gauge(mm.HEALTH_GRAD_NORM).set(1.25)
    b.histogram("rpc.wait").record(0.5)
    snaps = [tagg.snapshot_metrics(a, "worker", 'torch:"1"'),
             jagg.snapshot_metrics(b, "worker", "jax:2"),
             tagg.snapshot_metrics(mm.Metrics(), "master", "master")]
    wire = [s.SerializeToString() for s in snaps]
    got = tagg.cluster_prometheus_text([pb.MetricsSnapshot.FromString(w) for w in wire])
    want = jagg.cluster_prometheus_text([jpb.MetricsSnapshot.FromString(w) for w in wire])
    assert got == want
    assert 'slave_sync_backward_total{role="cluster"} 19' in got
    assert 'worker="torch:\\"1\\""' in got  # the label escaping


def test_the_store_replaces_and_drops_as_the_jax_store():
    got, want = (tagg.ClusterTelemetry(mm.Metrics()), jagg.ClusterTelemetry(jmm.Metrics()))
    for tel, mod, reg in ((got, tagg, mm.Metrics), (want, jagg, jmm.Metrics)):
        w0, w1 = reg(), reg()
        w0.counter("slave.sync.backward").increment(3)
        w1.counter("slave.sync.backward").increment(5)
        tel.observe(("h", 1), mod.snapshot_metrics(w0, "worker", "h:1"))
        tel.observe(("h", 2), mod.snapshot_metrics(w1, "worker", "h:2"))
        tel.observe(("h", 1), mod.snapshot_metrics(w0, "worker", "h:1"))  # idempotent
        tel.drop(("h", 2))
    assert got.prometheus_text() == want.prometheus_text()
    assert 'slave_sync_backward_total{role="cluster"} 3' in got.prometheus_text()
    assert got.metrics.gauge(mm.TELEMETRY_WORKERS).value == 1.0


# -- mixed clusters ---------------------------------------------------------------


def _fit_and_scrape(master, workers, scrape):
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        fit = master.fit_sync(1, B, LR, grad_timeout_s=15.0)
        got = scrape()
        members = set(master._workers)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    assert members == {(w.host, w.port) for w in workers}, "a worker was evicted"
    return fit, got


def test_a_jax_master_under_telemetry_scrapes_three_torch_workers(data):
    """Fails before the port served Metrics: each scrape counted 3 errors
    and kept no snapshot of a torch worker."""
    train, test, _ = data
    jmodel, tmodel = _models(data)
    master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=WORKERS,
                       seed=0, metrics=jmm.Metrics()).start()
    master.enable_telemetry(port=None)
    workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train), tmodel,
                          seed=i, metrics=mm.Metrics(), telemetry=True) for i in range(WORKERS)]
    fit, (n, text) = _fit_and_scrape(
        master, workers, lambda: (master.scrape_telemetry(), master.telemetry.prometheus_text()))
    assert fit.epochs_run == 1
    assert n == WORKERS
    assert master.metrics.counter(jmm.TELEMETRY_SCRAPE_ERRORS).value == 0
    series = _health_series(text)
    assert set(series) == {w.node_label for w in workers}
    for w in workers:
        assert series[w.node_label] == w.metrics.gauge(mm.HEALTH_GRAD_NORM).value > 0
    backward = sum(w.metrics.counter("slave.sync.backward").value for w in workers)
    assert f'slave_sync_backward_total{{role="cluster"}} {backward}' in text


def test_a_port_master_scrapes_jax_workers_over_its_endpoint(data):
    train, test, _ = data
    jmodel, tmodel = _models(data)
    master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                        expected_workers=WORKERS, seed=0, metrics=mm.Metrics()).start()
    tel = master.enable_telemetry(port=0)
    workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel, seed=i,
                         metrics=jmm.Metrics(), telemetry=True) for i in range(WORKERS)]
    fit, (text, held) = _fit_and_scrape(master, workers, lambda: (
        _http(master.telemetry_exporter.port),
        master.metrics.gauge(mm.TELEMETRY_WORKERS).value))
    assert tel is master.telemetry and fit.epochs_run == 1
    assert master.metrics.counter(mm.TELEMETRY_SCRAPE_ERRORS).value == 0
    assert held == WORKERS
    # the workers left with the stop, and their snapshots with them
    assert master.metrics.gauge(mm.TELEMETRY_WORKERS).value == 0
    series = _health_series(text)
    assert set(series) == {f"{w.host}:{w.port}" for w in workers}
    assert 'master_sync_rounds_total{role="master",worker="master"}' in text


def test_a_departed_worker_leaves_the_port_masters_view(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2,
                    telemetry_port=0) as c:
        for w in c.workers:
            w.metrics.counter("slave.sync.backward").increment()
        assert c.master.scrape_telemetry() == 2
        c.leave_worker(1)
        deadline = time.monotonic() + 10
        while len(c.master.members) > 1 and time.monotonic() < deadline:
            time.sleep(0.02)
        text = _http(c.master.telemetry_exporter.port)
        assert c.master.metrics.gauge(mm.TELEMETRY_WORKERS).value == 1.0
        assert set(re.findall(r'role="worker",worker="([^"]+)"', text)) == {
            c.workers[0].node_label}


def _replicas(pkg, path, n=2):
    w = (np.random.default_rng(3).normal(size=D) * 0.3).astype(np.float32)
    if pkg == "port":
        from distributed_sgd_tpu_torch.checkpoint import Checkpointer

        Checkpointer(str(path)).save(1, w)
        return [ServingServer(str(path), port=0, host="127.0.0.1", ckpt_poll_s=30.0,
                              metrics=mm.Metrics(), device="cpu").start() for _ in range(n)]
    from distributed_sgd_tpu.checkpoint import Checkpointer as JaxCheckpointer

    ck = JaxCheckpointer(str(path))
    ck.save(1, w)
    ck.close()
    return [JaxServingServer(str(path), port=0, host="127.0.0.1", ckpt_poll_s=30.0,
                             metrics=jmm.Metrics()).start() for _ in range(n)]


@pytest.mark.parametrize("router_pkg", ["jax", "port"])
def test_a_router_scrapes_the_other_packages_replicas(router_pkg, tmp_path):
    """A JAX router's fleet endpoint over port replicas (each scrape of a
    port replica was an error before), and a port router's over JAX ones."""
    reps = _replicas("port" if router_pkg == "jax" else "jax", tmp_path)
    cls, reg = (JaxRouter, jmm.Metrics) if router_pkg == "jax" else (ServingRouter, mm.Metrics)
    router = cls([("127.0.0.1", r.bound_port) for r in reps], port=0, host="127.0.0.1",
                 health_s=0.2, metrics=reg(), telemetry_port=0).start()
    try:
        ch = new_channel("127.0.0.1", router.bound_port)
        for _ in range(3):  # a few Predicts so every replica has series
            ServeStub(ch).Predict(pb.PredictRequest(indices=[1, 5], values=[1.0, 2.0]),
                                  timeout=10)
        snap = ServeStub(ch).Metrics(pb.Empty(), timeout=10)
        ch.close()
        text = _http(router.telemetry_exporter.port)
        errors = router.metrics.counter(mm.TELEMETRY_SCRAPE_ERRORS).value
    finally:
        router.stop()
        for r in reps:
            r.stop()
    assert snap.role == "route" and snap.node == f"route:{router.bound_port}"
    assert errors == 0
    labels = set(re.findall(r'role="serve",worker="([^"]+)"', text))
    assert len(labels) == 2, labels
    assert re.search(r'serve_predict_duration_count\{role="cluster"\} 3\b', text), text


# -- the worker's health gauges and the knobs-off path ------------------------------


def test_a_reply_publishes_its_norm_and_a_hedge_does_not(data):
    train, test, _ = data
    w0 = (np.random.default_rng(3).normal(size=D) * 0.1).astype(np.float32)
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1,
                    telemetry_port=0) as c:
        w = c.workers[0]
        ch = new_channel("127.0.0.1", w.port)
        stub = WorkerStub(ch)
        gauge = w.metrics.gauge(mm.HEALTH_GRAD_NORM)
        got = codec.decode_grad(stub.Gradient(pb.GradientRequest(
            samples=[0, 1, 5], weights=codec.encode_tensor(w0)), timeout=10))
        norm = gauge.value
        stub.Gradient(pb.GradientRequest(samples=[7, 9], weights=codec.encode_tensor(w0),
                                         hedge=True), timeout=10)
        after_hedge = gauge.value
        stub.Gradient(pb.GradientRequest(samples=[2], weights=codec.encode_tensor(w0)),
                      timeout=10)
        staleness = w.metrics.gauge(mm.HEALTH_STALENESS).value
        snap = stub.Metrics(pb.Empty(), timeout=10)
        ch.close()
    np.testing.assert_allclose(norm, np.linalg.norm(got), rtol=NORM_RTOL)
    assert after_hedge == norm
    assert staleness > 0
    assert snap.role == "worker" and snap.node == w.node_label
    assert {g.name for g in snap.gauges} >= {mm.HEALTH_GRAD_NORM, mm.HEALTH_STALENESS}


def test_an_async_dispatch_publishes_the_gauges(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2,
                    telemetry_port=0) as c:
        c.master.fit_async(1, B, LR, check_every=200)
        gauges = [(w.metrics.gauge(mm.HEALTH_GRAD_NORM).value,
                   w.metrics.gauge(mm.HEALTH_STALENESS).value) for w in c.workers]
    # set by every dispatch (a hinge dispatch's delta may be exactly 0)
    for norm, gap in gauges:
        assert np.isfinite(norm) and norm >= 0 and gap > 0, gauges


def test_knobs_off_registers_no_health_instrument_and_scrapes_nothing(data, monkeypatch):
    train, test, _ = data
    calls = []
    real = tagg.ClusterTelemetry.scrape
    monkeypatch.setattr(tagg.ClusterTelemetry, "scrape",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2, metrics=m,
                    heartbeat_s=0.1) as c:
        assert c.master.telemetry is None and not any(w.telemetry for w in c.workers)
        c.master.fit_sync(1, B, LR)
        assert c.master.scrape_telemetry() == 0
    names = [g.name for g in m.gauges()] + [x.name for x in m.counters()]
    assert not [n for n in names if n.startswith("health.") or "telemetry" in n]
    assert not calls


# -- the CLI ---------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_telemetry_acts_through_main_in_the_master_and_worker_roles(monkeypatch):
    monkeypatch.setenv("DSGD_SYNTHETIC", "900")
    enabled, health = [], []
    real_enable, real_health = MasterNode.enable_telemetry, WorkerNode.record_health

    def enable(self, port=None, **kw):
        out = real_enable(self, port, **kw)
        enabled.append((port, self.telemetry_exporter.port))
        return out

    def record(self, g):
        health.append(self.node_label)
        return real_health(self, g)

    monkeypatch.setattr(MasterNode, "enable_telemetry", enable)
    monkeypatch.setattr(WorkerNode, "record_health", record)
    port, tport = _free_port(), _free_port()
    common = dict(master_host="127.0.0.1", master_port=port, node_count=2, max_epochs=1,
                  telemetry=True, telemetry_port=tport, heartbeat_s=0.2)
    box = {}

    def run(name, cfg):
        try:
            box[name] = tmain.main(device="cpu", cfg=cfg)
        except Exception as e:  # noqa: BLE001 - surfaced below
            box[name] = e

    threads = [threading.Thread(target=run, args=("master", Config(host="127.0.0.1",
                                                                    port=port, **common)),
                                daemon=True)]
    for i in range(2):
        threads.append(threading.Thread(target=run, args=(f"w{i}", Config(
            host="127.0.0.1", port=0, **common)), daemon=True))
    for t in threads:
        t.start()
    threads[0].join(timeout=60)
    tmain.stop_workers()
    for t in threads[1:]:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    for name in ("master", "w0", "w1"):
        assert not isinstance(box[name], Exception), box[name]
    assert enabled == [(tport, tport)]
    assert len(set(health)) == 2


def test_telemetry_acts_on_the_dev_rpc_cluster(monkeypatch):
    seen = []
    real = DevCluster.__init__

    def spy(self, *a, **kw):
        seen.append(kw.get("telemetry_port"))
        real(self, *a, **kw)

    monkeypatch.setattr(DevCluster, "__init__", spy)
    for k, v in {"DSGD_ENGINE": "rpc", "DSGD_SYNTHETIC": "600", "DSGD_MAX_EPOCHS": "1",
                 "DSGD_NODE_COUNT": "2", "DSGD_TELEMETRY": "1",
                 "DSGD_TELEMETRY_PORT": "0"}.items():
        monkeypatch.setenv(k, v)
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 1 and seen == [0]


def test_the_health_action_still_raises_before_any_data_loads(monkeypatch):
    # the health action is acted on now (tests/test_torch_health.py): the
    # dev rpc fit gets its monitor, and a bad value is refused as JAX does
    seen = []
    real = MasterNode.fit_sync

    def fit_sync(self, *a, **kw):
        seen.append(kw.get("health"))
        return real(self, *a, **kw)

    monkeypatch.setattr(MasterNode, "fit_sync", fit_sync)
    for k, v in {"DSGD_ENGINE": "rpc", "DSGD_SYNTHETIC": "600", "DSGD_MAX_EPOCHS": "1",
                 "DSGD_NODE_COUNT": "2", "DSGD_HEALTH_ACTION": "warn",
                 "DSGD_TELEMETRY": "1", "DSGD_TELEMETRY_PORT": "0"}.items():
        monkeypatch.setenv(k, v)
    assert tmain.main(device="cpu").fit.epochs_run == 1
    assert len(seen) == 1 and seen[0].action == "warn"
    with pytest.raises(ValueError, match="DSGD_HEALTH_ACTION"):
        Config(health_action="page")
    with pytest.raises(ValueError, match="telemetry_port"):
        Config(telemetry=True, telemetry_port=-1)
