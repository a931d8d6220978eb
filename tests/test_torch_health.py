"""The port's training-health monitor (telemetry/health.py,
DSGD_HEALTH_ACTION) against the JAX package's, on the CPU.

``HealthMonitor`` against JAX's on the same loss and gradient-norm
sequences (the trip's point and reason, the EWMA gauge, the latch);
``fit_sync(health=)`` over port and JAX clusters whose worker 0 replies
NaN in one window: 'warn' drops that round and lands where JAX lands,
'snapshot' writes the fit state at the window the trip interrupted and
changes nothing else, 'halt' stops there, and a restart resumes from the
snapshot to JAX's weights; the leak sentinel's trip routed to
``trip_external`` as JAX routes it; and the knob through the CLI's master
role and dev rpc cluster.  Each test runs under a time limit of its own
(`LIMIT_S`)."""

import glob
import json
import math
import os
import signal
import socket
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.checkpoint import restore_fit_state as jax_restore_fit_state
from distributed_sgd_tpu.config import Config as JaxConfig
from distributed_sgd_tpu.core.cluster import DevCluster as JaxCluster
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.telemetry.health import HealthMonitor as JaxMonitor
from distributed_sgd_tpu.telemetry.slope import LeakSentinel as JaxSentinel
from distributed_sgd_tpu.trace import flight as jflight
from distributed_sgd_tpu.utils import metrics as jmm
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.checkpoint import fit_state_path, restore_fit_state
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.telemetry import HealthMonitor
from distributed_sgd_tpu_torch.telemetry.health import ACTIONS
from distributed_sgd_tpu_torch.telemetry.slope import LeakSentinel
from distributed_sgd_tpu_torch.trace import flight as tflight
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

D, LAM, B, LR, WORKERS, EPOCHS = 200, 1e-4, 16, 0.5, 3, 2
POISON_CALL = 3  # worker 0's Gradient call that replies NaN: epoch 0, window 2
ATOL = 1e-5
LIMIT_S = 90  # each test's own time limit, seconds


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture
def dumps(tmp_path, monkeypatch):
    """Both packages' flight recorders dump under tmp_path/flight."""
    d = str(tmp_path / "flight")
    monkeypatch.setattr(tflight, "_RECORDER", tflight.FlightRecorder(service="port", dir=d))
    monkeypatch.setattr(jflight, "_RECORDER", jflight.FlightRecorder(service="jax", dir=d))
    return d


# -- the monitor ---------------------------------------------------------------

SEQUENCES = {
    # a falling loss: no trip
    "falling": [1.0, 0.8, 0.6, 0.5, 0.45, 0.44, 0.43, 0.43],
    # a rise past 2x the best after the warmup, held for the patience
    "diverging": [1.0, 0.6, 0.4, 0.35, 0.5, 1.2, 2.5, 5.0, 9.0],
    # one spike, then back: the patience forgives it
    "spike": [1.0, 0.6, 0.4, 0.35, 2.0, 0.3, 0.3, 0.3],
    # the warmup's rise sets no best below it: no divergence after
    "warmup": [0.9, 1.5, 2.5, 2.0, 1.5, 1.0],
    # a low first loss is the best: the climb after the warmup trips
    "early_best": [0.2, 1.5, 2.5, 0.4, 0.35, 0.3],
    "nan": [1.0, 0.7, float("nan"), 0.5],
    "inf": [1.0, float("inf")],
}


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_the_loss_watchdog_trips_where_jax_trips(name, dumps):
    jm, tm = jmm.Metrics(), mm.Metrics()
    j, t = JaxMonitor(metrics=jm, action="warn"), HealthMonitor(metrics=tm, action="warn")
    for loss in SEQUENCES[name]:
        assert t.observe_loss(loss) == j.observe_loss(loss), (name, loss)
        assert (t.tripped, t.trip_reason) == (j.tripped, j.trip_reason)
        got = tm.gauge(mm.HEALTH_LOSS_EWMA).value
        want = jm.gauge(jmm.HEALTH_LOSS_EWMA).value
        assert (math.isnan(got) and math.isnan(want)) or got == want
    assert tm.counter(mm.HEALTH_TRIPPED).value == jm.counter(jmm.HEALTH_TRIPPED).value
    assert t.tripped == (name not in ("falling", "spike", "warmup"))
    if t.tripped:
        files = sorted(os.path.basename(p) for p in glob.glob(os.path.join(dumps, "*")))
        assert files == [f"flight-jax-{os.getpid()}-health.json",
                         f"flight-port-{os.getpid()}-health.json"]
        port = json.load(open(os.path.join(dumps, files[1])))
        assert port["events"][-1]["kind"] == "health.tripped"
        assert port["events"][-1]["reason"] == t.trip_reason


def test_a_non_finite_round_is_refused_every_time_and_trips_once(dumps):
    jm, tm = jmm.Metrics(), mm.Metrics()
    j, t = JaxMonitor(metrics=jm, action="halt"), HealthMonitor(metrics=tm, action="halt")
    for norm, stale in ((3.0, 0.1), (float("nan"), 0.2), (2.0, None), (float("inf"), 0.3)):
        assert t.observe_round(norm, staleness_s=stale) == j.observe_round(
            norm, staleness_s=stale) == (not math.isfinite(norm))
        for name in (mm.HEALTH_GRAD_NORM, mm.HEALTH_STALENESS):
            got, want = tm.gauge(name).value, jm.gauge(name).value
            assert (math.isnan(got) and math.isnan(want)) or got == want
    assert (t.trip_reason, j.trip_reason) == ("non_finite_grad", "non_finite_grad")
    assert tm.counter(mm.HEALTH_TRIPPED).value == 1
    # latched: an external verdict after the trip is not a second trip
    assert t.trip_external("leak:rss") is j.trip_external("leak:rss") is False
    assert t.trip_reason == "non_finite_grad"


def test_the_monitor_refuses_what_jax_refuses():
    assert ACTIONS == ("warn", "snapshot", "halt")
    for bad in ({"action": "page"}, {"alpha": 0.0}, {"alpha": 1.5},
                {"divergence_ratio": 1.0}):
        with pytest.raises(ValueError):
            JaxMonitor(**bad)
        with pytest.raises(ValueError):
            HealthMonitor(**bad)
    for bad in ({"health_action": "page"}, {"health_action": "halt"},
                {"health_action": "snapshot"}):
        with pytest.raises(ValueError):
            JaxConfig(**bad)
        with pytest.raises(ValueError):
            Config(**bad)
    assert Config(health_action="halt", checkpoint_dir="c").health_action == "halt"


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_the_leak_sentinel_routes_its_trip_to_the_monitor(pkg, dumps):
    sentinel_cls, monitor_cls, metrics = ((JaxSentinel, JaxMonitor, jmm.Metrics()) if pkg == "jax"
                                          else (LeakSentinel, HealthMonitor, mm.Metrics()))
    s = sentinel_cls(metrics=metrics, min_samples=4, min_horizon_s=0.0,
                     thresholds={"fds": 0.5})
    monitor = monitor_cls(metrics=metrics, action="snapshot")
    s.attach_health(monitor)
    trips = [s.observe("fds", float(i), 10.0 + 2.0 * i) for i in range(6)]
    assert trips == [False, False, False, True, False, False]
    assert monitor.tripped and monitor.trip_reason == "leak:fds"
    assert metrics.counter(mm.HEALTH_TRIPPED).value == 1
    assert metrics.counter(mm.HEALTH_LEAK_SUSPECT).value == 1

    class Broken:
        def trip_external(self, reason, **info):
            raise RuntimeError("a monitor bug")

    s.attach_health(Broken())
    assert s.observe("rss", 0.0, 1.0) is False  # the sentinel survives below
    for i in range(1, 6):
        s.observe("rss", float(i), 1.0 + 1e9 * i)
    assert s.tripped("rss")


# -- fit_sync --------------------------------------------------------------------


@pytest.fixture(scope="module")
def data():
    train, test = train_test_split(rcv1_like(600, n_features=D, nnz=10, seed=11,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _poison(worker, call=POISON_CALL):
    """Worker's `call`-th Gradient body replies NaN (once)."""
    real, seen = worker.compute_gradient, [0]

    def compute(w, ids):
        seen[0] += 1
        g = real(w, ids)
        return np.full_like(g, np.nan) if seen[0] == call else g

    worker.compute_gradient = compute


def _fit(pkg, data, action, path=None, poison=True, max_epochs=EPOCHS):
    """(the fit, the monitor) of a 3-worker cluster of `pkg` whose worker 0
    replies NaN once, under `action` (no monitor when None)."""
    train, test, ds = data
    if pkg == "jax":
        model = jax_make_model("hinge", LAM, D, dim_sparsity=jnp.asarray(ds))
        cluster = JaxCluster(model, train, test, n_workers=WORKERS, seed=0)
        monitor = JaxMonitor(metrics=jmm.Metrics(), action=action) if action else None
    else:
        model = make_model("hinge", LAM, D, dim_sparsity=ds, device="cpu")
        cluster = DevCluster(model, _torch(train), _torch(test), n_workers=WORKERS, seed=0,
                             metrics=mm.Metrics())
        monitor = HealthMonitor(metrics=mm.Metrics(), action=action) if action else None
    with cluster as c:
        if poison:
            _poison(c.workers[0])
        kw = {"fit_state_path": path} if path else {}
        fit = c.master.fit_sync(max_epochs, B, LR, health=monitor, **kw)
    return fit, monitor


_jax = {}


def _jax_fit(data, action, tmp, **kw):
    key = (action, tuple(sorted(kw.items())))
    if key not in _jax:
        path = os.path.join(tmp, f"jax-{action}.npz") if action != "warn" else None
        _jax[key] = _fit("jax", data, action, path, **kw)[0], path
    return _jax[key]


def _close(got, want):
    assert got.epochs_run == want.epochs_run
    np.testing.assert_allclose(got.test_losses, want.test_losses, rtol=ATOL)
    np.testing.assert_allclose(np.asarray(got.weights), np.asarray(want.weights), atol=ATOL)


def test_warn_drops_the_nan_round_and_lands_where_jax_lands(data, dumps, tmp_path_factory):
    got, monitor = _fit("port", data, "warn")
    want, _ = _jax_fit(data, "warn", str(tmp_path_factory.mktemp("j")))
    assert monitor.tripped and monitor.trip_reason == "non_finite_grad"
    assert got.epochs_run == EPOCHS and np.isfinite(np.asarray(got.weights)).all()
    _close(got, want)
    assert monitor.metrics.counter(mm.HEALTH_TRIPPED).value == 1
    assert os.path.exists(os.path.join(dumps, f"flight-port-{os.getpid()}-health.json"))
    # the round was dropped, not applied: the fit is not the unpoisoned one
    clean, _ = _fit("port", data, None, poison=False)
    assert np.abs(np.asarray(clean.weights) - np.asarray(got.weights)).max() > 1e-4


def test_snapshot_writes_the_trips_window_and_changes_nothing_else(data, dumps, tmp_path):
    path = fit_state_path(str(tmp_path))
    got, _ = _fit("port", data, "snapshot", path)
    warned, _ = _fit("port", data, "warn")
    np.testing.assert_array_equal(np.asarray(got.weights), np.asarray(warned.weights))
    fs = restore_fit_state(path, "sgd", [])
    # without a cadence no terminal snapshot ran over it... but a monitor
    # asks for one: the completed fit's, as in JAX
    assert (fs.epoch, fs.batch, fs.finished) == (EPOCHS, 0, False)
    jfit, jpath = _jax_fit(data, "snapshot", str(tmp_path))
    jfs = jax_restore_fit_state(jpath, "sgd", [])
    assert (jfs.epoch, jfs.batch) == (fs.epoch, fs.batch)
    np.testing.assert_allclose(fs.weights, np.asarray(jfs.weights), atol=ATOL)


def test_halt_stops_at_the_trip_and_a_restart_resumes_to_the_jax_weights(data, dumps,
                                                                        tmp_path):
    path = fit_state_path(str(tmp_path))
    halted, monitor = _fit("port", data, "halt", path)
    assert monitor.tripped and halted.epochs_run == 0  # epoch 0 never finished
    fs = restore_fit_state(path, "sgd", [])
    jpath = os.path.join(str(tmp_path), "jax-halt.npz")
    jhalted, _ = _fit("jax", data, "halt", jpath)
    jfs = jax_restore_fit_state(jpath, "sgd", [])
    # the cursor of the window the NaN reached, the weights before it
    assert (fs.epoch, fs.batch) == (jfs.epoch, jfs.batch) == (0, (POISON_CALL - 1) * B)
    np.testing.assert_allclose(fs.weights, np.asarray(jfs.weights), atol=ATOL)
    assert jhalted.epochs_run == halted.epochs_run
    # a restart (any action; the poison gone) resumes there and completes
    resumed, _ = _fit("port", data, "warn", path, poison=False)
    jresumed, _ = _fit("jax", data, "warn", jpath, poison=False)
    _close(resumed, jresumed)
    assert resumed.epochs_run == EPOCHS
    assert restore_fit_state(path, "sgd", []).epoch == EPOCHS  # the completed fit's


def test_a_diverging_loss_halts_after_its_epoch_as_jax(data, dumps, tmp_path):
    """From epoch 1 on worker 0 replies -20 times its gradient, so the fit
    climbs: the watchdog trips at an epoch's evaluation, halts, and
    snapshots the next epoch's cursor, as the JAX fit does."""
    train, test, ds = data
    fits = {}
    for pkg in ("jax", "port"):
        path = os.path.join(str(tmp_path), f"{pkg}.npz")
        if pkg == "jax":
            cluster = JaxCluster(jax_make_model("hinge", LAM, D, dim_sparsity=jnp.asarray(ds)),
                                 train, test, n_workers=WORKERS, seed=0)
            monitor = JaxMonitor(metrics=jmm.Metrics(), action="halt", warmup=1, patience=1)
        else:
            cluster = DevCluster(make_model("hinge", LAM, D, dim_sparsity=ds, device="cpu"),
                                 _torch(train), _torch(test), n_workers=WORKERS, seed=0,
                                 metrics=mm.Metrics())
            monitor = HealthMonitor(metrics=mm.Metrics(), action="halt", warmup=1, patience=1)
        with cluster as c:
            real, seen = c.workers[0].compute_gradient, [0]

            def ascend(w, ids, real=real, seen=seen):
                seen[0] += 1
                g = real(w, ids)
                return g * np.float32(-20.0) if seen[0] > 10 else g  # 10 windows an epoch

            c.workers[0].compute_gradient = ascend
            fit = c.master.fit_sync(6, B, LR, health=monitor, fit_state_path=path)
        fits[pkg] = (fit, monitor, restore_fit_state(path, "sgd", []))
    (jfit, jmon, jfs), (tfit, tmon, tfs) = fits["jax"], fits["port"]
    assert tmon.trip_reason == jmon.trip_reason == "loss_divergence"
    assert tfit.epochs_run == jfit.epochs_run < 6
    assert (tfs.epoch, tfs.batch) == (jfs.epoch, jfs.batch) == (tfit.epochs_run, 0)
    np.testing.assert_allclose(tfit.test_losses, jfit.test_losses, rtol=1e-4)
    np.testing.assert_allclose(tfs.weights, np.asarray(jfs.weights), rtol=1e-4, atol=1e-4)


# -- the CLI -----------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spy_health(monkeypatch):
    seen = []
    real = MasterNode.fit_sync

    def fit_sync(self, *a, **kw):
        seen.append((kw.get("health"), kw.get("fit_state_path")))
        return real(self, *a, **kw)

    monkeypatch.setattr(MasterNode, "fit_sync", fit_sync)
    return seen


@pytest.mark.parametrize("action", ["warn", "halt"])
def test_the_dev_rpc_cluster_takes_the_health_action(action, monkeypatch, tmp_path):
    seen = _spy_health(monkeypatch)
    for k, v in {"DSGD_ENGINE": "rpc", "DSGD_SYNTHETIC": "600", "DSGD_MAX_EPOCHS": "1",
                 "DSGD_NODE_COUNT": "2", "DSGD_HEALTH_ACTION": action,
                 "DSGD_CHECKPOINT_DIR": str(tmp_path)}.items():
        monkeypatch.setenv(k, v)
    assert tmain.main(device="cpu").fit.epochs_run == 1
    (monitor, path), = seen
    assert isinstance(monitor, HealthMonitor) and monitor.action == action
    assert not monitor.tripped
    assert path == fit_state_path(str(tmp_path))
    # the completed fit's terminal snapshot: a restart has nothing to run
    assert restore_fit_state(path, "sgd", []).epoch == 1


def test_the_master_role_takes_the_health_action(monkeypatch):
    seen = _spy_health(monkeypatch)
    monkeypatch.setenv("DSGD_SYNTHETIC", "900")
    port = _free_port()
    common = dict(master_host="127.0.0.1", master_port=port, node_count=2, max_epochs=1,
                  health_action="warn")
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
    (monitor, path), = seen
    assert isinstance(monitor, HealthMonitor) and monitor.action == "warn"
    assert path is None  # no DSGD_CHECKPOINT_DIR: no snapshot to write or restore
