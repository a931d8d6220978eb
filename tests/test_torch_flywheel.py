"""The port's continual-learning flywheel (distributed_sgd_tpu_torch/
autopilot/flywheel.py) and its knobs-off identity, on the CPU.

Knobs off, nothing of the autopilot runs: a fit is bitwise repeatable and
starts no autopilot thread, and a fleet's Predict wire replays byte for
byte with no reservoir, probe-loss series or ``autopilot.*`` instrument.
Then JAX's tiny end-to-end flywheel (tests/test_flywheel.py) on the port:
a step shift in live traffic trips the detector, a warm-start retrain goes
through the canary and promotes, and no Predict is dropped.  Its traffic
waits for the detector's warm-up refreshes to have seen pre-shift rows
before it passes the shift (JAX's test paces its pump by the clock
instead).  Last the CLI's dev role under DSGD_AUTOPILOT=1, which pumps
unpaced as the JAX CLI does: it must serve its horizon with no drop and
return within a bounded settle wait, whether or not it retrains.  Each
test runs under a time limit of its own (`LIMIT_S`)."""

import logging
import signal
import threading
import time

import numpy as np
import pytest
import torch

from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.autopilot import DriftDetector, DriftingStream, Flywheel
from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel
from distributed_sgd_tpu_torch.serving import fleet as fleet_mod
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

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


def _no_autopilot_threads():
    return not any("autopilot" in t.name for t in threading.enumerate())


def _fit_weights():
    data = rcv1_like(384, n_features=256, nnz=8, seed=11, idf_values=True)
    train, test = train_test_split(data)
    model = make_model("hinge", 1e-5, train.n_features, dim_sparsity=dim_sparsity(train),
                       device="cpu")
    with DevCluster(model, train, test, n_workers=2, seed=0) as c:
        res = c.master.fit_sync(max_epochs=2, batch_size=16, learning_rate=0.5,
                                grad_timeout_s=30.0)
    return np.asarray(res.state.weights)


def test_knobs_off_fits_are_bitwise_repeatable():
    w1, w2 = _fit_weights(), _fit_weights()
    assert w1.tobytes() == w2.tobytes()
    assert _no_autopilot_threads()


def test_knobs_off_serving_wire_and_registry_untouched(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.normal(size=64).astype(np.float32)
    ck = Checkpointer(str(tmp_path / "ckpt"))
    ck.save(1, w)
    ck.close()
    rows = [(rng.choice(64, size=4, replace=False).astype(np.int32),
             rng.normal(size=4).astype(np.float32)) for _ in range(16)]

    def serve_bytes():
        m = mm.Metrics()
        with fleet_mod.ServingFleet(str(tmp_path / "ckpt"), n_replicas=2, ckpt_poll_s=30.0,
                                    health_s=0.2, metrics=m, device="cpu") as f:
            channel = new_channel("127.0.0.1", f.router_port)
            stub = ServeStub(channel)
            deadline = time.monotonic() + 30
            while True:
                try:
                    if stub.ServeHealth(pb.Empty(), timeout=2).ok:
                        break
                except Exception:  # noqa: BLE001 - replicas still loading
                    pass
                assert time.monotonic() < deadline, "the fleet never became ready"
                time.sleep(0.05)
            replies = [stub.Predict(pb.PredictRequest(indices=i, values=v),
                                    timeout=5).SerializeToString() for i, v in rows]
            channel.close()
            assert f.router._probe_source is None
            assert f.router.probe_losses() == []
        names = [c.name for c in m.counters()] + [g.name for g in m.gauges()]
        return replies, names

    replies1, names1 = serve_bytes()
    replies2, _ = serve_bytes()
    assert replies1 == replies2, "knobs-off Predict wire must replay"
    assert not any(n.startswith("autopilot.") for n in names1)
    assert mm.ROUTER_PROBE_SOURCED not in names1 and mm.ROUTER_PROBE_FILL not in names1
    assert _no_autopilot_threads()


def test_the_flywheel_detects_retrains_and_promotes(tmp_path):
    """JAX's tier-1 flywheel at its sizes: serve-offset traffic, a step
    shift mid-horizon, detect -> warm-start retrain -> canary -> promote
    with zero dropped Predicts; no false trip before the shift."""
    stream = DriftingStream(n_features=256, nnz=16, noise=0.05, seed=7, schedule="step",
                            shift_at=512, shift_magnitude=1.0)
    # the CLI's drift ratio, 1.5 (JAX's test: 2.0): at these sizes the old
    # model's probe loss after the shift is 1.6-1.8x its loss before it, so
    # a 2.0 bar trips only on the sampling noise (1 run in 5 on a loaded CPU
    # host never tripped); the floor and the warm-up are the test's
    detector = DriftDetector(ratio=1.5, patience=2, warmup=4, abs_floor=0.25)
    m = mm.Metrics()
    fly = Flywheel(
        stream, horizon_rows=1536, window_rows=256, n_workers=2, n_replicas=2, max_epochs=3,
        batch_size=16, learning_rate=0.5, probe_capacity=24, label_delay=2,
        source_refresh_s=0.2, canary_fraction=0.5, health_s=0.1, detector=detector,
        poll_s=0.1, cooldown_s=0.3, canary_timeout_s=30.0, max_retrains=2, seed=7,
        ckpt_dir=str(tmp_path / "ckpt"), metrics=m, device="cpu")
    # the router refreshes the probe set from a full reservoir only: on a
    # loaded host its 0.2 s tick can fire while the first chunk is still
    # being pumped, and a loss over a half-filled reservoir (0.43 over 14
    # rows, where each 24-row set gave 0.58-0.83) became the warm-up's
    # baseline and tripped the detector before the shift.  A full reservoir
    # is a function of the seed and the arrival order, so the first probe
    # loss no longer depends on the host's speed.
    fly.reservoir.min_fill = fly.reservoir.capacity
    fly.start()
    try:
        dropped = []
        router = fly.fleet.router
        deadline = time.monotonic() + 60

        def refreshed(seen):
            # the router re-probed the reservoir and the controller read it
            while len(router.probe_losses()) <= seen or fly.controller._consumed < seen + 1:
                assert time.monotonic() < deadline, "the probe set was not refreshed"
                time.sleep(0.02)

        # the traffic a chunk at a time, each chunk followed by a refresh
        # of the probe set, so the series sees the reservoir turn over (JAX's
        # test paces its pump by the clock to the same end), and the shift
        # passed only once the detector's warm-up has seen pre-shift rows
        while fly.stream_time < stream.shift_at or fly.controller._consumed <= detector.warmup:
            seen = len(router.probe_losses())
            if fly.stream_time < stream.shift_at:
                dropped += fly.pump(min(32, stream.shift_at - fly.stream_time))[1]
            refreshed(seen)
        assert m.counter(mm.AUTOPILOT_DRIFT_TRIPPED).value == 0, "tripped before the shift"
        while not fly.exhausted and fly.controller.retrains == 0:
            seen = len(router.probe_losses())
            dropped += fly.pump(32)[1]
            if fly.controller.state == "SERVING":
                refreshed(seen)
        summary = fly.run(chunk=64, settle_timeout_s=60.0)
    finally:
        fly.stop()
    assert summary["dropped"] + len(dropped) == 0, "the zero-drop SLO broke"
    assert summary["served"] == 1536 - 256
    assert summary["retrains"] >= 1, f"the shift never triggered a retrain: {summary}"
    assert summary["promoted"] >= 1, "no retrained version promoted"
    assert summary["state"] == "SERVING"
    assert m.counter(mm.AUTOPILOT_DRIFT_TRIPPED).value >= 1
    assert len(summary["probe_losses"]) > detector.warmup
    assert _no_autopilot_threads()


def test_the_dev_role_runs_the_flywheel(monkeypatch, caplog, tmp_path):
    """DSGD_AUTOPILOT=1 on the dev role, bounded: the replicas flush at
    once (no coalescing window) and the settle wait is 5 s in place of
    300.  At these sizes the stream's shift (row 4,096) precedes every
    served row, so no retrain is expected."""
    for k, v in {"DSGD_AUTOPILOT": "1", "DSGD_AUTOPILOT_WINDOW": "256",
                 "DSGD_MAX_EPOCHS": "2", "DSGD_CHECKPOINT_DIR": str(tmp_path / "ckpt")}.items():
        monkeypatch.setenv(k, v)
    real_init, real_run = fleet_mod.ServingFleet.__init__, Flywheel.run

    def fast_init(self, *a, **kw):
        real_init(self, *a, **{**kw, "max_delay_ms": 0.0})

    seen = {}

    def bounded_run(self, chunk=64, pace_s=0.0, settle_timeout_s=300.0):
        seen["args"] = (chunk, pace_s, settle_timeout_s)
        return real_run(self, chunk=chunk, pace_s=pace_s, settle_timeout_s=5.0)

    monkeypatch.setattr(fleet_mod.ServingFleet, "__init__", fast_init)
    monkeypatch.setattr(Flywheel, "run", bounded_run)
    with caplog.at_level(logging.INFO, logger="dsgd"):
        run = tmain.main(device="cpu")
    assert run.fit is None
    assert seen["args"] == (64, 0.0, 300.0)  # the JAX CLI's unpaced pump
    assert "dev flywheel: horizon=4608 rows (step shift at 4096), window=256" in caplog.text
    assert "flywheel done: served=4352 dropped=0" in caplog.text
    assert _no_autopilot_threads()
