"""The port's serving fleet (distributed_sgd_tpu_torch/serving/: router,
push, fleet) against the JAX package's, on the CPU over real loopback gRPC.

Mixed fleets: a JAX router balances over port replicas and a port router
over JAX replicas, each answer within 1e-5 of a float64 numpy oracle.
The canary gate promotes a good version and rolls back a bad one (the
negated weights) from either router, with the same decisions on the same
probe set; a JAX checkpoint distributor pushes to port replicas and the
port's to JAX replicas, bitwise.  The port's router fails over a killed
replica with no dropped request, persists its promoted state in the JAX
sidecar format (each package's router restores the other's), and
answers Metrics UNIMPLEMENTED."""

import json
import signal
import threading
import time

import grpc
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.checkpoint import Checkpointer as JaxCheckpointer
from distributed_sgd_tpu.data.rcv1 import Dataset as JaxDataset
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.serving import router as jrouter
from distributed_sgd_tpu.serving.push import CheckpointDistributor as JaxDistributor
from distributed_sgd_tpu.serving.push import WeightPusher as JaxWeightPusher
from distributed_sgd_tpu.serving.router import ServingRouter as JaxRouter
from distributed_sgd_tpu.serving.server import ServingServer as JaxServingServer
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel
from distributed_sgd_tpu_torch.serving import router as trouter
from distributed_sgd_tpu_torch.serving.fleet import ServingFleet
from distributed_sgd_tpu_torch.serving.push import CheckpointDistributor, WeightPusher
from distributed_sgd_tpu_torch.serving.router import ServingRouter
from distributed_sgd_tpu_torch.serving.server import ServingServer
from distributed_sgd_tpu_torch.utils import metrics as mm
from distributed_sgd_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

D = 1000
MARGIN_ATOL = 1e-5
LIMIT_S = 60  # each test's own time limit, seconds


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _data(n=200, seed=21):
    return rcv1_like(n, n_features=D, nnz=20, seed=seed, idf_values=True)


def _rows(n=60, seed=21):
    ds = _data(n, seed)
    return [(ds.indices[i][ds.values[i] != 0].astype(np.int32),
             ds.values[i][ds.values[i] != 0].astype(np.float32)) for i in range(n)]


def _weights(seed=3):
    w = (np.random.default_rng(seed).normal(size=D) * 0.3).astype(np.float32)
    w[w == 0] = 0.1
    return w


def _oracle(rows, w):
    return np.array([np.dot(v.astype(np.float64), w.astype(np.float64)[i]) for i, v in rows])


def _full(version, w):
    req = pb.PushWeightsRequest(version=version)
    req.weights.CopyFrom(codec.encode_tensor(np.asarray(w, np.float32)))
    return req


def _port_replica(path, **kw):
    return ServingServer(str(path), port=0, host="127.0.0.1", ckpt_poll_s=30.0,
                         metrics=Metrics(), device="cpu", **kw).start()


def _jax_replica(path, **kw):
    return JaxServingServer(str(path), port=0, host="127.0.0.1", ckpt_poll_s=30.0,
                            metrics=JaxMetrics(), **kw).start()


def _router(pkg, replicas, **kw):
    cls, metrics = (ServingRouter, Metrics) if pkg == "port" else (JaxRouter, JaxMetrics)
    return cls([("127.0.0.1", r.bound_port) for r in replicas], port=0, host="127.0.0.1",
               health_s=0.2, metrics=metrics(), **kw).start()


def _probe(w, n=40):
    """Held-out rows labelled so that `w` scores zero hinge loss (y =
    predict(margin) = -sign(margin)) and the negated weights about 2."""
    ds = _data(n, seed=77)
    rows = []
    for i in range(n):
        nz = ds.values[i] != 0
        idx, val = ds.indices[i][nz].astype(np.int32), ds.values[i][nz].astype(np.float32)
        m = float(np.dot(val, w[idx]))
        rows.append((idx, val, float(-np.sign(m) or 1.0)))
    return rows


# -- replica selection and the probe set ----------------------------------------


def test_router_p2c_picks_the_lower_score_and_skips_drained():
    router = ServingRouter([("127.0.0.1", 1), ("127.0.0.1", 2)], port=0, host="127.0.0.1",
                           metrics=Metrics())
    a, b = router._replicas
    a.healthy = b.healthy = True
    a.ewma_s, b.ewma_s = 0.001, 0.5
    assert all(router._pick() is a for _ in range(16))
    a.inflight = 10_000  # in-flight load flips the choice
    assert router._pick() is b
    a.inflight = 0
    b.healthy = False
    assert router._eligible() == [a]
    a.healthy = False  # the last-resort pool still answers
    assert router._pick() is not None
    router.stop()


def test_probe_sets_load_as_jax_loads_them(tmp_path):
    ds = _data(30)
    path = tmp_path / "probe.npz"
    np.savez(path, indices=ds.indices, values=ds.values, labels=ds.labels)
    for got, want in ((trouter.load_probe(str(path)), jrouter.load_probe(str(path))),
                      (trouter.probe_from_dataset(ds, n=12),
                       jrouter.probe_from_dataset(JaxDataset(ds.indices, ds.values, ds.labels,
                                                             ds.n_features), n=12))):
        assert len(got) == len(want)
        for (ti, tv, ty), (ji, jv, jy) in zip(got, want):
            assert ti.tobytes() == ji.tobytes() and tv.tobytes() == jv.tobytes() and ty == jy


# -- mixed fleets --------------------------------------------------------------


@pytest.mark.parametrize("router_pkg,replica_pkg", [("jax", "port"), ("port", "jax"),
                                                    ("port", "port")])
def test_a_router_answers_over_replicas_of_either_package(router_pkg, replica_pkg, tmp_path):
    w = _weights()
    make = _port_replica if replica_pkg == "port" else _jax_replica
    replicas = [make(tmp_path / f"r{i}") for i in range(2)]
    for r in replicas:  # the weights, pushed in full
        assert r.store.apply_push(_full(3, w)) == (True, 3)
    router = _router(router_pkg, replicas)
    channel = new_channel("127.0.0.1", router.bound_port)
    stub = ServeStub(channel)
    try:
        rows = _rows()
        replies = [stub.Predict(pb.PredictRequest(indices=i, values=v), timeout=15)
                   for i, v in rows]
        margins = np.array([r.margin for r in replies])
        np.testing.assert_allclose(margins, _oracle(rows, w), rtol=0, atol=MARGIN_ATOL)
        assert {r.model_step for r in replies} == {3}
        health = stub.ServeHealth(pb.Empty(), timeout=5)
        assert health.ok and health.model_step == 3
        with pytest.raises(grpc.RpcError) as err:  # a caller error is not failed over
            stub.Predict(pb.PredictRequest(indices=[D + 5], values=[1.0]), timeout=5)
        assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    finally:
        channel.close()
        router.stop()
        for r in replicas:
            r.stop()


def _canary_run(router_pkg, replica_pkg, tmp_path):
    """Push a good v2, the negated v3, v3 again and a good v4 through a
    router with a canary at 0.5 over 2 replicas; returns the acks, the
    replicas' steps after each push, and the probe losses seen."""
    w_good = _weights(9)
    make = _port_replica if replica_pkg == "port" else _jax_replica
    replicas = [make(tmp_path / f"{router_pkg}-{replica_pkg}-r{i}") for i in range(2)]
    for r in replicas:
        r.store.apply_push(_full(1, w_good))
    router = _router(router_pkg, replicas, canary_fraction=0.5, probe=_probe(w_good))
    pusher = WeightPusher([("127.0.0.1", router.bound_port)], metrics=Metrics())
    w2 = w_good.copy()
    w2[0] *= 1.0 + 1e-3
    w4 = w_good.copy()
    w4[1] *= 1.0 + 1e-3
    acks, steps = [], []
    try:
        for version, w in ((2, w2), (3, -w_good), (3, -w_good), (4, w4)):
            acks.append(pusher.push(version, w))
            steps.append([r.store.step for r in replicas])
        served = [np.asarray(r.store.get()[1]).tobytes() for r in replicas]
        m = router.metrics
        counts = (m.counter(mm.ROUTER_CANARY_PROMOTED).value,
                  m.counter(mm.ROUTER_CANARY_ROLLBACK).value)
    finally:
        pusher.close()
        router.stop()
        for r in replicas:
            r.stop()
    return acks, steps, counts, served == [w4.tobytes()] * 2


def test_the_canary_promotes_and_rolls_back_alike_from_either_router(tmp_path):
    runs = {(rp, sp): _canary_run(rp, sp, tmp_path)
            for rp, sp in (("jax", "port"), ("port", "port"), ("port", "jax"))}
    want = ([1, 0, 0, 1], [[2, 2], [2, 2], [2, 2], [4, 4]], (2, 1), True)
    for key, got in runs.items():
        assert got == want, key


def test_a_jax_distributor_pushes_to_port_replicas_and_the_port_one_to_jax(tmp_path):
    rng = np.random.default_rng(4)
    w = _weights(2)
    port = [_port_replica(tmp_path / f"p{i}") for i in range(2)]
    jaxr = [_jax_replica(tmp_path / f"j{i}") for i in range(2)]
    jck, tck = JaxCheckpointer(str(tmp_path / "jax-ckpt")), Checkpointer(str(tmp_path / "ckpt"))
    jdist = JaxDistributor(str(tmp_path / "jax-ckpt"),
                           [("127.0.0.1", r.bound_port) for r in port], poll_s=30.0,
                           metrics=JaxMetrics())
    tdist = CheckpointDistributor(str(tmp_path / "ckpt"),
                                  [("127.0.0.1", r.bound_port) for r in jaxr], poll_s=30.0,
                                  metrics=Metrics())
    try:
        for step in (5, 6, 7):
            if step > 5:
                w = w.copy()
                hit = rng.choice(D, size=15, replace=False)
                w[hit] = rng.normal(size=15).astype(np.float32)
            jck.save(step, w)
            tck.save(step, w)
            assert jdist.poll_once() and tdist.poll_once()
            for r in port + jaxr:
                assert r.store.step == step
                assert np.asarray(r.store.get()[1]).tobytes() == w.tobytes()
        for r in port:
            assert r.metrics.counter(mm.SERVE_MODEL_PUSH_DELTA).value == 2
        assert tdist.pusher.metrics.counter(mm.SERVE_PUSH_DELTA).value == 4
    finally:
        jdist.stop()
        tdist.stop()
        jck.close()
        for r in port + jaxr:
            r.stop()


# -- the port's fleet ----------------------------------------------------------


def test_the_fleet_fails_over_a_killed_replica_with_no_dropped_request(tmp_path):
    w = _weights(7)
    Checkpointer(str(tmp_path)).save(1, w)
    m = Metrics()
    fleet = ServingFleet(str(tmp_path), n_replicas=3, ckpt_poll_s=30.0, health_s=0.2,
                         hedge_ms=250.0, request_timeout_s=10.0, metrics=m,
                         device="cpu").start()
    channel = new_channel("127.0.0.1", fleet.router_port)
    stub = ServeStub(channel)
    errors, wrong, stop = [], [], threading.Event()

    def client(k):
        r = np.random.default_rng(k)
        while not stop.is_set():
            idx = r.choice(D, size=int(r.integers(1, 6)), replace=False).astype(np.int32)
            val = r.normal(size=len(idx)).astype(np.float32)
            try:
                reply = stub.Predict(pb.PredictRequest(indices=idx, values=val), timeout=10)
            except Exception as e:  # noqa: BLE001 - the assert below
                errors.append(e)
                continue
            if abs(reply.margin - float(np.dot(val, w[idx]))) > 1e-4:
                wrong.append(idx)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(4)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.5)
        fleet.kill_replica(0)
        deadline = time.time() + 15
        while time.time() < deadline and m.counter(mm.ROUTER_DRAINED).value == 0:
            time.sleep(0.05)
        time.sleep(0.3)
    finally:
        stop.set()
        for t in threads:
            t.join()
    try:
        assert not errors, f"dropped requests: {errors[:3]}"
        assert not wrong and m.counter(mm.ROUTER_DRAINED).value >= 1
        assert stub.ServeHealth(pb.Empty(), timeout=5).ok
        # elastic membership: one more replica joins warm, then drains out
        fleet.router.PushWeights(_full(2, w), None)
        joined = fleet.add_replica()
        assert joined.store.step == 2 and len(fleet.replicas) == 4
        assert fleet.drain_replica() and len(fleet.replicas) == 3
    finally:
        channel.close()
        fleet.stop()


def test_router_state_persists_in_the_jax_sidecar_format(tmp_path):
    """The port's router writes DSGD_SERVE_STATE as the JAX router does: a
    restarted port router re-pins the promoted version (no canary pass),
    keeps the rejected one rejected, and a JAX router restores the same
    sidecar to the same state."""
    w_good = _weights(12)
    state = str(tmp_path / "router-state.json")
    probe = _probe(w_good)
    kw = dict(ckpt_poll_s=30.0, health_s=0.5, canary_fraction=0.5, probe=probe,
              state_path=state, device="cpu")
    Checkpointer(str(tmp_path / "ckpt")).save(1, w_good)
    with ServingFleet(str(tmp_path / "ckpt"), n_replicas=2, metrics=Metrics(), **kw) as f:
        pusher = WeightPusher([("127.0.0.1", f.router_port)], metrics=Metrics())
        assert pusher.push(2, w_good) == 1
        assert pusher.push(3, -w_good) == 0
        pusher.close()
    persisted = json.load(open(state))
    assert persisted["promoted_version"] == 2 and persisted["rejected"] == [3]
    assert set(persisted) == {"seq", "promoted_version", "best_loss", "rejected"}
    m2 = Metrics()
    with ServingFleet(str(tmp_path / "ckpt"), n_replicas=2, metrics=m2, **kw) as f:
        pusher = WeightPusher([("127.0.0.1", f.router_port)], metrics=Metrics())
        assert pusher.push(2, w_good) == 1  # re-pinned
        assert m2.counter(mm.ROUTER_CANARY_PROMOTED).value == 0
        assert pusher.push(3, -w_good) == 0  # still rejected, no second probe
        assert m2.counter(mm.ROUTER_CANARY_ROLLBACK).value == 0
        pusher.close()
    restored = JaxRouter([("127.0.0.1", 1)], port=0, host="127.0.0.1", state_path=state,
                         metrics=JaxMetrics())
    ported = ServingRouter([("127.0.0.1", 1)], port=0, host="127.0.0.1", state_path=state,
                           metrics=Metrics())
    try:
        assert restored.export_ha_state() == ported.export_ha_state()
        assert ported.export_ha_state()["promoted"] == 2
    finally:
        restored.stop()
        ported.stop()


def test_the_router_answers_metrics_unimplemented_and_refuses_a_telemetry_port():
    with pytest.raises(NotImplementedError, match="item 8"):
        ServingRouter([("127.0.0.1", 1)], port=0, telemetry_port=0)
    router = ServingRouter([("127.0.0.1", 1)], port=0, host="127.0.0.1",
                           metrics=Metrics()).start()
    channel = new_channel("127.0.0.1", router.bound_port)
    try:
        with pytest.raises(grpc.RpcError) as err:
            ServeStub(channel).Metrics(pb.Empty(), timeout=5)
        assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
        assert "item 8" in err.value.details()
        health = ServeStub(channel).ServeHealth(pb.Empty(), timeout=5)
        assert not health.ok  # no replica answered
    finally:
        channel.close()
        router.stop()


def test_a_jax_pusher_and_the_port_pusher_send_the_same_bytes(tmp_path):
    """WeightPusher's plan (full, then deltas, a NACK answered by one full
    resend) is the JAX pusher's: the same wire bytes, counted alike."""
    r, rj = _port_replica(tmp_path / "r"), _port_replica(tmp_path / "rj")
    rng = np.random.default_rng(8)
    w = _weights(1)
    port, jax_p = (WeightPusher([("127.0.0.1", r.bound_port)], metrics=Metrics()),
                   JaxWeightPusher([("127.0.0.1", rj.bound_port)], metrics=JaxMetrics()))
    try:
        for version in (1, 2, 3):
            if version > 1:
                w = w.copy()
                w[rng.choice(D, size=10, replace=False)] += 1.0
            assert port.push(version, w) == 1
            assert jax_p.push(version, w) == 1
        for name in (mm.SERVE_PUSH_BYTES, mm.SERVE_PUSH_FULL, mm.SERVE_PUSH_DELTA,
                     mm.SERVE_PUSH_FULL_EQUIV, mm.SERVE_PUSH_NACK):
            assert port.metrics.counter(name).value == jax_p.metrics.counter(name).value, name
        assert port.metrics.counter(mm.SERVE_PUSH_DELTA).value == 2
    finally:
        port.close()
        jax_p.close()
        r.stop()
        rj.stop()


@pytest.mark.parametrize("bad", [
    "",
    '{"promoted_version": 4, "reje',
    "[1, 2, 3]",
    '{"promoted_version": "two", "best_loss": "high", "rejected": ["x"]}',
], ids=["empty", "truncated", "wrong-schema", "garbage-values"])
def test_a_corrupt_state_sidecar_is_quarantined_as_jax_quarantines_it(tmp_path, bad):
    """Each package's router starts fresh on a corrupt sidecar and moves
    the bytes aside to <path>.corrupt, where a second boot leaves them."""
    for pkg, cls, metrics in (("port", ServingRouter, Metrics), ("jax", JaxRouter, JaxMetrics)):
        state = tmp_path / f"{pkg}.json"
        state.write_text(bad)
        for _ in range(2):
            r = cls([("127.0.0.1", 1)], port=0, host="127.0.0.1", metrics=metrics(),
                    state_path=str(state))
            try:
                assert r._promoted_version is None and r._rejected == set()
                assert r._checker.best_loss == float("inf")
                assert not state.exists()
                assert (tmp_path / f"{pkg}.json.corrupt").read_text() == bad
            finally:
                r.stop(grace=0.1)


def test_a_probe_refresh_reanchors_the_baseline_as_jax_does(tmp_path):
    """Traffic drifts away from the probe: the drift-adapted (negated)
    weights are rolled back against the stale probe, a refresh re-anchors
    the baseline on the promoted version's loss over the new rows, the
    rejected version stays rejected and a fresh adapted one promotes.
    The port's router and JAX's, each over port replicas, reach the same
    verdicts and the same re-anchored baseline."""
    w_a = _weights(13)
    w_b = -w_a
    runs = {}
    for pkg in ("port", "jax"):
        replicas = [_port_replica(tmp_path / f"{pkg}-r{i}") for i in range(3)]
        for r in replicas:
            r.store.apply_push(_full(1, w_a))
        router = _router(pkg, replicas, canary_fraction=0.34, probe=_probe(w_a))
        pusher = WeightPusher([("127.0.0.1", router.bound_port)], metrics=Metrics())
        w2, w4 = w_a.copy(), w_b.copy()
        w2[0] *= 1.0 + 1e-3
        w4[1] *= 1.0 + 1e-3
        try:
            acks = [pusher.push(2, w2), pusher.push(3, w_b)]
            router.refresh_probe(_probe(w_b))
            baseline = router._checker.best_loss
            acks += [pusher.push(3, w_b), pusher.push(4, w4)]
            runs[pkg] = (acks, baseline, [r.store.step for r in replicas],
                         router.metrics.counter(mm.ROUTER_PROBE_REFRESH).value,
                         router.metrics.counter(mm.ROUTER_CANARY_ROLLBACK).value)
        finally:
            pusher.close()
            router.stop()
            for r in replicas:
                r.stop()
    assert runs["port"][0] == [1, 0, 0, 1] and runs["port"][1] > 1.0
    assert runs["port"][2:] == ([4, 4, 4], 1, 1)
    assert runs["port"][0] == runs["jax"][0] and runs["port"][2:] == runs["jax"][2:]
    assert runs["port"][1] == pytest.approx(runs["jax"][1], abs=1e-6)


def test_the_probe_refresh_cadence_rereads_the_probe_file(tmp_path):
    import os

    w = _weights(17)
    probe_file = tmp_path / "probe.npz"

    def write(wv, n=6):
        ds = _data(n, seed=5)
        y = [(-np.sign(float(np.dot(ds.values[i], wv[ds.indices[i]]))) or 1.0)
             for i in range(n)]
        np.savez(probe_file, indices=ds.indices, values=ds.values, labels=np.asarray(y))

    write(w)
    replicas = [_port_replica(tmp_path / f"r{i}") for i in range(2)]
    for r in replicas:
        r.store.apply_push(_full(1, w))
    router = ServingRouter([("127.0.0.1", r.bound_port) for r in replicas], port=0,
                           host="127.0.0.1", health_s=30.0, canary_fraction=0.5,
                           probe=trouter.load_probe(str(probe_file)), metrics=Metrics(),
                           probe_path=str(probe_file), probe_refresh_s=0.01).start()
    try:
        before = list(router._probe)
        router._probe_next_check = 0.0  # due, but the file did not change
        router._maybe_refresh_probe()
        assert router.metrics.counter(mm.ROUTER_PROBE_REFRESH).value == 0
        write(-w)
        os.utime(probe_file, (time.time() + 5, time.time() + 5))
        router._probe_next_check = 0.0
        router._maybe_refresh_probe()
        assert router.metrics.counter(mm.ROUTER_PROBE_REFRESH).value == 1
        assert [y for _, _, y in router._probe] == [-y for _, _, y in before]
    finally:
        router.stop()
        for r in replicas:
            r.stop()
