"""The port's serving-plane HA (distributed_sgd_tpu_torch/serving/ha.py:
the DSGD_SERVE_HA grammar, the file and peer leases, HACoordinator's
SyncServeState exchange, FailoverServeClient, ReplicaAutoscaler and
router_load_ms) against the JAX package's, on the CPU over real loopback
gRPC.

The grammar, both leases and the autoscaler give the JAX verdicts on the
same inputs and clocks.  A JAX router and a port router are HA peers over
one fleet of port replicas: whichever holds the decider lease, a promote,
a deferred push and a rollback reach the other within one exchange, and
when a started decider dies the survivor assumes the lease and decides."""

import signal
import socket
import time

import grpc
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.serving import ha as jha
from distributed_sgd_tpu.serving.router import ServingRouter as JaxRouter
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel
from distributed_sgd_tpu_torch.serving import ha as tha
from distributed_sgd_tpu_torch.serving.push import WeightPusher
from distributed_sgd_tpu_torch.serving.router import ServingRouter
from distributed_sgd_tpu_torch.serving.server import ServingServer
from distributed_sgd_tpu_torch.utils import metrics as mm
from distributed_sgd_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

D = 64
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


def _weights(seed=7):
    w = np.random.default_rng(seed).normal(size=D).astype(np.float32)
    w[w == 0] = 0.1
    return w


def _probe(w, n=8):
    """Single-coordinate rows on which `w` scores zero hinge loss and the
    negated weights 2."""
    return [(np.array([i], np.int32), np.array([1.0], np.float32),
             float(-np.sign(w[i]) or 1.0)) for i in range(n)]


# -- the grammar and the leases ------------------------------------------------


@pytest.mark.parametrize("spec", [
    "peers:10.0.0.2:4100,10.0.0.3:4100",
    "peers:h2:1;self=h1:1;sync=100ms;ttl=2s;lease=/l",
    "peers:h:9;sync=1.5s", "peers:h:9;ttl=3",
    "10.0.0.2:4100", "peers:", "peers:h:1;sync=0", "peers:h:1;ttl=-1s",
    "peers:h:1;bogus=1", "peers:h:1;novalue", "peers:h:1;self=nohost",
])
def test_the_ha_spec_parses_as_jax_parses_it(spec):
    try:
        want = jha.parse_ha_spec(spec)
    except ValueError:
        with pytest.raises(ValueError):
            tha.parse_ha_spec(spec)
        return
    assert tha.parse_ha_spec(spec) == want


def test_the_file_lease_decides_as_jax_decides(tmp_path):
    """Two nodes contend for one lease file under a shared fake clock; each
    package's pair takes the same verdicts and terms at every tick."""

    def run(mod, path):
        t = [0.0]
        a = mod.FileLease(str(path), "a:1", ttl_s=1.0, clock=lambda: t[0])
        b = mod.FileLease(str(path), "b:1", ttl_s=1.0, clock=lambda: t[0])
        seen = []
        for step, who in enumerate("aabbbaab"):
            t[0] = step * 0.6
            node = a if who == "a" else b
            seen.append((who, node.acquire(), node.term, a.holder(), b.holder()))
            if step == 4:
                b.release()
        return seen

    assert run(tha, tmp_path / "t.json") == run(jha, tmp_path / "j.json")


def test_the_peer_lease_decides_as_jax_decides():
    def run(mod):
        t = [0.0]
        lease = mod.PeerLease("h:9", ["h:10", "h:8"], ttl_s=1.0, clock=lambda: t[0])
        seen = []
        for step in range(8):
            t[0] = step * 0.4
            if step in (1, 2):
                lease.observe("h:10")
            if step == 5:
                lease.observe("h:8")
            seen.append((lease.holder(), lease.acquire()))
        return seen

    assert run(tha) == run(jha)


# -- the autoscaler ------------------------------------------------------------


@pytest.mark.parametrize("signals", [
    [500, 500, 500, 500, 500, 500],
    [500, 50, 500, 500, 10, 10, 10, 10, 10],
    [None, 500, 500, 10, None, 10, 10, 10],
    [10] * 12,
])
def test_the_autoscaler_takes_the_jax_verdicts(signals):
    def run(mod):
        t, count, sig = [0.0], [2], iter(signals)
        s = mod.ReplicaAutoscaler(
            signal_ms=lambda: next(sig), scale_up=lambda: count.append(count[-1] + 1),
            scale_down=lambda: count.append(count[-1] - 1), count=lambda: count[-1],
            slo_ms=100.0, min_replicas=1, max_replicas=4, up_after=2, down_after=3,
            low_water=0.3, cooldown_s=2.0, metrics=mod.metrics_mod.Metrics(),
            clock=lambda: t[0])
        verdicts = []
        for k in range(len(signals)):
            t[0] = float(k)
            verdicts.append(s.step())
        return verdicts, count

    assert run(tha) == run(jha)
    for bad in ({"slo_ms": 0}, {"min_replicas": 3, "max_replicas": 2}, {"low_water": 1.0},
                {"up_after": 0}, {"interval_s": 0}):
        kw = dict(signal_ms=lambda: None, scale_up=lambda: None, scale_down=lambda: None,
                  count=lambda: 1, slo_ms=10.0)
        kw.update(bad)
        for mod in (tha, jha):
            with pytest.raises(ValueError):
                mod.ReplicaAutoscaler(**kw)


def test_router_load_ms_is_the_worst_eligible_score():
    router = ServingRouter([("127.0.0.1", 1), ("127.0.0.1", 2)], port=0, host="127.0.0.1",
                           metrics=Metrics())
    try:
        assert tha.router_load_ms(router) is None  # nobody eligible yet
        a, b = router._replicas
        a.healthy = b.healthy = True
        a.ewma_s, b.ewma_s, b.inflight = 0.002, 0.010, 2
        assert tha.router_load_ms(router) == pytest.approx(30.0)
    finally:
        router.stop()


# -- a JAX router and a port router as HA peers -------------------------------


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = sorted(s.getsockname()[1] for s in socks)
    for s in socks:
        s.close()
    return ports


@pytest.fixture
def fleet(tmp_path):
    w = _weights()
    Checkpointer(str(tmp_path / "ckpt")).save(1, w)
    replicas = [ServingServer(str(tmp_path / "ckpt"), port=0, host="127.0.0.1",
                              ckpt_poll_s=60.0, metrics=Metrics(), device="cpu").start()
                for _ in range(2)]
    try:
        yield w, [("127.0.0.1", r.bound_port) for r in replicas], replicas
    finally:
        for r in replicas:
            r.stop()


def _mixed_pair(endpoints, probe, decider, sync_s=60.0, ttl_s=600.0, **kw):
    """A JAX router and a port router over `endpoints`, each with a
    coordinator naming the other; `decider` ('jax' | 'port') gets the
    lower port, so the peer lease makes it the decider."""
    low, high = _free_ports(2)
    ports = {"jax": low, "port": high} if decider == "jax" else {"jax": high, "port": low}
    common = dict(canary_fraction=0.5, probe=probe, health_s=0.2, request_timeout_s=5.0,
                  host="127.0.0.1", **kw)
    routers = {
        "jax": JaxRouter(endpoints, port=ports["jax"], metrics=JaxMetrics(), **common).start(),
        "port": ServingRouter(endpoints, port=ports["port"], metrics=Metrics(),
                              **common).start(),
    }
    routers["jax"].attach_ha(jha.HACoordinator([f"127.0.0.1:{ports['port']}"], sync_s=sync_s,
                                               lease_ttl_s=ttl_s))
    routers["port"].attach_ha(tha.HACoordinator([f"127.0.0.1:{ports['jax']}"], sync_s=sync_s,
                                                lease_ttl_s=ttl_s))
    return routers


@pytest.mark.parametrize("decider", ["jax", "port"])
def test_a_jax_router_and_a_port_router_mirror_each_others_verdicts(decider, fleet):
    w, endpoints, _ = fleet
    routers = _mixed_pair(endpoints, _probe(w), decider)
    mirror_pkg = "port" if decider == "jax" else "jax"
    dec, mir = routers[decider], routers[mirror_pkg]
    pushers = []
    try:
        assert dec._ha.is_decider() and not mir._ha.is_decider()
        push = WeightPusher([("127.0.0.1", dec.bound_port)], metrics=Metrics())
        mpush = WeightPusher([("127.0.0.1", mir.bound_port)], metrics=Metrics())
        pushers += [push, mpush]
        w2 = w.copy()
        w2[0] *= 1.001
        assert push.push(2, w2) == 1 and dec.promoted_version == 2
        assert mir.promoted_version is None
        assert dec._ha.sync_once() == 1  # one exchange mirrors the promote
        assert mir.promoted_version == 2
        assert mir._checker.best_loss == dec._checker.best_loss != float("inf")
        # a new version pushed at the mirror is deferred, then pinned
        w3 = w.copy()
        w3[1] *= 1.001
        assert mpush.push(3, w3) == 0 and mir._ha_pending is not None
        assert push.push(3, w3) == 1
        assert dec._ha.sync_once() == 1
        assert mir.promoted_version == 3 and mir._ha_pending is None
        np.testing.assert_array_equal(mir._w_promoted, w3)
        # a rollback on the decider is adopted; the mirror NACKs it outright
        assert push.push(4, -5.0 * w) == 0
        assert mir._ha.sync_once() == 1  # the mirror's own exchange pulls it
        assert mir._rejected == {4} and mir.promoted_version == 3
        assert mpush.push(4, -5.0 * w) == 0
        assert mir.metrics.counter(mm.ROUTER_CANARY_ROLLBACK).value == 0
        assert dec.export_ha_state() == mir.export_ha_state()
    finally:
        for p in pushers:
            p.close()
        for r in routers.values():
            r.stop(grace=0.1)


@pytest.mark.parametrize("decider", ["jax", "port"])
def test_when_the_decider_dies_the_other_package_takes_the_lease(decider, fleet):
    w, endpoints, _ = fleet
    routers = _mixed_pair(endpoints, _probe(w), decider, sync_s=0.1, ttl_s=0.5)
    survivor_pkg = "port" if decider == "jax" else "jax"
    dec, surv = routers[decider], routers[survivor_pkg]
    for r in routers.values():
        r._ha.start()
    try:
        push = WeightPusher([("127.0.0.1", dec.bound_port)], metrics=Metrics())
        w2 = w.copy()
        w2[0] *= 1.001
        assert push.push(2, w2) == 1
        push.close()
        deadline = time.time() + 10
        while time.time() < deadline and surv.promoted_version != 2:
            time.sleep(0.05)
        assert surv.promoted_version == 2  # mirrored by the running loop
        dec.stop(grace=0.1)
        deadline = time.time() + 15
        while time.time() < deadline and not surv._ha.is_decider():
            time.sleep(0.05)
        assert surv._ha.is_decider(), "the survivor never assumed the lease"
        assert surv.metrics.counter(mm.ROUTER_HA_FAILOVERS).value == 1
        spush = WeightPusher([("127.0.0.1", surv.bound_port)], metrics=Metrics())
        w3 = w.copy()
        w3[1] *= 1.001
        assert spush.push(3, w3) == 1 and surv.promoted_version == 3
        spush.close()
    finally:
        for r in routers.values():
            r.stop(grace=0.1)


def test_without_ha_the_port_router_adopts_nothing_and_answers_its_record(fleet):
    w, endpoints, _ = fleet
    router = ServingRouter(endpoints, port=0, host="127.0.0.1", probe=_probe(w),
                           metrics=Metrics()).start()
    channel = new_channel("127.0.0.1", router.bound_port)
    try:
        push = WeightPusher([("127.0.0.1", router.bound_port)], metrics=Metrics())
        assert push.push(2, w) == 1
        push.close()
        req = pb.SyncServeStateRequest(node="127.0.0.1:1", seq=99, has_promoted=True,
                                       promoted_version=7)
        reply = ServeStub(channel).SyncServeState(req, timeout=5)
        assert not reply.applied and reply.promoted_version == 2 and reply.seq == 1
        assert router.promoted_version == 2
        assert router.metrics.counter(mm.ROUTER_HA_SYNCS).value == 0
    finally:
        channel.close()
        router.stop()


def test_the_failover_client_sticks_with_the_router_that_answers(fleet):
    w, endpoints, _ = fleet
    client = tha.FailoverServeClient([("127.0.0.1", 1), endpoints[0]], timeout_s=5.0)
    try:
        reply = client.predict(np.array([2], np.int32), np.array([1.0], np.float32))
        assert reply.margin == pytest.approx(float(w[2])) and client.failovers == 1
        client.predict(np.array([0], np.int32), np.array([1.0], np.float32))
        assert client.failovers == 1 and client.health().ok
    finally:
        client.close()
    dead = tha.FailoverServeClient([("127.0.0.1", 1), ("127.0.0.1", 2)], timeout_s=1.0)
    with pytest.raises(grpc.RpcError):
        dead.predict(np.array([0], np.int32), np.array([1.0], np.float32))
    dead.close()
    with pytest.raises(ValueError):
        tha.FailoverServeClient([])


def test_the_route_role_with_serve_ha_runs_its_coordinator(fleet):
    """DSGD_SERVE_HA on the route role through main(): the router takes a
    peer's newer record (HA on adopts; without it nothing is adopted),
    and stop_serving() ends the role."""
    import threading

    from distributed_sgd_tpu_torch import main as tmain
    from distributed_sgd_tpu_torch.config import Config

    _, endpoints, _ = fleet
    port, peer = _free_ports(2)
    cfg = Config(role_override="route", serve_port=port, serve_health_s=0.2,
                 serve_targets=",".join(f"{h}:{p}" for h, p in endpoints),
                 serve_ha=f"peers:127.0.0.1:{peer};self=127.0.0.1:{port};sync=100ms")
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("run", tmain.main(device="cpu", cfg=cfg)),
                         daemon=True)
    t.start()
    channel = new_channel("127.0.0.1", port)
    try:
        stub = ServeStub(channel)
        deadline = time.time() + 30
        while time.time() < deadline:
            try:
                if stub.ServeHealth(pb.Empty(), timeout=1).ok:
                    break
            except grpc.RpcError:
                time.sleep(0.1)
        req = pb.SyncServeStateRequest(node=f"127.0.0.1:{peer}", seq=5, has_promoted=True,
                                       promoted_version=9)
        reply = stub.SyncServeState(req, timeout=5)
        assert reply.applied and reply.seq == 5 and reply.promoted_version == 9
    finally:
        channel.close()
        tmain.stop_serving()
        t.join(30)
    assert not t.is_alive() and box["run"].fit is None
