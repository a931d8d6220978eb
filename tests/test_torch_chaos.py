"""The port's fault-injection layer (distributed_sgd_tpu_torch/chaos/,
DSGD_CHAOS) against the JAX package's chaos/, on the CPU.

The plan grammar and the scenario library against JAX's on a table of
specs (the same plans, the same ValueErrors); the per-edge decision
streams against JAX's ``ChaosState`` for the same plan and edges, named
and unnamed; each fault mode through a real loopback stub of the port
(error, drop to the deadline, a delay riding the future, a partition that
opens and heals, grace and un-armed, no plan = the raw channel,
scope=named); a small port DevCluster fit under weather with a quorum of
2; and a JAX master under its own plan over port workers, and the
converse.  No check gates on wall clock: times are only lower bounds.
Each test runs under a time limit of its own (`LIMIT_S`)."""

import signal
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu import chaos as jchaos
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.utils import metrics as jmm
from distributed_sgd_tpu_torch import chaos
from distributed_sgd_tpu_torch.chaos import ChaosState, FaultPlan, _ChaosCallable, parse_plan
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import (
    WorkerStub,
    add_worker_servicer,
    new_channel,
    new_server,
)
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

LIMIT_S = 60  # each test's own time limit, seconds
WEATHER = "seed=7;drop=0.08;delay=2ms~10ms;dup=0.02"  # JAX's soak plan


@pytest.fixture(autouse=True)
def _clean():
    """No plan of either package before or after a test (a leaked plan
    would wrap every later test's channels), and a time limit."""
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    chaos.uninstall()
    jchaos.uninstall()
    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)
    chaos.uninstall()
    jchaos.uninstall()


# -- the plan grammar and the scenario library --------------------------------

SPECS = [
    "seed=7;drop=0.05;delay=20ms~200ms;dup=0.01;error=0.002;grace=1.5s;"
    "partition=w2:10s@30s,master:500ms@5s",
    "delay=50ms", "", "seed=3;scope=named;drop=1", "partition=127.0.0.1:4001:2s@1",
    "scenario:flaky-rack", "scenario:slow-disk;scope=named;grace=5s",
    "scenario:asym-partition", "scenario:thundering-rejoin", "scenario:router-flap",
    "scenario:flaky-rack;scope=named",
]
TYPOS = ["drop", "drop=2.0", "frobnicate=1", "delay=xyz", "partition=w2",
         "partition=w2:10s", "delay=200ms~20ms", "drop=0.1;scope=everything",
         "scenario:meteor-strike", "seed=x"]


def _as_tuple(plan):
    return (plan.seed, plan.drop, plan.delay, plan.dup, plan.error, plan.grace_s,
            tuple((p.name, p.dur_s, p.at_s) for p in plan.partitions), plan.scope)


@pytest.mark.parametrize("spec", SPECS)
def test_parse_plan_gives_the_jax_plan(spec):
    assert _as_tuple(parse_plan(spec)) == _as_tuple(jchaos.parse_plan(spec))
    assert chaos.resolve_scenario(spec) == jchaos.resolve_scenario(spec)


@pytest.mark.parametrize("spec", TYPOS)
def test_parse_plan_refuses_the_typos_jax_refuses(spec):
    with pytest.raises(ValueError) as jerr:
        jchaos.parse_plan(spec)
    with pytest.raises(ValueError) as terr:
        parse_plan(spec)
    assert str(terr.value) == str(jerr.value)


def test_the_scenario_library_is_jax_s():
    assert chaos.SCENARIOS == jchaos.SCENARIOS
    assert sorted(chaos.SCENARIOS) == ["asym-partition", "flaky-rack", "router-flap",
                                       "slow-disk", "thundering-rejoin"]
    with pytest.raises(ValueError, match="scope"):
        FaultPlan(seed=1, scope="some")


# -- the per-edge decision streams ----------------------------------------------

EDGES = [  # (origin, target, method)
    (("127.0.0.1", 4000), ("127.0.0.1", 4001), "Gradient"),
    (("127.0.0.1", 4001), ("127.0.0.1", 4000), "UpdateGrad"),
    (None, ("127.0.0.1", 4002), "Ping"),
    (("127.0.0.1", 4000), ("127.0.0.1", 4002), "FitStream"),
]


def _states(spec, named):
    states = []
    for mod in (chaos, jchaos):
        st = mod.ChaosState(mod.parse_plan(spec))
        if named:
            st.name_endpoint("127.0.0.1", 4000, "master")
            st.name_endpoint("127.0.0.1", 4001, "w0")
            st.name_endpoint("127.0.0.1", 4002, "w1")
        states.append(st)
    return states


@pytest.mark.parametrize("named", [False, True], ids=["unnamed", "named"])
@pytest.mark.parametrize("spec", [WEATHER, "scenario:flaky-rack",
                                  "seed=11;drop=0.3;error=0.1;dup=0.2;delay=1ms~3ms",
                                  "seed=5;drop=0.5;scope=named"])
def test_the_decision_streams_are_jax_s(spec, named):
    """The same plan on the same edges, called in the same order, makes
    the same decisions in both packages (the same per-edge RNG keys, the
    same draw order), interleaved edges included."""
    tstate, jstate = _states(spec, named)
    calls = [_ChaosCallable(None, m, t, o, tstate) for o, t, m in EDGES]
    jcalls = [jchaos._ChaosCallable(None, m, t, o, jstate) for o, t, m in EDGES]
    rng = np.random.default_rng(0)
    order = rng.integers(0, len(EDGES), 400)
    got = [calls[i]._decide() for i in order]
    want = [jcalls[i]._decide() for i in order]
    assert got == want
    if "scope=named" not in spec or named:
        assert any(a != "pass" for a, _ in got)
    for o, t, m in EDGES:
        assert tstate._canonical(o) == jstate._canonical(o)
        assert [tstate.rng(o, t, m).random() for _ in range(5)] == [
            jstate.rng(o, t, m).random() for _ in range(5)]


def test_the_decisions_count_and_record_each_fault():
    m = mm.Metrics()
    st = ChaosState(parse_plan("seed=1;drop=1.0"), metrics=m)
    assert _ChaosCallable(None, "Gradient", ("h", 1), ("h", 2), st)._decide() == ("drop", None)
    assert m.counter("chaos.injected.drop").value == 1
    st = ChaosState(parse_plan("seed=1;partition=w0:10s@0s"), metrics=m)
    st.name_endpoint("h", 1, "w0")
    assert _ChaosCallable(None, "Ping", ("h", 1), None, st)._decide() == ("drop", None)
    assert m.counter("chaos.injected.partition").value == 1


# -- each fault mode through a real loopback stub -----------------------------


class _PingServicer:
    def Ping(self, request, context):  # noqa: N802
        return pb.Ack()

    def __getattr__(self, name):
        def unimplemented(request, context):
            context.abort(grpc.StatusCode.UNIMPLEMENTED, name)

        return unimplemented


@pytest.fixture()
def ping_server():
    server = new_server(0, host="127.0.0.1")
    add_worker_servicer(server, _PingServicer())
    server.start()
    yield server.bound_port
    server.stop(grace=0)


def _stub(port):
    return WorkerStub(new_channel("127.0.0.1", port))


def test_no_plan_returns_the_raw_channel(ping_server):
    ch = new_channel("127.0.0.1", ping_server)
    assert isinstance(ch, grpc.Channel), "no plan must mean no wrapper"
    chaos.install("seed=1")
    wrapped = new_channel("127.0.0.1", ping_server)
    assert isinstance(wrapped, chaos.ChaosChannel)
    assert wrapped.dsgd_target == ("127.0.0.1", ping_server)  # through __getattr__


def test_an_injected_error_fails_fast(ping_server):
    chaos.install("seed=1;error=1.0")
    with pytest.raises(grpc.RpcError) as err:
        _stub(ping_server).Ping(pb.Empty(), timeout=5.0)
    assert err.value.code() == grpc.StatusCode.UNAVAILABLE
    fut = _stub(ping_server).Ping.future(pb.Empty(), timeout=5.0)
    assert fut.done() and fut.exception().code() == grpc.StatusCode.UNAVAILABLE


def test_a_drop_black_holes_until_the_deadline(ping_server):
    chaos.install("seed=1;drop=1.0")
    stub = _stub(ping_server)
    t0 = time.monotonic()
    fut = stub.Ping.future(pb.Empty(), timeout=0.4)
    with pytest.raises(grpc.RpcError) as err:
        fut.result()
    assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
    assert time.monotonic() - t0 >= 0.35
    seen = []
    fut.add_done_callback(seen.append)  # settled: runs at once
    assert seen == [fut]
    # a deadline-less dropped future stays pending until cancelled
    fut2 = stub.Ping.future(pb.Empty())
    assert not fut2.done()
    assert fut2.cancel() and fut2.cancelled()
    with pytest.raises(grpc.RpcError) as err:
        stub.Ping(pb.Empty(), timeout=0.2)
    assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED


def test_a_delay_rides_the_future_and_keeps_the_deadline(ping_server):
    chaos.install("seed=1;delay=1s")
    stub = _stub(ping_server)
    t0 = time.monotonic()
    fut = stub.Ping.future(pb.Empty(), timeout=10.0)
    assert not fut.done(), "a delay must ride the future, not the caller"
    done = []
    fut.add_done_callback(done.append)
    assert fut.result(timeout=10.0) is not None
    assert time.monotonic() - t0 >= 0.95 and done == [fut]
    t0 = time.monotonic()
    stub.Ping(pb.Empty(), timeout=10.0)  # a blocking call pays it inline
    assert time.monotonic() - t0 >= 0.95
    with pytest.raises(grpc.RpcError) as err:
        stub.Ping(pb.Empty(), timeout=0.05)  # the deadline falls inside the delay
    assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED


def test_a_partition_opens_and_heals(ping_server):
    chaos.install("seed=1;partition=victim:400ms@0s")
    chaos.name_endpoint("127.0.0.1", ping_server, "victim")
    chaos.arm()
    stub = _stub(ping_server)
    with pytest.raises(grpc.RpcError) as err:
        stub.Ping(pb.Empty(), timeout=0.2)
    assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED
    while chaos.state().elapsed() < 0.45:
        time.sleep(0.05)
    assert stub.Ping(pb.Empty(), timeout=5.0) is not None


def test_grace_and_unarmed_plans_inject_nothing(ping_server):
    st = chaos.install("seed=1;drop=1.0", armed=False)
    assert _stub(ping_server).Ping(pb.Empty(), timeout=5.0) is not None
    assert not st.armed
    chaos.install("seed=1;drop=1.0;grace=30s")
    assert _stub(ping_server).Ping(pb.Empty(), timeout=5.0) is not None


def test_scope_named_confines_the_weather(ping_server):
    chaos.install("seed=1;drop=1.0;scope=named")
    assert _stub(ping_server).Ping(pb.Empty(), timeout=5.0) is not None
    chaos.name_endpoint("127.0.0.1", ping_server, "w0")
    with pytest.raises(grpc.RpcError) as err:
        _stub(ping_server).Ping(pb.Empty(), timeout=0.2)
    assert err.value.code() == grpc.StatusCode.DEADLINE_EXCEEDED


def test_a_stream_duplicates_its_frames():
    """The stream wrapper writes a dup frame twice and drops a dropped
    one, as JAX's, message by message."""
    st = ChaosState(parse_plan("seed=3;dup=0.5;drop=0.3"))
    jst = jchaos.ChaosState(jchaos.parse_plan("seed=3;dup=0.5;drop=0.3"))
    ours = chaos._ChaosStreamCallable(lambda it, timeout=None: list(it), "FitStream",
                                      ("h", 1), ("h", 2), st)
    theirs = jchaos._ChaosStreamCallable(lambda it, timeout=None: list(it), "FitStream",
                                         ("h", 1), ("h", 2), jst)
    got = ours(iter(range(40)))
    assert got == theirs(iter(range(40)))
    assert len(set(got)) < 40 and len(got) != len(set(got))


# -- clusters under weather ------------------------------------------------------

D, LAM, B, LR = 128, 1e-5, 16, 0.5


@pytest.fixture(scope="module")
def data():
    train, test = train_test_split(rcv1_like(320, n_features=D, nnz=8, noise=0.0, seed=31,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


@pytest.mark.parametrize("levers", [{}, {"stream": True},
                                    {"fanin_lanes": 2, "stage_pool": 2}],
                         ids=["unary", "stream", "lanes"])
def test_a_dev_cluster_fit_survives_weather_under_a_quorum(data, levers):
    """JAX's soak (tests/test_chaos.py) at its sizes on the port, on the
    unary plane, over streams (a dropped frame, a duplicated one) and with
    the fan-in lanes (the replies read through ``add_done_callback``): the
    fit completes, nobody is evicted, the loss falls, drops were injected,
    and the cluster uninstalls its plan."""
    train, test, ds = data
    model = make_model("hinge", LAM, D, dim_sparsity=ds, device="cpu")
    g = mm.global_metrics()
    drops0 = g.counter("chaos.injected.drop").value
    with DevCluster(model, _torch(train), _torch(test), n_workers=3, chaos=WEATHER) as c:
        assert chaos.state() is not None and chaos.state().armed
        assert {chaos.state()._canonical(("127.0.0.1", w.port)) for w in c.workers} == {
            "w0", "w1", "w2"}
        res = c.master.fit_sync(max_epochs=2, batch_size=B, learning_rate=LR,
                                grad_timeout_s=2.0, quorum=2, straggler_soft_s=0.4, **levers)
        assert len(c.master.members) == 3, "chaos must not evict live workers"
    assert chaos.state() is None, "DevCluster must uninstall its plan"
    assert res.epochs_run == 2 and res.losses[-1] < res.losses[0]
    assert g.counter("chaos.injected.drop").value > drops0


def _mixed_fit(master, workers, mod):
    # named edges: the streams' keys do not depend on the OS-assigned ports
    mod.name_endpoint("127.0.0.1", master.port, "master")
    for i, w in enumerate(workers):
        mod.name_endpoint("127.0.0.1", w.port, f"w{i}")
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        res = master.fit_sync(max_epochs=2, batch_size=B, learning_rate=LR,
                              grad_timeout_s=2.0, quorum=2, straggler_soft_s=0.4)
        members = set(master._workers)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    assert members == {(w.host, w.port) for w in workers}, "a worker was evicted"
    assert res.epochs_run == 2 and res.losses[-1] < res.losses[0]


def test_a_jax_master_under_its_plan_over_port_workers(data):
    train, test, ds = data
    jm = jmm.global_metrics()
    drops0 = jm.counter("chaos.injected.drop").value
    jchaos.install(WEATHER, metrics=jm)
    jmodel = jax_make_model("hinge", LAM, D, dim_sparsity=jnp.asarray(ds))
    tmodel = make_model("hinge", LAM, D, dim_sparsity=ds, device="cpu")
    master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=3, seed=0).start()
    workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train), tmodel,
                          seed=i) for i in range(3)]
    _mixed_fit(master, workers, jchaos)
    assert jm.counter("chaos.injected.drop").value > drops0


def test_a_port_master_under_its_plan_over_jax_workers(data):
    train, test, ds = data
    g = mm.global_metrics()
    drops0 = g.counter("chaos.injected.drop").value
    chaos.install(WEATHER, metrics=g)
    jmodel = jax_make_model("hinge", LAM, D, dim_sparsity=jnp.asarray(ds))
    tmodel = make_model("hinge", LAM, D, dim_sparsity=ds, device="cpu")
    master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                        expected_workers=3, seed=0).start()
    devs = jax.devices()
    workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                         device=devs[i % len(devs)], seed=i) for i in range(3)]
    _mixed_fit(master, workers, chaos)
    assert g.counter("chaos.injected.drop").value > drops0


def test_the_cli_puts_the_plan_on_the_rpc_roles(monkeypatch):
    """DSGD_CHAOS through main(): the dev rpc cluster fits under the plan
    and uninstalls it; the master and worker roles install it before any
    channel exists (the serve role takes it and installs nothing:
    tests/test_torch_serving.py)."""
    from distributed_sgd_tpu_torch import main as tmain
    from distributed_sgd_tpu_torch.config import Config

    for k, v in {"DSGD_ENGINE": "rpc", "DSGD_CHAOS": WEATHER, "DSGD_QUORUM": "2",
                 "DSGD_STRAGGLER_SOFT_S": "0.4", "DSGD_SYNTHETIC": "600",
                 "DSGD_MAX_EPOCHS": "1"}.items():
        monkeypatch.setenv(k, v)
    g = mm.global_metrics()
    before = sum(g.counter(f"chaos.injected.{k}").value for k in ("drop", "delay", "dup"))
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 1 and chaos.state() is None
    assert sum(g.counter(f"chaos.injected.{k}").value for k in ("drop", "delay", "dup")) > before
    tmain._install_chaos(Config())
    assert chaos.state() is None
    tmain._install_chaos(Config(chaos="scenario:flaky-rack", role_override="worker"))
    assert chaos.state().plan == parse_plan("scenario:flaky-rack") and chaos.state().armed
