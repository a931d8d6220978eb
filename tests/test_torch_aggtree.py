"""The port's aggregation tree (aggtree/, DSGD_AGG_TREE) against the JAX
package's, on the CPU over real loopback gRPC.

Mirrors tests/test_aggtree.py: ``build_plan`` is the JAX builder's (the
same digest, parents, children and heights for every membership),
``parse_agg_tree`` gives the JAX answers and refusals, the port's
``Reducer.reduce`` (sequential f32 adds on the worker's device) is the JAX
add chain bit for bit, and its buffer ages rounds out as the JAX one
does.  Mixed clusters hold both ways: a JAX master's tree over torch
workers (before the port served it, the JAX master evicted two of the
three workers) and a torch master's tree over JAX workers, each the JAX
cluster's fit.  A 5-worker tree with streams sums every child, a parent
killed mid-fit costs one flat round and no fit, and with the knob off no
reducer and no tree instrument exists.  Each test runs under a time limit
of its own (`LIMIT_S`)."""

import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.aggtree import build_plan as jax_build_plan
from distributed_sgd_tpu.aggtree import parse_agg_tree as jax_parse_agg_tree
from distributed_sgd_tpu.aggtree import reduce as jreduce
from distributed_sgd_tpu.core.cluster import DevCluster as JaxCluster
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.rpc import codec as jcodec
from distributed_sgd_tpu.rpc import dsgd_pb2 as jpb
from distributed_sgd_tpu.utils import metrics as jmetrics
from distributed_sgd_tpu_torch import aggtree
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.aggtree import build_plan, parse_agg_tree
from distributed_sgd_tpu_torch.aggtree import reduce as treduce
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

D, LAM, B, LR, WORKERS, EPOCHS = 200, 1e-4, 16, 0.5, 3, 2
LIMIT_S = 90  # each test's own time limit, seconds
TREE = "fanout:2"


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


def _assert_close_fit(got, want, atol=1e-5):
    assert got.epochs_run == want.epochs_run
    np.testing.assert_allclose(got.test_losses, want.test_losses, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.weights), np.asarray(want.weights), atol=atol)


_jax_fits = {}


def _jax_fit(data, **kw):
    """The JAX cluster's fit with `kw` (3 JAX workers, seed 0), cached."""
    key = tuple(sorted(kw.items()))
    if key not in _jax_fits:
        train, test, _ = data
        with JaxCluster(_models(data)[0], train, test, n_workers=WORKERS, seed=0) as c:
            _jax_fits[key] = c.master.fit_sync(EPOCHS, B, LR, **kw)
    return _jax_fits[key]


def _mixed_fit(data, jax_master: bool, **kw):
    """A JAX master over 3 torch workers (`jax_master`), or a torch master
    over 3 JAX workers, none of them evicted; returns (fit, master)."""
    train, test, _ = data
    jmodel, tmodel = _models(data)
    if jax_master:
        master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=WORKERS,
                           seed=0).start()
        workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train), tmodel,
                              seed=i) for i in range(WORKERS)]
    else:
        master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                            expected_workers=WORKERS, seed=0, metrics=mm.Metrics()).start()
        devs = jax.devices()
        workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                             device=devs[i % len(devs)], seed=i) for i in range(WORKERS)]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        fit = master.fit_sync(EPOCHS, B, LR, grad_timeout_s=15.0, **kw)
        members = set(master._workers)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    assert members == {(w.host, w.port) for w in workers}, "a worker was evicted"
    return fit, master


# -- the plan ------------------------------------------------------------------


def _members(n, hosts):
    return [(f"10.0.0.{i % hosts}", 7000 + i) for i in range(n)]


@pytest.mark.parametrize("hosts", [1, 3])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("fanout", [2, 3, 4])
def test_build_plan_is_the_jax_plan(fanout, seed, hosts):
    for n in range(1, 13):
        keys = _members(n, hosts)
        got, want = build_plan(keys, fanout, seed=seed), jax_build_plan(keys, fanout, seed=seed)
        assert got.digest() == want.digest()
        assert (got.keys, got.parent, got.children, got.height) == (
            want.keys, want.parent, want.children, want.height)
        assert (got.depth, got.n_edges, got.trivial, got.aggregators(), repr(got)) == (
            want.depth, want.n_edges, want.trivial, want.aggregators(), repr(want))


@pytest.mark.parametrize("spec", [None, "", "fanout:2", "fanout:7", "fanout:1", "fanout:x",
                                  "fan:2", "fanout", "fanout:2:3"])
def test_parse_agg_tree_gives_the_jax_answers(spec):
    try:
        want = jax_parse_agg_tree(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_agg_tree(spec)
        assert str(got.value) == str(e)
    else:
        assert parse_agg_tree(spec) == want


@pytest.mark.parametrize("bad", [dict(fanout=1), dict(keys=[("h", 1), ("h", 1)])])
def test_build_plan_refuses_what_the_jax_builder_refuses(bad):
    kw = {"keys": [("h", 1), ("h", 2)], "fanout": 2, **bad}
    with pytest.raises(ValueError) as want:
        jax_build_plan(**kw)
    with pytest.raises(ValueError) as got:
        build_plan(**kw)
    assert str(got.value) == str(want.value)


# -- the reducer ---------------------------------------------------------------


class _FakeWorker:
    def __init__(self, metrics):
        self.metrics = metrics
        self.node_label = "h:0"
        self.device = torch.device("cpu")


@pytest.mark.parametrize("n_children", [1, 2, 3, 4])
def test_reduce_is_the_jax_add_chain_bit_for_bit(n_children):
    rng = np.random.default_rng(40 + n_children)
    own = (rng.normal(size=D) * rng.choice([1e-3, 1.0, 1e3], size=D)).astype(np.float32)
    kids = []
    for i in range(n_children):
        g = (rng.normal(size=D) * 10.0 ** rng.integers(-4, 4, size=D)).astype(np.float32)
        g[rng.random(D) < (0.8 if i % 2 else 0.1)] = 0.0  # sparse and dense arms
        kids.append(g)
    got = treduce.Reducer(_FakeWorker(mm.Metrics())).reduce(
        own, [codec.encode_grad(g) for g in kids])
    want = jreduce.Reducer(_FakeWorker(jmetrics.Metrics())).reduce(
        own, [jcodec.encode_grad(g) for g in kids])
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # the order is the stamped one: a pairwise sum would land elsewhere
    assert treduce.Reducer(_FakeWorker(mm.Metrics())).reduce(own, []) is own


def test_a_parent_adds_its_children_in_the_stamped_order(data):
    """The children's pushes land c:1 first, but the stamp says c:2, c:1:
    own + g[c:2] + g[c:1] in f32, which the arrival order would round
    elsewhere (0.5 + 1 + 2**24 against 0.5 + 2**24 + 1)."""
    from distributed_sgd_tpu_torch.core.worker import _WorkerServicer

    train, _, _ = data
    node = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), _models(data)[1])
    try:
        own = np.full(D, 0.5, np.float32)
        kids = {"c:1": np.full(D, 2.0 ** 24, np.float32), "c:2": np.ones(D, np.float32)}
        for origin in ("c:1", "c:2"):  # arrival order
            node._ensure_reducer().offer(4, 1, origin, codec.encode_grad(kids[origin]))
        req = pb.GradientRequest(fit_token=4, agg_round=1, agg_children=["c:2", "c:1"],
                                 agg_wait_ms=5000)
        msg = _WorkerServicer(node)._agg_gradient(req, own, 1)
    finally:
        node.server.stop(None)
        node._master_channel.close()
    got = codec.decode_grad(msg)
    stamped = (own + kids["c:2"]) + kids["c:1"]
    arrival = (own + kids["c:1"]) + kids["c:2"]
    assert not np.array_equal(stamped, arrival)
    np.testing.assert_array_equal(got, stamped)
    assert list(msg.agg_contributors) == [node.node_label, "c:2", "c:1"]
    assert not msg.agg_partial and not msg.agg_forwarded


def _buffer_script(reducer, encode, pbmod):
    """One request sequence: pushes out of order, a collect, a partial
    collect on timeout, and more rounds than the buffer holds."""
    out = []
    for origin in ("c:2", "c:1"):
        reducer.offer(1, 5, origin, encode(np.full(4, float(origin[-1]), np.float32)))
    got = reducer.collect(1, 5, ["c:1", "c:2"], wait_s=1.0)
    out.append([(k, list(v.dense.data)) for k, v in got.items()])
    out.append(sorted(reducer.collect(1, 5, ["c:1", "c:2"], wait_s=0.0)))
    reducer.offer(1, 6, "c:1", encode(np.ones(4, np.float32)))
    out.append(sorted(reducer.collect(1, 6, ["c:1", "c:2"], wait_s=0.2)))
    for r in range(treduce.MAX_PENDING_ROUNDS + 4):
        reducer.offer(2, r, "c:1", pbmod.GradUpdate())
    out.append(list(reducer._rounds))
    out.append(reducer.bytes_in.value)
    return out


def test_the_buffer_ages_rounds_out_as_the_jax_buffer():
    assert treduce.MAX_PENDING_ROUNDS == jreduce.MAX_PENDING_ROUNDS
    got = _buffer_script(treduce.Reducer(_FakeWorker(mm.Metrics())), codec.encode_grad, pb)
    want = _buffer_script(jreduce.Reducer(_FakeWorker(jmetrics.Metrics())),
                          jcodec.encode_grad, jpb)
    assert got == want


@pytest.mark.parametrize("ms", [0, 250, 12000])
def test_wait_budget_is_the_jax_budget(ms):
    assert (treduce.wait_budget_s(pb.GradientRequest(agg_wait_ms=ms))
            == jreduce.wait_budget_s(jpb.GradientRequest(agg_wait_ms=ms)))


def test_annotations_are_the_jax_masters(data):
    keys = _members(7, 2)
    for fanout in (2, 3):
        plan, jplan = build_plan(keys, fanout, seed=1), jax_build_plan(keys, fanout, seed=1)
        for key in keys:
            got, want = pb.GradientRequest(), jpb.GradientRequest()
            MasterNode._annotate_tree(got, key, plan, 9, 30.0)
            JaxMaster._annotate_tree(want, key, jplan, 9, 30.0)
            assert got.SerializeToString() == want.SerializeToString()


# -- clusters --------------------------------------------------------------------


def test_a_jax_master_with_a_tree_over_torch_workers(data):
    """Fails on the port before the tree: the workers answered the stamped
    requests UNIMPLEMENTED and the JAX master evicted two of them."""
    jm = jmetrics.global_metrics()
    ev0 = jm.counter(jmetrics.MASTER_EVICTIONS).value
    kids0 = mm.global_metrics().counter(mm.AGG_CHILDREN).value
    got, _ = _mixed_fit(data, True, agg_tree=TREE)
    _assert_close_fit(got, _jax_fit(data, agg_tree=TREE))
    assert jm.counter(jmetrics.MASTER_EVICTIONS).value == ev0
    assert mm.global_metrics().counter(mm.AGG_CHILDREN).value > kids0


def test_a_torch_master_with_a_tree_over_jax_workers(data):
    kids0 = jmetrics.global_metrics().counter(jmetrics.AGG_CHILDREN).value
    got, master = _mixed_fit(data, False, agg_tree=TREE)
    _assert_close_fit(got, _jax_fit(data, agg_tree=TREE))
    assert jmetrics.global_metrics().counter(jmetrics.AGG_CHILDREN).value > kids0
    assert master.metrics.gauge(mm.TREE_EDGES).value == 1
    assert master.metrics.counter(mm.MASTER_EVICTIONS).value == 0


@pytest.mark.parametrize("kw", [dict(), dict(local_steps=4), dict(delta_broadcast=True,
                                                                   fanin_lanes=2)],
                         ids=["k1", "local_steps", "delta_lanes"])
def test_a_torch_cluster_with_a_tree_is_the_jax_clusters(data, kw):
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS, seed=0,
                    metrics=m) as c:
        got = c.master.fit_sync(EPOCHS, B, LR, agg_tree=TREE, **kw)
        again = c.master.fit_sync(EPOCHS, B, LR, agg_tree=TREE, **kw)
    _assert_close_fit(got, _jax_fit(data, agg_tree=TREE, **kw))
    # one plan, one add order: the same bits
    np.testing.assert_array_equal(np.asarray(again.weights), np.asarray(got.weights))
    assert m.counter(mm.AGG_CHILDREN).value > 0 and m.counter(mm.AGG_PARTIAL).value == 0


def test_a_five_worker_tree_with_streams_reduces_every_child(data):
    """Depth 2: each parent's Gradient body waits in collect while its
    children's AggregateGrad calls and stream frames hold other server
    threads; a starved pool would show up as partial sums."""
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=5, seed=0,
                    metrics=m) as c:
        flat = c.master.fit_sync(EPOCHS, B, LR)
        got = c.master.fit_sync(EPOCHS, B, LR, agg_tree=TREE, stream=True,
                                delta_broadcast=True)
        rounds = m.counter(mm.SYNC_ROUNDS).value // 2
    assert m.gauge(mm.TREE_DEPTH).value == 2 and m.gauge(mm.TREE_EDGES).value == 3
    assert m.counter(mm.AGG_PARTIAL).value == 0 and m.counter(mm.TREE_PARTIAL).value == 0
    assert m.counter(mm.AGG_CHILDREN).value == 3 * rounds
    assert m.counter(mm.STREAM_SENDS).value > 0 and m.counter(mm.STREAM_FALLBACK).value == 0
    _assert_close_fit(got, flat)


def test_a_parent_killed_mid_fit_costs_a_flat_round_not_the_fit(data):
    """5 workers, fanout 2, seed 0: worker 3 aggregates worker 4.  Worker 3
    dies with no unregistration; worker 4's push fails and it replies to
    the master itself (slave.agg.flat), the master evicts worker 3,
    rebuilds the tree and finishes the fit on four workers."""
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=5, seed=0,
                    metrics=m) as c:
        keys = c.master.members
        parent, child = c.workers[3], c.workers[4]
        assert build_plan(keys, 2).parent[(child.host, child.port)] == (parent.host,
                                                                         parent.port)
        box = {}
        t = threading.Thread(target=lambda: box.update(
            fit=c.master.fit_sync(4, B, LR, agg_tree=TREE, grad_timeout_s=10.0)), daemon=True)
        t.start()
        t_end = time.monotonic() + 30
        while m.counter(mm.SYNC_ROUNDS).value < 3 and time.monotonic() < t_end:
            time.sleep(0.005)
        parent._stopped.set()
        parent.server.stop(grace=0)
        t.join(timeout=60)
        assert not t.is_alive(), "the tree fit hung after its parent died"
        members = c.master.members
    assert box["fit"].epochs_run == 4
    assert (parent.host, parent.port) not in members and len(members) == 4
    assert child.metrics.counter(mm.AGG_FLAT).value > 0
    assert m.counter(mm.TREE_REBUILDS).value == 1 and m.counter(mm.MASTER_EVICTIONS).value == 1


def test_knobs_off_builds_no_plan_or_reducer_and_registers_no_instrument(data, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("build_plan called with the knob off")

    monkeypatch.setattr(aggtree, "build_plan", boom)
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2, seed=0,
                    metrics=m) as c:
        seen = []
        for w in c.workers:
            orig = w.resolve_request_weights

            def spy(request, _orig=orig):
                seen.append((request.agg_parent, list(request.agg_children), request.agg_round,
                             request.agg_wait_ms))
                return _orig(request)

            w.resolve_request_weights = spy
        assert c.master.fit_sync(1, B, LR).epochs_run == 1
        assert all(w._agg is None for w in c.workers)
    names = {x.name for x in m.counters()} | {x.name for x in m.gauges()}
    assert not [n for n in names if n.startswith(("master.tree.", "slave.agg."))]
    assert seen and all(s == ("", [], 0, 0) for s in seen)


def test_a_trivial_plan_stamps_nothing(data):
    """N <= F: no aggregator, the wire is the flat fit's and so are the
    weights, bit for bit."""
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2, seed=0) as c:
        flat = c.master.fit_sync(EPOCHS, B, LR)
        got = c.master.fit_sync(EPOCHS, B, LR, agg_tree=TREE)
        assert all(w._agg is None for w in c.workers)
    np.testing.assert_array_equal(np.asarray(got.weights), np.asarray(flat.weights))


# -- the CLI ---------------------------------------------------------------------


def test_the_tree_reaches_fit_sync_on_the_dev_rpc_engine(monkeypatch):
    seen = []
    real = MasterNode.fit_sync

    def spy(self, *a, **kw):
        seen.append(kw)
        return real(self, *a, **kw)

    monkeypatch.setattr(MasterNode, "fit_sync", spy)
    for k, v in {"DSGD_ENGINE": "rpc", "DSGD_SYNTHETIC": "600", "DSGD_MAX_EPOCHS": "1",
                 "DSGD_NODE_COUNT": "3", "DSGD_AGG_TREE": TREE}.items():
        monkeypatch.setenv(k, v)
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 1
    (kw,) = seen
    assert kw["agg_tree"] == TREE


@pytest.mark.parametrize("spec", ["fanout:1", "fanout:x", "tree:2"])
def test_the_config_refuses_the_jax_configs_tree_specs(spec):
    with pytest.raises(ValueError) as want:
        jax_parse_agg_tree(spec)
    with pytest.raises(ValueError) as got:
        Config(agg_tree=spec)
    assert str(got.value) == str(want.value)
