"""The port's sharded master plane (shardedps/, DSGD_MASTER_SHARDS)
against the JAX package's, on the CPU over real loopback gRPC.

Mirrors tests/test_shardedps.py: ``parse_master_shards`` and the range
plan give the JAX answers (digests included), the worker's
``ShardAssembler`` walks the same install/cached/delta/stale ladder,
computes once a round, and answers stale, abandoned and timed-out rounds
as the JAX one does on the same request sequences.  Mixed clusters hold
both ways: a JAX master's shards over torch workers (before the port
served them, the JAX master lost every worker at once) and a torch
master's over JAX workers, each the JAX cluster's fit; a sharded port fit
is the flat fit bit for bit, with a shard-colored tree too within 1e-5; a
shard killed mid-fit costs one flat round and one rebuild and evicts no
one; with the knob off no coordinator, assembler or shard instrument
exists; and the composition refusals are the JAX words.  Each test runs
under a time limit of its own (`LIMIT_S`)."""

import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core.cluster import DevCluster as JaxCluster
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.rpc import codec as jcodec
from distributed_sgd_tpu.rpc import dsgd_pb2 as jpb
from distributed_sgd_tpu.shardedps import assemble as jassemble
from distributed_sgd_tpu.shardedps import build_shard_plan as jax_build_shard_plan
from distributed_sgd_tpu.shardedps import parse_master_shards as jax_parse_master_shards
from distributed_sgd_tpu.shardedps.plan import slice_ranges as jax_slice_ranges
from distributed_sgd_tpu.utils import metrics as jmetrics
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.shardedps import assemble as tassemble
from distributed_sgd_tpu_torch.shardedps import build_shard_plan, parse_master_shards
from distributed_sgd_tpu_torch.shardedps import coordinator as coord_mod
from distributed_sgd_tpu_torch.shardedps.plan import slice_ranges
from distributed_sgd_tpu_torch.utils import metrics as mm

torch.set_num_threads(1)

D, LAM, B, LR, WORKERS, EPOCHS = 200, 1e-4, 16, 0.5, 3, 2
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


# -- the plan ------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "", 0, "0", 1, "4", 7, "four", "2.5", -1, "-3"])
def test_parse_master_shards_gives_the_jax_answers(value):
    try:
        want = jax_parse_master_shards(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_master_shards(value)
        assert str(got.value) == str(e)
    else:
        assert parse_master_shards(value) == want


@pytest.mark.parametrize("dim,shards", [(128, 4), (127, 4), (7, 3), (10, 10), (129, 2),
                                        (1, 1), (1000, 7), (3, 8), (47236, 2), (47236, 3)])
def test_the_shard_plan_is_the_jax_plan(dim, shards):
    got, want = build_shard_plan(dim, shards), jax_build_shard_plan(dim, shards)
    assert (got.dim, got.shards, got.ranges, got.digest(), repr(got)) == (
        want.dim, want.shards, want.ranges, want.digest(), repr(want))
    assert slice_ranges(got) == jax_slice_ranges(want)
    assert [got.range_of(i) for i in range(got.shards)] == list(want.ranges)


@pytest.mark.parametrize("dim,shards", [(0, 2), (16, 0)])
def test_the_shard_plan_refuses_what_the_jax_plan_refuses(dim, shards):
    with pytest.raises(ValueError) as want:
        jax_build_shard_plan(dim, shards)
    with pytest.raises(ValueError) as got:
        build_shard_plan(dim, shards)
    assert str(got.value) == str(want.value)


# -- the rendezvous ------------------------------------------------------------


def _req(pbmod, codecmod, fit_token, shard_round, index, count, lo, hi, w=None, version=1,
         delta=None):
    req = pbmod.GradientRequest(samples=[0, 1], fit_token=fit_token, shard_index=index,
                                shard_count=count, shard_lo=lo, shard_hi=hi,
                                shard_round=shard_round, step_version=version)
    if w is not None:
        req.weights.CopyFrom(codecmod.encode_tensor(np.ascontiguousarray(w[lo:hi])))
    if delta is not None:
        req.delta.CopyFrom(delta)
    return req


def _legs(asm, reqs, compute):
    """Run one round's legs concurrently (the first ones in threads, the
    last on this one); returns each leg's result."""
    out = [None] * len(reqs)

    def leg(i):
        out[i] = asm.gradient(reqs[i], compute)

    threads = [threading.Thread(target=leg, args=(i,), daemon=True) for i in range(len(reqs) - 1)]
    for t in threads:
        t.start()
    time.sleep(0.05)  # the earlier legs park in the rendezvous
    leg(len(reqs) - 1)
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    return out


def _ladder_script(mod, pbmod, codecmod, metrics, monkeypatch):
    """One request sequence through a ShardAssembler: a full round, a
    delta round, a new fit token's stale delta, a poisoned round, a
    timed-out leg and abandoned rounds; returns everything it saw."""
    asm = mod.ShardAssembler(metrics=metrics)
    calls = []

    def compute(w, ids):
        calls.append((w.copy(), ids.copy()))
        return w * 2.0

    seen = []
    w1 = np.arange(8, dtype=np.float32)
    seen.append(_legs(asm, [_req(pbmod, codecmod, 9, 1, 0, 2, 0, 4, w1),
                            _req(pbmod, codecmod, 9, 1, 1, 2, 4, 8, w1)], compute))
    w2 = w1.copy()
    w2[5] = 42.0
    delta = codecmod.encode_weight_delta(w2[4:8], w1[4:8], base_version=1)
    seen.append(_legs(asm, [_req(pbmod, codecmod, 9, 2, 1, 2, 4, 8, version=2, delta=delta),
                            _req(pbmod, codecmod, 9, 2, 0, 2, 0, 4, w2, version=2)], compute))
    # a retry of round 2 with header-only legs: the cached slices
    seen.append(_legs(asm, [_req(pbmod, codecmod, 9, 3, 0, 2, 0, 4, version=2),
                            _req(pbmod, codecmod, 9, 3, 1, 2, 4, 8, version=2)], compute))
    # a new fit token drops the residents: the same delta is stale
    seen.append([asm.gradient(_req(pbmod, codecmod, 10, 1, 1, 2, 4, 8, version=2,
                                   delta=delta), compute)])
    # an unresolvable leg poisons its sibling
    seen.append([asm.gradient(_req(pbmod, codecmod, 11, 1, 1, 2, 4, 8), compute),
                 asm.gradient(_req(pbmod, codecmod, 11, 1, 0, 2, 0, 4, w1), compute)])
    monkeypatch.setattr(mod, "ASSEMBLE_BUDGET_S", 0.05)
    seen.append([asm.gradient(_req(pbmod, codecmod, 12, 1, 0, 2, 0, 4, w1), compute)])
    with asm._cv:
        rounds = [asm._round_for(("t", i)) for i in range(mod.MAX_PENDING_ROUNDS + 3)]
    seen.append([(rd.stale, rd.done) for rd in rounds] + [len(asm._rounds)])
    seen.append([(c[0].tolist(), c[1].tolist()) for c in calls])
    seen.append([metrics.counter(n).value for n in ("slave.shard.assembled",
                                                     "slave.shard.timeouts")])
    return [[x.tolist() if isinstance(x, np.ndarray) else x for x in step] for step in seen]


def test_the_rendezvous_walks_the_jax_ladder(monkeypatch):
    assert (tassemble.MAX_PENDING_ROUNDS, tassemble.ASSEMBLE_BUDGET_S) == (
        jassemble.MAX_PENDING_ROUNDS, jassemble.ASSEMBLE_BUDGET_S)
    got = _ladder_script(tassemble, pb, codec, mm.Metrics(), monkeypatch)
    want = _ladder_script(jassemble, jpb, jcodec, jmetrics.Metrics(), monkeypatch)
    assert got == want
    # once a round for the three rounds that computed
    assert len(got[7]) == 3


def test_a_failed_compute_wakes_the_other_legs_at_once():
    asm = tassemble.ShardAssembler(metrics=mm.Metrics())
    w = np.ones(8, np.float32)

    def boom(w, ids):
        raise ValueError("ids outside the slice")

    box = {}
    t = threading.Thread(target=lambda: box.update(
        leg0=asm.gradient(_req(pb, codec, 3, 1, 0, 2, 0, 4, w), boom)), daemon=True)
    t.start()
    time.sleep(0.05)
    t0 = time.monotonic()
    with pytest.raises(ValueError):
        asm.gradient(_req(pb, codec, 3, 1, 1, 2, 4, 8, w), boom)
    t.join(timeout=30)
    assert box["leg0"] is None and time.monotonic() - t0 < 1.0


# -- clusters --------------------------------------------------------------------


def test_a_jax_master_with_shards_over_torch_workers(data):
    """Fails on the port before the shards: every leg answered
    UNIMPLEMENTED and the JAX master lost every worker at once."""
    train, test, _ = data
    jmodel, tmodel = _models(data)
    jm = jmetrics.global_metrics()
    ev0 = jm.counter(jmetrics.MASTER_EVICTIONS).value
    asm0 = mm.global_metrics().counter(mm.SHARD_ASSEMBLED).value
    master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=WORKERS,
                       seed=0).start()
    workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train), tmodel,
                          seed=i) for i in range(WORKERS)]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        got = master.fit_sync(EPOCHS, B, LR, grad_timeout_s=15.0, master_shards=2)
        members = set(master._workers)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    _assert_close_fit(got, _jax_fit(data, master_shards=2))
    assert members == {(w.host, w.port) for w in workers}
    assert jm.counter(jmetrics.MASTER_EVICTIONS).value == ev0
    # one rendezvous a worker a round
    assert mm.global_metrics().counter(mm.SHARD_ASSEMBLED).value - asm0 == WORKERS * EPOCHS * 10


@pytest.mark.parametrize("kw", [dict(master_shards=2), dict(master_shards=2, agg_tree="fanout:2")],
                         ids=["shards", "shards+tree"])
def test_a_torch_master_with_shards_over_jax_workers(data, kw):
    train, test, _ = data
    jmodel, tmodel = _models(data)
    m = mm.Metrics()
    asm0 = jmetrics.global_metrics().counter(jmetrics.SHARD_ASSEMBLED).value
    master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                        expected_workers=WORKERS, seed=0, metrics=m).start()
    devs = jax.devices()
    workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                         device=devs[i % len(devs)], seed=i) for i in range(WORKERS)]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        got = master.fit_sync(EPOCHS, B, LR, grad_timeout_s=15.0, **kw)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    _assert_close_fit(got, _jax_fit(data, **kw))
    assert m.counter(mm.MASTER_EVICTIONS).value == 0
    assert m.counter(mm.SHARD_ROUNDS).value == EPOCHS * 10
    assert jmetrics.global_metrics().counter(jmetrics.SHARD_ASSEMBLED).value > asm0
    lanes = master._last_shard_bytes
    assert [i for i, _, _ in lanes] == [0, 1] and all(b > 0 and g > 0 for _, b, g in lanes)


def test_a_sharded_torch_fit_is_the_flat_fit_bit_for_bit(data):
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS, seed=0,
                    metrics=m) as c:
        flat = c.master.fit_sync(EPOCHS, B, LR)
        calls = []
        for w in c.workers:
            orig = w.compute_gradient

            def count(wv, ids, _orig=orig):
                calls.append(1)
                return _orig(wv, ids)

            w.compute_gradient = count
        m2 = c.master.fit_sync(EPOCHS, B, LR, master_shards=2)
        m3 = c.master.fit_sync(EPOCHS, B, LR, master_shards=3, delta_broadcast=True)
    for got in (m2, m3):
        np.testing.assert_array_equal(np.asarray(got.weights), np.asarray(flat.weights))
        assert got.test_losses == flat.test_losses
    _assert_close_fit(m2, _jax_fit(data, master_shards=2))
    # one gradient a worker a round, whatever the lane count
    assert len(calls) == 2 * WORKERS * EPOCHS * 10
    assert m.counter(mm.SHARD_ASSEMBLED).value == len(calls)
    assert m.counter(mm.SYNC_BCAST_DELTA).value > 0


def test_sharded_trees_are_repeatable_and_close_to_flat(data):
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=5, seed=0,
                    metrics=m) as c:
        flat = c.master.fit_sync(EPOCHS, B, LR)
        a = c.master.fit_sync(EPOCHS, B, LR, master_shards=2, agg_tree="fanout:2")
        b = c.master.fit_sync(EPOCHS, B, LR, master_shards=2, agg_tree="fanout:2")
    np.testing.assert_array_equal(np.asarray(a.weights), np.asarray(b.weights))
    _assert_close_fit(a, flat)
    assert m.counter(mm.AGG_CHILDREN).value > 0 and m.counter(mm.AGG_PARTIAL).value == 0


def test_a_shard_killed_mid_fit_costs_one_flat_round(data):
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS, seed=0,
                    metrics=m) as c:
        flat = c.master.fit_sync(3, B, LR)
        r0 = m.counter(mm.SYNC_ROUNDS).value
        box = {}
        t = threading.Thread(target=lambda: box.update(
            fit=c.master.fit_sync(3, B, LR, master_shards=3)), daemon=True)
        t.start()
        t_end = time.monotonic() + 30
        while m.counter(mm.SYNC_ROUNDS).value < r0 + 2 and time.monotonic() < t_end:
            time.sleep(0.002)
        c.master.kill_shard(1)
        t.join(timeout=60)
        assert not t.is_alive()
        members = c.master.members
        with pytest.raises(RuntimeError, match="no sharded fit"):
            c.master.kill_shard(0)
    assert box["fit"].epochs_run == 3 and len(members) == WORKERS
    assert m.counter(mm.SHARD_FALLBACK_ROUNDS).value == 1
    assert m.counter(mm.SHARD_REBUILDS).value == 1
    assert m.counter(mm.MASTER_EVICTIONS).value == 0
    assert m.gauge(mm.SHARD_COUNT).value == 2
    np.testing.assert_array_equal(np.asarray(box["fit"].weights), np.asarray(flat.weights))
    assert [i for i, _, _ in c.master._last_shard_bytes] == [0, 1]


def test_knobs_off_builds_no_coordinator_or_assembler_and_no_instrument(data, monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("ShardedCoordinator built with the knob off")

    monkeypatch.setattr(coord_mod, "ShardedCoordinator", boom)
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2, seed=0,
                    metrics=m) as c:
        assert c.master.fit_sync(1, B, LR).epochs_run == 1
        assert all(w._shard_asm is None for w in c.workers)
    names = {x.name for x in m.counters()} | {x.name for x in m.gauges()}
    assert not [n for n in names if n.startswith(("master.shard.", "slave.shard."))]


# -- refusals and the CLI ----------------------------------------------------------


@pytest.mark.parametrize("kw", [dict(stream=True), dict(quorum=1), dict(local_steps=2),
                                dict(fanin_lanes=2), dict(stage_pool=2)],
                         ids=lambda kw: next(iter(kw)))
def test_the_composition_refusals_are_the_jax_masters(data, kw):
    train, test, _ = data
    with JaxCluster(_models(data)[0], train, test, n_workers=1, seed=0) as c:
        with pytest.raises(ValueError) as want:
            c.master.fit_sync(1, B, LR, master_shards=2, **kw)
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        with pytest.raises(ValueError) as got:
            c.master.fit_sync(1, B, LR, master_shards=2, **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw", [dict(master_shards=-1), dict(master_shards=2, stage_pool=2),
                                dict(master_shards=2, fanin_lanes=1),
                                dict(master_shards=2, quorum=2)],
                         ids=["negative", "stage_pool", "fanin_lanes", "quorum"])
def test_the_config_refuses_with_the_jax_configs_words(kw):
    from distributed_sgd_tpu.config import Config as JaxConfig

    with pytest.raises(ValueError) as want:
        JaxConfig(**kw)
    with pytest.raises(ValueError) as got:
        Config(**kw)
    assert str(got.value) == str(want.value)


def test_the_shards_reach_fit_sync_on_the_dev_rpc_engine(monkeypatch):
    seen = []
    real = MasterNode.fit_sync

    def spy(self, *a, **kw):
        seen.append(kw)
        return real(self, *a, **kw)

    monkeypatch.setattr(MasterNode, "fit_sync", spy)
    for k, v in {"DSGD_ENGINE": "rpc", "DSGD_SYNTHETIC": "600", "DSGD_MAX_EPOCHS": "1",
                 "DSGD_NODE_COUNT": "2", "DSGD_MASTER_SHARDS": "2",
                 "DSGD_DELTA_BROADCAST": "1"}.items():
        monkeypatch.setenv(k, v)
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 1
    (kw,) = seen
    assert (kw["master_shards"], kw["delta_broadcast"]) == (2, True)
