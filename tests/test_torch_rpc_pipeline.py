"""The port's pipelined sync RPC engine against the JAX package's, on the
CPU over real loopback gRPC: the K-step local window (core/worker.py
``compute_local_window``, one ``sync_epoch`` launch on the card through
``parallel.sync.WindowSteps``), the versioned weights
(``resolve_request_weights``), the FitStream transport (rpc/stream.py and
the worker's servicer), the fan-in lanes (``_ArrivalDecoder``), the stage
pool (``_DispatchStager``) and their wiring in ``fit_sync``.

Mirrors tests/test_sync_pipeline.py, tests/test_stream.py and
tests/test_fanin_lanes.py.  Each lever's port cluster lands within 1e-5
of the JAX cluster's on the same numpy data and seed; at K=1 every lever
gives the knobs-off fit's weights bit for bit; with every lever off the
requests carry no pipeline field.  Mixed clusters hold both ways: a JAX
master with local steps, delta broadcasts and streams over torch workers
(a worker without them answers UNIMPLEMENTED, and the JAX master evicts
it), and a torch master with them over JAX workers.  Each test runs under a time limit of
its own (`LIMIT_S`)."""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core import master as jmaster_mod
from distributed_sgd_tpu.core.cluster import DevCluster as JaxCluster
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.rpc import codec as jcodec
from distributed_sgd_tpu.utils import metrics as jmetrics
from distributed_sgd_tpu.utils import pool as jpool
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core import master as master_mod
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.parallel import sync as psync
from distributed_sgd_tpu_torch.rpc import codec, dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.stream import FitStreamClient, StreamRpcError
from distributed_sgd_tpu_torch.utils import metrics as mm
from distributed_sgd_tpu_torch.utils import pool

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
    # 600 rows: 480 train, 160 a worker; at K=4 and B=16 a window spans 64
    # ids, so each epoch ends on a short window of 2 steps
    train, test = train_test_split(rcv1_like(600, n_features=D, nnz=10, seed=11,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _models(data, name="hinge"):
    _, _, ds = data
    return (jax_make_model(name, LAM, D, dim_sparsity=jnp.asarray(ds)),
            make_model(name, LAM, D, dim_sparsity=ds, device="cpu"))


def _assert_close_fit(got, want, atol=1e-5):
    assert got.epochs_run == want.epochs_run
    np.testing.assert_allclose(got.test_losses, want.test_losses, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got.weights), np.asarray(want.weights), atol=atol)


# -- the K-step window --------------------------------------------------------


@pytest.fixture(scope="module")
def lone_workers(data):
    """A port worker and a JAX worker over the same train rows, neither
    registered (their bodies are called directly)."""
    train, _, _ = data
    jmodel, tmodel = _models(data)
    jw = JaxWorker("127.0.0.1", 0, "127.0.0.1", 1, train, jmodel, device=jax.devices()[0])
    tw = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), tmodel)
    yield jw, tw
    for w in (jw, tw):
        w.server.stop(None)
        w._master_channel.close()


WINDOWS = {  # name: (ids sent, k, batch size)
    "full": (64, 4, 16),
    "short": (55, 4, 16),  # 3 full steps and a tail of 7
    "excess": (90, 4, 16),  # the ids past k * B are dropped
    "one_step": (16, 1, 16),
    "tail_only": (5, 4, 16),
}


@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_local_window_matches_the_jax_window(lone_workers, case):
    jw, tw = lone_workers
    n, k, bs = WINDOWS[case]
    rng = np.random.default_rng(5)
    ids = rng.choice(480, size=n, replace=False).astype(np.int64)
    w = (rng.normal(size=D) * 0.1).astype(np.float32)
    want = jw.compute_local_window(w, ids, k, bs, LR)
    got = tw.compute_local_window(w, ids, k, bs, LR)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got.dtype == np.float32 and got.shape == (D,)


def test_a_one_step_window_is_lr_times_the_gradient(lone_workers):
    """At K=1 the window's decrement is lr * compute_gradient (the JAX
    docstring's identity), within an ulp or two of the product."""
    _, tw = lone_workers
    rng = np.random.default_rng(8)
    ids = rng.choice(480, size=B, replace=False)
    w = (rng.normal(size=D) * 0.1).astype(np.float32)
    np.testing.assert_allclose(tw.compute_local_window(w, ids, 1, B, LR),
                               LR * tw.compute_gradient(w, ids), rtol=0, atol=1e-6)


def test_the_window_fallback_route_matches_the_one_launch_route(lone_workers, monkeypatch):
    """Where cluster_plan says no (D > 154,848), the window runs one
    worker_grads launch a step: the same decrement."""
    _, tw = lone_workers
    rng = np.random.default_rng(9)
    ids = rng.choice(480, size=55, replace=False)
    w = (rng.normal(size=D) * 0.1).astype(np.float32)
    fused = tw.compute_local_window(w, ids, 4, B, LR)
    monkeypatch.setattr(psync, "cluster_plan", lambda *a, **k: None)
    assert not psync.WindowSteps(tw.model, tw._resident.idx, tw._resident.val,
                                 tw._resident.y, LR).fused
    np.testing.assert_allclose(tw.compute_local_window(w, ids, 4, B, LR), fused, atol=1e-6)


def test_the_window_is_one_sum_mode_sgd_launch(lone_workers, monkeypatch):
    """The window reaches sync_epoch once, in the sum mode: grad_divisor 1,
    n_total_workers 1, plain sgd at the request's lr, ids [S, 1, B] with
    the sentinel row past the resident rows in the tail."""
    _, tw = lone_workers
    calls = []
    real = psync.sync_epoch

    def spy(w, ids, *args, **kw):
        calls.append((ids.clone(), kw))
        return real(w, ids, *args, **kw)

    monkeypatch.setattr(psync, "sync_epoch", spy)
    ids = np.arange(40, dtype=np.int64)
    tw.compute_local_window(np.zeros(D, np.float32), ids, 4, B, 0.25)
    (got_ids, kw), = calls
    assert tuple(got_ids.shape) == (3, 1, B)
    assert kw["grad_divisor"] == 1 and kw["n_total_workers"] == 1 and kw["lr"] == 0.25
    assert kw["optimizer"].kind == "sgd"
    flat = got_ids.flatten().numpy()
    assert (flat[:40] == ids).all() and (flat[40:] == tw.n_rows).all()


# -- the versioned weights ----------------------------------------------------


def _full(w, version, tok=9):
    return pb.GradientRequest(samples=[0], fit_token=tok, step_version=version,
                              weights=codec.encode_tensor(w))


def _delta(base, version, idx, vals, tok=9):
    return pb.GradientRequest(samples=[0], fit_token=tok, step_version=version,
                              delta=pb.WeightDelta(base_version=base, indices=idx, values=vals))


def _header(version, tok=9):
    return pb.GradientRequest(samples=[0], fit_token=tok, step_version=version)


def test_resolve_request_weights_state_machine_matches_jax(lone_workers):
    jw, tw = lone_workers
    w1 = np.arange(D, dtype=np.float32)
    seq = [
        _header(1),  # nothing installed yet: stale
        _full(w1, 1),  # install
        _header(1),  # reuse
        _delta(1, 2, [3, 7], [-1.5, 2.25]),  # absolute new values at 3 and 7
        _delta(1, 2, [3, 7], [-1.5, 2.25]),  # re-sent: the replica holds v2 already
        _delta(5, 6, [1], [9.0]),  # wrong base: stale
        _header(3),  # a version the replica never saw: stale
        _delta(2, 3, [0], [4.0]),  # chained on v2
        _header(3, tok=10),  # another fit's token: the replica is dropped
        _full(w1 * 2, 1, tok=10),
        pb.GradientRequest(samples=[0], weights=codec.encode_tensor(w1)),  # a plain request
    ]
    for req in seq:
        jw_w, j_stale = jw.resolve_request_weights(req)
        tw_w, t_stale = tw.resolve_request_weights(req)
        assert t_stale == j_stale
        if not j_stale:
            np.testing.assert_array_equal(tw_w, np.asarray(jw_w))
        assert (tw._replica is None) == (jw._replica is None)
        if tw._replica is not None:
            assert tw._replica[:2] == jw._replica[:2]
            np.testing.assert_array_equal(tw._replica[2], jw._replica[2])


def test_a_stale_request_replies_stale_and_computes_nothing(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        stub = c.master._members()[0][1]
        before = c.workers[0].metrics.counter("slave.sync.backward").value
        reply = stub.Gradient(_header(4, tok=77), timeout=10)
        after = c.workers[0].metrics.counter("slave.sync.backward").value
    assert reply.stale_version and after == before


# -- the fan-in lanes and the stage pool against the JAX classes --------------


class _Fut:
    """A grpc.Future-alike the test settles by hand."""

    def __init__(self):
        self._cbs, self._r, self._done = [], None, False

    def add_done_callback(self, fn):
        if self._done:
            fn(self)
        else:
            self._cbs.append(fn)

    def settle(self, r):
        self._r, self._done = r, True
        for cb in self._cbs:
            cb(self)

    def result(self, timeout=None):
        if isinstance(self._r, Exception):
            raise self._r
        return self._r

    def done(self):
        return self._done


def _grads(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        g = rng.normal(size=D).astype(np.float32)
        if i % 2:
            g[rng.random(D) < 0.9] = 0.0  # the sparse form
        out.append(g)
    return out


@pytest.mark.parametrize("lanes", [0, 1, 2, 3])
@pytest.mark.parametrize("order", ["send", "reverse", "shuffled"])
def test_arrival_decoder_gives_the_jax_sum_in_any_arrival_order(lanes, order):
    gs = _grads(6, seed=lanes)
    idx = list(range(len(gs)))
    if order == "reverse":
        idx.reverse()
    elif order == "shuffled":
        np.random.default_rng(3).shuffle(idx)
    accs = []
    for mod, cod in ((master_mod, codec), (jmaster_mod, jcodec)):
        acc = np.zeros(D, np.float32)
        dec = mod._ArrivalDecoder(acc, lanes=lanes)
        futs = [("w", _Fut()) for _ in gs]
        for i, (_, f) in enumerate(futs):
            dec.watch(i, f)
        for i in idx:
            futs[i][1].settle(cod.encode_grad(gs[i]))
        assert dec.finish(futs) and dec.decoded == len(gs)
        accs.append(acc)
    np.testing.assert_array_equal(accs[0], accs[1])
    want = np.zeros(D, np.float32)
    for g in gs:
        want += g
    np.testing.assert_array_equal(accs[0], want)


@pytest.mark.parametrize("lanes", [0, 2])
def test_arrival_decoder_stale_or_failed_reply_freezes_the_window(lanes):
    gs = _grads(3, seed=4)
    for bad in (pb.GradUpdate(stale_version=True), RuntimeError("down")):
        dec = master_mod._ArrivalDecoder(np.zeros(D, np.float32), lanes=lanes)
        futs = [("w", _Fut()) for _ in gs]
        for i, (_, f) in enumerate(futs):
            dec.watch(i, f)
        futs[0][1].settle(codec.encode_grad(gs[0]))
        futs[1][1].settle(bad)
        futs[2][1].settle(codec.encode_grad(gs[2]))
        assert not dec.finish(futs) and dec.dirty and dec.decoded == 1


def test_arrival_decoder_defer_adds_the_contributors_in_the_callers_order():
    gs = _grads(4, seed=6)
    msgs = [codec.encode_grad(g) for g in gs]
    got = []
    for mod in (master_mod, jmaster_mod):
        dec = mod._ArrivalDecoder(np.zeros(D, np.float32), lanes=2, defer=True)
        futs = [("w", _Fut()) for _ in gs]
        for i, (_, f) in enumerate(futs):
            dec.watch(i, f)
        for i in (2, 0, 3, 1):
            futs[i][1].settle(msgs[i])
        assert dec.decoded == 0 and dec.parsed == 4
        out = np.zeros(D, np.float32)
        for i in (0, 1, 3):  # a round closed without worker 2
            dec.add_into(msgs[i], out)
        dec.add_into(codec.encode_grad(gs[2] * 2), out)  # a hedge, parsed on the spot
        got.append(out)
    np.testing.assert_array_equal(got[0], got[1])


def test_dispatch_stager_take_discard_and_rng_state_match_jax():
    parts = [np.arange(i * 100, (i + 1) * 100) for i in range(3)]
    keys = [("h", 1), ("h", 2), ("h", 3)]
    out = []
    for mod in (master_mod, jmaster_mod):
        st = mod._DispatchStager(2)
        rng = np.random.default_rng((0, 1))
        trace = []
        st.stage(rng, keys, parts, epoch=1, cursor=16, span=16)
        trace.append(st.rng_state(rng)["state"]["state"])
        hit = st.take(rng, keys, 1, 16)
        trace.append([hit[k].tolist() for k in keys])
        st.stage(rng, keys, parts, epoch=1, cursor=32, span=16)
        trace.append(st.take(rng, keys, 1, 16))  # another cursor: discarded, rewound
        trace.append(rng.bit_generator.state["state"]["state"])
        st.stage(rng, keys, parts, epoch=1, cursor=48, span=16)
        st.discard(rng)
        trace.append(rng.bit_generator.state["state"]["state"])
        trace.append([mod._draw_ids(rng, p, 48, 16).tolist() for p in parts])
        trace.append((st.hits, st.discards))
        st.close()
        out.append(trace)
    assert out[0] == out[1]
    assert out[0][-1] == (1, 2)


def test_fixed_pool_matches_the_jax_pool():
    m = mm.Metrics()
    with pool.FixedPool(3, name="tpool", metrics=m) as p:
        got = p.map(lambda x: x * x, range(10))
        assert pool.await_result(p.submit(sum, [1, 2, 3])) == 6
    with jpool.FixedPool(3, name="jpool", metrics=jmetrics.Metrics()) as jp:
        want = jp.map(lambda x: x * x, range(10))
    assert got == want
    assert m.counter("tpool.submitted").value == m.counter("tpool.completed").value == 11
    assert p.active == 0
    assert pool.global_pool() is pool.global_pool()


# -- port clusters against JAX clusters ---------------------------------------

MIXED = dict(local_steps=4, delta_broadcast=True, stream=True)
LEVERS = {
    "local_steps": dict(local_steps=4),
    "delta_broadcast": dict(delta_broadcast=True),
    "stream": dict(stream=True),
    "fanin_lanes": dict(fanin_lanes=2),
    "stage_pool": dict(stage_pool=2),
    "all": dict(local_steps=4, delta_broadcast=True, stream=True, fanin_lanes=2,
                stage_pool=2),
    "all_momentum": dict(local_steps=4, delta_broadcast=True, stream=True, fanin_lanes=2,
                         stage_pool=2, optimizer="momentum"),
    "all_quorum": dict(local_steps=4, delta_broadcast=True, stream=True, fanin_lanes=2,
                       stage_pool=2, quorum=3),
}

_jax_fits = {}


def _jax_fit(data, lever):
    if lever not in _jax_fits:
        train, test, _ = data
        with JaxCluster(_models(data)[0], train, test, n_workers=WORKERS, seed=0) as c:
            kw = MIXED if lever == "mixed" else LEVERS[lever]
            _jax_fits[lever] = c.master.fit_sync(EPOCHS, B, _lr(lever), **kw)
    return _jax_fits[lever]


def _lr(lever):
    return 0.05 if "momentum" in lever else LR


@pytest.mark.parametrize("lever", sorted(LEVERS))
def test_port_cluster_with_each_lever_matches_the_jax_cluster(data, lever):
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS,
                    seed=0, metrics=m) as c:
        got = c.master.fit_sync(EPOCHS, B, _lr(lever), **LEVERS[lever])
    _assert_close_fit(got, _jax_fit(data, lever))
    k = LEVERS[lever].get("local_steps", 1)
    # 160 rows a worker: ceil(160 / (B * k)) rounds an epoch
    assert m.counter(mm.SYNC_ROUNDS).value == EPOCHS * -(-160 // (B * k))
    if LEVERS[lever].get("stream"):
        assert m.counter(mm.STREAM_SENDS).value > 0
        assert m.counter(mm.STREAM_FALLBACK).value == 0
    if LEVERS[lever].get("delta_broadcast") and "momentum" not in lever:
        # (momentum moves every coordinate: each broadcast is full)
        assert m.counter(mm.SYNC_BCAST_DELTA).value > 0
    if LEVERS[lever].get("stage_pool"):
        assert m.counter(mm.STAGE_HITS).value > 0
    if LEVERS[lever].get("fanin_lanes") and "quorum" not in lever:
        # (a quorum round may close before a lane's callback has run)
        assert m.counter(mm.FANIN_PARSED).value == WORKERS * m.counter(mm.SYNC_ROUNDS).value


@pytest.mark.parametrize("lever", ["delta_broadcast", "stream", "fanin_lanes", "stage_pool",
                                   "all_k1"])
def test_every_lever_at_k1_gives_the_knobs_off_weights_bitwise(data, lever):
    train, test, _ = data
    kw = (dict(delta_broadcast=True, stream=True, fanin_lanes=2, stage_pool=2)
          if lever == "all_k1" else LEVERS[lever])
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS,
                    seed=0) as c:
        plain = c.master.fit_sync(EPOCHS, B, LR)
        got = c.master.fit_sync(EPOCHS, B, LR, **kw)
    np.testing.assert_array_equal(np.asarray(got.weights), np.asarray(plain.weights))
    assert got.test_losses == plain.test_losses


def test_knobs_off_requests_carry_no_pipeline_fields(data, monkeypatch):
    train, test, _ = data
    seen = []
    m = mm.Metrics()
    # knobs off, the weights are encoded on the fit's thread, as the
    # unpipelined fit encodes them: the encode-ahead thread never runs
    encoded_ahead = []
    monkeypatch.setattr(master_mod._BroadcastState, "_preencode",
                        lambda self, w: encoded_ahead.append(w))
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=2,
                    metrics=m) as c:
        for w in c.workers:
            orig = w.resolve_request_weights

            def spy(request, _orig=orig):
                seen.append((request.HasField("weights"), request.HasField("delta"),
                             request.step_version, request.local_steps, request.batch_size,
                             request.learning_rate, request.ef_rollback_version,
                             request.hedge))
                return _orig(request)

            w.resolve_request_weights = spy
        c.master.fit_sync(1, B, LR)
    assert seen
    for has_w, has_d, ver, k, bs, lr, rb, hedge in seen:
        assert has_w and not has_d
        assert ver == 0 and k == 0 and bs == 0 and lr == 0.0 and rb == 0 and not hedge
    assert not encoded_ahead
    for name in (mm.STREAM_OPENED, mm.STREAM_SENDS, mm.STAGE_HITS, mm.STAGE_DISCARDS,
                 mm.FANIN_PARSED,
                 mm.SYNC_BCAST_DELTA, mm.SYNC_BCAST_CACHED, mm.SYNC_STALE,
                 mm.SLAVE_STREAM_OPENED):
        assert m.counter(name).value == 0, name


def _forget_replica_at(worker, call: int):
    """`worker` loses its replica before its `call`-th request (a restart)."""
    orig, calls = worker.resolve_request_weights, []

    def forgetful(request):
        calls.append(1)
        if len(calls) == call:
            with worker._replica_lock:
                worker._replica = None
        return orig(request)

    worker.resolve_request_weights = forgetful


def test_a_lost_replica_falls_back_to_a_full_broadcast(data):
    """A worker that loses its replica mid-fit (a restart) replies stale;
    the window retries (with fresh draws, as the JAX master's) and the
    worker gets a full broadcast.  The fit lands where the JAX cluster's
    with the same loss lands."""
    train, test, _ = data
    m = mm.Metrics()
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS,
                    seed=0, metrics=m) as c:
        _forget_replica_at(c.workers[0], 5)
        got = c.master.fit_sync(EPOCHS, B, LR, delta_broadcast=True)
        assert c.workers[0]._replica is not None
    with JaxCluster(_models(data)[0], train, test, n_workers=WORKERS, seed=0) as c:
        _forget_replica_at(c.workers[0], 5)
        want = c.master.fit_sync(EPOCHS, B, LR, delta_broadcast=True)
    _assert_close_fit(got, want)
    assert m.counter(mm.SYNC_STALE).value == 1


def test_a_quorum_hedges_a_stragglers_window_to_the_same_weights(data):
    """Under a quorum of 2 with local steps and delta broadcasts, a slow
    worker's windows are hedged (header-only, the window run on the donor)
    and the hedges win: on full-corpus workers a hedge computes the
    straggler's own decrement, so the fit lands on the no-straggler fit's
    weights bit for bit, and nobody is evicted."""
    import time as _time

    train, test, _ = data
    kw = dict(local_steps=4, delta_broadcast=True, quorum=2)
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS,
                    seed=0) as c:
        plain = c.master.fit_sync(1, B, LR, **kw)
        m = mm.Metrics()
        c.master.metrics = m
        slow = c.workers[2]
        orig, calls = slow.compute_local_window, []

        def late(*a, **k):
            calls.append(1)
            if len(calls) <= 2:
                _time.sleep(1.0)
            return orig(*a, **k)

        slow.compute_local_window = late
        got = c.master.fit_sync(1, B, LR, straggler_soft_s=0.1, grad_timeout_s=10.0, **kw)
        members = len(c.master.members)
    np.testing.assert_array_equal(np.asarray(got.weights), np.asarray(plain.weights))
    assert members == WORKERS
    assert m.counter(mm.QUORUM_HEDGE_WINS).value >= 1
    assert m.counter(mm.SYNC_BCAST_CACHED).value >= 1  # the hedges carried no weights


def test_a_stream_torn_down_mid_fit_replays_over_unary(data):
    """A worker whose stream breaks (its servicer raises once) gets the
    window replayed over unary: same weights, one teardown, a fallback."""
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=WORKERS,
                    seed=0) as c:
        plain = c.master.fit_sync(1, B, LR)
        m = mm.Metrics()
        c.master.metrics = m
        w1, frames = c.workers[1], []
        orig = w1.resolve_request_weights

        def breaks_once(request):
            frames.append(1)
            if len(frames) == 4:
                raise RuntimeError("stream servicer failure")
            return orig(request)

        w1.resolve_request_weights = breaks_once
        got = c.master.fit_sync(1, B, LR, stream=True)
    np.testing.assert_array_equal(np.asarray(got.weights), np.asarray(plain.weights))
    assert m.counter(mm.STREAM_BROKEN).value >= 1


def test_a_stream_frame_past_its_deadline_settles_deadline_exceeded():
    """A frame with no reply by its deadline settles DEADLINE_EXCEEDED
    through the wheel; the stream stays usable."""
    import queue as _queue

    replies = _queue.SimpleQueue()

    def call(it):
        class _Call:
            def __iter__(self):
                while True:
                    item = replies.get()
                    if item is None:
                        return
                    yield item

            def cancel(self):
                replies.put(None)

        return _Call()

    m = mm.Metrics()
    client = FitStreamClient(call, peer="test", metrics=m)
    fut = client.send(pb.Frame(request=pb.GradientRequest(fit_token=3)), 0.05)
    with pytest.raises(StreamRpcError) as e:
        fut.result(timeout=5)
    assert e.value.code().name == "DEADLINE_EXCEEDED" and client.usable
    replies.put(pb.Frame(seq=fut.seq, update=pb.GradUpdate()))  # late: dropped
    ok = client.send(pb.Frame(request=pb.GradientRequest(fit_token=3)), 5.0)
    replies.put(pb.Frame(seq=ok.seq, update=pb.GradUpdate(n_steps=4)))
    assert ok.result(timeout=5).n_steps == 4
    client.close()
    assert m.counter(mm.STREAM_EXPIRED).value == 1 and m.counter(mm.STREAM_LATE).value == 1


def test_the_lane_count_is_pinned_for_the_fit(data):
    train, test, _ = data
    with DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=1) as c:
        c.master.fanin_lanes = 2
        orig = c.workers[0].compute_gradient

        def flip(w, ids):
            c.master.fanin_lanes = 3
            return orig(w, ids)

        c.workers[0].compute_gradient = flip
        with pytest.raises(RuntimeError, match="lane count changed mid-fit"):
            c.master.fit_sync(1, B, LR)


# -- mixed clusters -----------------------------------------------------------


def test_a_jax_master_with_every_lever_over_torch_workers(data):
    """The JAX master sends local_steps, weight deltas, header-only
    requests and FitStream frames; the torch workers serve every one."""
    train, test, _ = data
    jmodel, tmodel = _models(data)
    jm = jmetrics.global_metrics()
    names = (jmetrics.STREAM_FALLBACK, jmetrics.STREAM_BROKEN, jmetrics.MASTER_EVICTIONS)
    b0 = {n: jm.counter(n).value for n in names}
    frames0 = mm.global_metrics().counter(mm.SLAVE_STREAM_FRAMES).value
    master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=WORKERS,
                       seed=0).start()
    workers = [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train), tmodel,
                          seed=i) for i in range(WORKERS)]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        got = master.fit_sync(EPOCHS, B, LR, grad_timeout_s=15.0, **MIXED)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    _assert_close_fit(got, _jax_fit(data, "mixed"))
    assert all(jm.counter(n).value == b0[n] for n in names)
    assert mm.global_metrics().counter(mm.SLAVE_STREAM_FRAMES).value > frames0


def test_a_torch_master_with_every_lever_over_jax_workers(data):
    train, test, _ = data
    jmodel, tmodel = _models(data)
    m = mm.Metrics()
    master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                        expected_workers=WORKERS, seed=0, metrics=m).start()
    devs = jax.devices()
    workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                         device=devs[i % len(devs)], seed=i) for i in range(WORKERS)]
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        got = master.fit_sync(EPOCHS, B, LR, grad_timeout_s=15.0, fanin_lanes=2,
                              stage_pool=2, **MIXED)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    _assert_close_fit(got, _jax_fit(data, "mixed"))
    assert m.counter(mm.STREAM_SENDS).value > 0 and m.counter(mm.STREAM_FALLBACK).value == 0
    assert m.counter(mm.SYNC_BCAST_DELTA).value > 0



# -- the settings through the CLI ---------------------------------------------


@pytest.mark.parametrize("env", [
    {"DSGD_LOCAL_STEPS": "4"}, {"DSGD_DELTA_BROADCAST": "1"}, {"DSGD_STREAM": "1"},
    {"DSGD_FANIN_LANES": "2"}, {"DSGD_STAGE_POOL": "2"},
    {"DSGD_QUORUM": "2", "DSGD_STREAM": "1", "DSGD_LOCAL_STEPS": "2"}],
    ids=lambda env: "+".join(f"{k[5:].lower()}={v}" for k, v in env.items()))
def test_the_pipelined_settings_reach_fit_sync_through_main(env, monkeypatch):
    seen = []
    real = MasterNode.fit_sync

    def spy(self, *a, **kw):
        seen.append(kw)
        return real(self, *a, **kw)

    monkeypatch.setattr(MasterNode, "fit_sync", spy)
    for k, v in {**env, "DSGD_ENGINE": "rpc", "DSGD_SYNTHETIC": "600",
                 "DSGD_MAX_EPOCHS": "1", "DSGD_NODE_COUNT": "2"}.items():
        monkeypatch.setenv(k, v)
    run = tmain.main(device="cpu")
    assert run.fit.epochs_run == 1
    (kw,) = seen
    cfg = Config.from_env()
    assert (kw["local_steps"], kw["delta_broadcast"], kw["stream"], kw["fanin_lanes"],
            kw["stage_pool"]) == (cfg.local_steps, cfg.delta_broadcast, cfg.stream,
                                  cfg.fanin_lanes, cfg.stage_pool)


@pytest.mark.parametrize("kw,match", [
    ({"local_steps": 0}, "local_steps"), ({"fanin_lanes": -1}, "DSGD_FANIN_LANES"),
    ({"stage_pool": -1}, "DSGD_STAGE_POOL"), ({"host_overprovision": 1.5}, "OVERPROVISION"),
    ({"host_index": 0}, "DSGD_ROW_STORE"),
    ({"host_index": 3, "row_store": "s", "node_count": 3}, "outside"),
    ({"master_shards": 2, "stream": True}, "does not compose with DSGD_STREAM"),
    ({"master_shards": 2, "local_steps": 4}, "does not compose with DSGD_LOCAL_STEPS")])
def test_the_config_refuses_what_the_jax_config_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        Config(**kw)
