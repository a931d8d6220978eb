"""The port's quorum barrier with straggler hedges and its heartbeat
(core/master.py ``fit_sync(quorum=, straggler_soft_s=, hedge=)``,
``predict(quorum=)``, ``start(heartbeat_s=)``; core/worker.py's ``hedge``
and ``ef_rollback_version``) against the JAX package's, on the CPU over
real loopback gRPC.

Mirrors tests/test_quorum.py and tests/test_fault_tolerance.py: with no
quorum nothing changes, a quorum of N over N equals the plain barrier bit
for bit (the replies summed in canonical slice order), a slow worker
degrades rounds instead of stalling them and is never evicted, below
quorum the window falls back to the full barrier, and the port's
``_await_quorum`` and ``_LatencyEwma`` give the JAX functions' answers.
Mixed clusters hold both ways: a JAX master's quorum over torch workers
(the workers serve its ``hedge`` and ``ef_rollback_version`` requests) and
a torch master's quorum over JAX workers."""

import signal
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core import master as jmaster_mod
from distributed_sgd_tpu.core.master import MasterNode as JaxMaster
from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.utils import metrics as jmetrics
from distributed_sgd_tpu_torch.core import master as master_mod
from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.rpc import codec
from distributed_sgd_tpu_torch.utils import metrics as mm


LIMIT_S = 120  # each test's own time limit, seconds


@pytest.fixture(autouse=True)
def _time_limit():
    def _expired(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, _expired)
    signal.alarm(LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)

torch.set_num_threads(1)

D, LAM, B, LR = 200, 1e-5, 16, 0.5


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


@pytest.fixture(scope="module")
def data():
    train, test = train_test_split(rcv1_like(1200, n_features=D, nnz=8, noise=0.0, seed=31,
                                             idf_values=True))
    return train, test, dim_sparsity(train)


def _models(data):
    _, _, ds = data
    return (jax_make_model("hinge", LAM, D, dim_sparsity=jnp.asarray(ds)),
            make_model("hinge", LAM, D, dim_sparsity=ds, device="cpu"))


def _slow_down(worker, seconds, calls=None):
    """Worker `worker` sleeps `seconds` in each compute_gradient (in its
    first `calls` only, when given); returns the list of its calls."""
    orig = worker.compute_gradient
    seen = []

    def slow(w, ids, _orig=orig):
        seen.append(len(ids))
        if calls is None or len(seen) <= calls:
            time.sleep(seconds)
        return _orig(w, ids)

    worker.compute_gradient = slow
    return seen


# -- mixed clusters ---------------------------------------------------------


def test_a_jax_master_quorum_over_torch_workers_hedges_and_evicts_nobody(data):
    """The JAX master under a quorum sends `hedge` to the donors of a
    straggler's slice and `ef_rollback_version` to the straggler: the
    torch workers serve both.  The slowed torch worker computes every
    window it is sent (its own replies land late and are discarded), the
    hedges win, and all three workers stay members."""
    train, test, _ = data
    jmodel, tmodel = _models(data)
    jm = jmetrics.global_metrics()
    names = (jmetrics.QUORUM_HEDGES, jmetrics.QUORUM_HEDGE_WINS, jmetrics.MASTER_EVICTIONS)
    b0 = {n: jm.counter(n).value for n in names}
    served0 = mm.global_metrics().counter("slave.sync.hedge").value
    master = JaxMaster("127.0.0.1", 0, train, test, jmodel, expected_workers=3, seed=0).start()
    workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                         device=jax.devices()[0], seed=0)]
    workers += [WorkerNode("127.0.0.1", 0, "127.0.0.1", master.port, _torch(train), tmodel,
                           seed=i) for i in (1, 2)]
    slowed = _slow_down(workers[2], 1.0)
    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        res = master.fit_sync(max_epochs=2, batch_size=B, learning_rate=LR, quorum=2,
                              straggler_soft_s=0.1, grad_timeout_s=15.0)
        members = set(master._workers)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    sent = {n: jm.counter(n).value - b0[n] for n in names}
    assert res.epochs_run == 2 and res.losses[-1] < res.losses[0]
    assert members == {(w.host, w.port) for w in workers}, "a worker was evicted"
    assert sent[jmetrics.MASTER_EVICTIONS] == 0
    assert sent[jmetrics.QUORUM_HEDGES] > 0 and sent[jmetrics.QUORUM_HEDGE_WINS] > 0
    # every window reached the straggler's body: no request of the JAX
    # master's answered UNIMPLEMENTED
    assert len(slowed) > 2, f"the slowed torch worker computed {len(slowed)} window(s)"
    served = mm.global_metrics().counter("slave.sync.hedge").value - served0
    assert served <= sent[jmetrics.QUORUM_HEDGES]


def test_a_torch_master_quorum_over_jax_workers_hedges_and_evicts_nobody(data):
    train, test, _ = data
    jmodel, tmodel = _models(data)
    m = mm.Metrics()
    names = (mm.QUORUM_DEGRADED, mm.QUORUM_HEDGES, mm.QUORUM_HEDGE_WINS, mm.MASTER_EVICTIONS)
    master = MasterNode("127.0.0.1", 0, _torch(train), _torch(test), tmodel,
                        expected_workers=3, seed=0, metrics=m).start()
    devs = jax.devices()
    # each worker counts the hedges it served in a registry of its own: a
    # JAX worker of an earlier test in this process cannot add to them
    worker_metrics = [jmetrics.Metrics() for _ in range(3)]
    workers = [JaxWorker("127.0.0.1", 0, "127.0.0.1", master.port, train, jmodel,
                         device=devs[i % len(devs)], seed=i, metrics=worker_metrics[i])
               for i in range(3)]
    slowed = _slow_down(workers[0], 1.0)

    def served():
        return sum(wm.counter("slave.sync.hedge").value for wm in worker_metrics)

    try:
        for w in workers:
            w.start(wait_registered=True)
        assert master.await_ready(30)
        res = master.fit_sync(max_epochs=2, batch_size=B, learning_rate=LR, quorum=2,
                              straggler_soft_s=0.1, grad_timeout_s=15.0)
        assert set(master.members) == {(w.host, w.port) for w in workers}
        # a hedge's deadline is 2 x the soft deadline (0.2 s): the master
        # stops waiting for a late one, but its donor still computes and
        # counts it; the counts are read once no hedge is in flight
        deadline = time.monotonic() + 30.0
        while served() < m.counter(mm.QUORUM_HEDGES).value and time.monotonic() < deadline:
            time.sleep(0.05)
    finally:
        for w in workers:
            w.stop()
        master.stop()
    sent = {n: m.counter(n).value for n in names}
    assert res.epochs_run == 2 and res.losses[-1] < res.losses[0]
    assert sent[mm.MASTER_EVICTIONS] == 0
    assert sent[mm.QUORUM_DEGRADED] > 0 and sent[mm.QUORUM_HEDGE_WINS] > 0
    assert served() == sent[mm.QUORUM_HEDGES]
    assert len(slowed) > 2


# -- knobs off, and a quorum of N over N ------------------------------------


def _spy_requests(workers, seen):
    for w in workers:
        orig = w.resolve_request_weights

        def spy(request, _orig=orig):
            seen.append((request.ef_rollback_version, request.hedge, request.step_version,
                         request.fit_token))
            return _orig(request)

        w.resolve_request_weights = spy


def _cluster(data, n, **kw):
    train, test, _ = data
    return DevCluster(_models(data)[1], _torch(train), _torch(test), n_workers=n, **kw)


def test_knobs_off_wire_and_weights_identical(data):
    """No quorum: no request carries a rollback, a hedge or a version, no
    quorum counter moves, and a soft deadline without a quorum only
    observes: bitwise the same weights."""
    m = mm.Metrics()
    seen = []
    with _cluster(data, 2, metrics=m) as c:
        _spy_requests(c.workers, seen)
        plain = c.master.fit_sync(2, B, LR)
    assert seen and all(rb == 0 and not h and v == 0 and tok > 0 for rb, h, v, tok in seen)
    assert len({tok for *_, tok in seen}) == 1  # one token a fit
    for name in (mm.QUORUM_DEGRADED, mm.QUORUM_HEDGES, mm.QUORUM_HEDGE_WINS, mm.QUORUM_LATE):
        assert m.counter(name).value == 0
    with _cluster(data, 2) as c:
        observed = c.master.fit_sync(2, B, LR, straggler_soft_s=300.0)
    np.testing.assert_array_equal(plain.weights, observed.weights)


def test_a_quorum_of_n_over_n_equals_the_plain_barrier_bitwise(data):
    m = mm.Metrics()
    with _cluster(data, 3) as c:
        plain = c.master.fit_sync(2, B, LR, optimizer="momentum")
    with _cluster(data, 3, metrics=m) as c:
        full = c.master.fit_sync(2, B, LR, optimizer="momentum", quorum=3)
    np.testing.assert_array_equal(plain.weights, full.weights)
    assert m.counter(mm.QUORUM_DEGRADED).value == 0 and m.counter(mm.QUORUM_HEDGES).value == 0


# -- a straggler --------------------------------------------------------------


def test_straggler_degrades_rounds_without_eviction(data):
    """One worker 10x past the soft deadline: quorum=N-1 finishes every
    epoch, hedges the straggler's slice, counts degraded rounds and late
    replies, and the straggler is still a member at the end; every hedge
    and every late request ran the Gradient body."""
    m = mm.Metrics()
    with _cluster(data, 3, metrics=m) as c:
        slowed = _slow_down(c.workers[0], 1.0)
        res = c.master.fit_sync(2, B, LR, quorum=2, straggler_soft_s=0.1, grad_timeout_s=15.0)
        assert len(c.master.members) == 3, "the straggler must not be evicted"
        time.sleep(1.2)  # the last late replies land
    assert res.epochs_run == 2 and res.losses[-1] < res.losses[0]
    for name in (mm.QUORUM_DEGRADED, mm.QUORUM_HEDGES, mm.QUORUM_HEDGE_WINS, mm.QUORUM_LATE):
        assert m.counter(name).value > 0, name
    assert m.counter(mm.MASTER_EVICTIONS).value == 0
    assert m.counter("slave.sync.hedge").value == m.counter(mm.QUORUM_HEDGES).value
    assert len(slowed) > 2


def test_quorum_stamps_versions_on_the_plain_wire(data):
    """A quorum stamps step_version on the full-weights wire, and marks
    the straggler's discarded windows with a real rollback version."""
    seen = []
    with _cluster(data, 3) as c:
        _spy_requests(c.workers, seen)
        _slow_down(c.workers[0], 1.0)
        res = c.master.fit_sync(1, B, LR, quorum=2, straggler_soft_s=0.1, grad_timeout_s=15.0)
    assert res.losses[-1] < 1.0
    assert seen and all(v > 0 for _, _, v, _ in seen)
    assert any(rb > 0 for rb, *_ in seen)
    assert any(h for _, h, _, _ in seen)


def test_below_quorum_falls_back_to_the_full_barrier(data):
    """Both of 2 workers slower than the soft deadline with quorum=2: no
    round can degrade, each runs the full barrier (stalled counted), and
    the weights equal the quorum-less fit's."""
    m = mm.Metrics()
    with _cluster(data, 2, metrics=m) as c:
        for w in c.workers:
            _slow_down(w, 0.12)
        res = c.master.fit_sync(1, B, LR, quorum=2, straggler_soft_s=0.02, grad_timeout_s=15.0)
    with _cluster(data, 2) as c:
        ref = c.master.fit_sync(1, B, LR)
    assert m.counter(mm.SYNC_STALLED).value > 0
    assert m.counter(mm.QUORUM_DEGRADED).value == 0
    np.testing.assert_array_equal(res.weights, ref.weights)


def test_predict_quorum_hedges_a_stragglers_slice(data):
    train, _, _ = data
    m = mm.Metrics()
    with _cluster(data, 2, metrics=m) as c:
        w = np.random.default_rng(4).normal(size=D).astype(np.float32) * 0.1
        want = c.master.predict(w, timeout_s=30.0)
        victim = c.workers[0]
        orig = victim.compute_forward

        def slow(wv, ids, _orig=orig):
            time.sleep(1.0)
            return _orig(wv, ids)

        victim.compute_forward = slow
        got = c.master.predict(w, timeout_s=30.0, quorum=1, straggler_soft_s=0.1)
        assert len(c.master.members) == 2
    np.testing.assert_array_equal(got, want)
    assert got.shape == (len(train),)
    assert m.counter(mm.QUORUM_HEDGE_WINS).value >= 1


# -- the barrier's helpers against the JAX package's ---------------------------


class _Fut:
    """A settled-at-a-time future, as tests/test_quorum.py's."""

    def __init__(self, reply=None, exc=None, delay_done=0.0):
        self._reply, self._exc = reply, exc
        self._t_done = time.monotonic() + delay_done

    def done(self):
        return time.monotonic() >= self._t_done

    def result(self):
        if self._exc is not None:
            raise self._exc
        return self._reply

    def add_done_callback(self, fn):
        pass

    def cancelled(self):
        return False


@pytest.mark.parametrize("case", ["soft_deadline_with_quorum", "below_quorum_waits"])
def test_await_quorum_gives_the_jax_answer(case):
    reply = codec.encode_grad(np.ones(8, dtype=np.float32))
    if case == "soft_deadline_with_quorum":
        spec, quorum, soft = [("a", 0.0), ("b", 0.0), ("c", 30.0)], 2, 0.2
    else:
        spec, quorum, soft = [("a", 0.0), ("b", 0.6)], 2, 0.05
    answers = []
    for fn in (master_mod._await_quorum, jmaster_mod._await_quorum):
        futs = [(k, _Fut(reply, delay_done=d)) for k, d in spec]
        t0 = time.monotonic()
        ok, failed, pending = fn(futs, quorum, t0 + soft)
        answers.append(([k for k, _ in ok], failed, [k for k, _ in pending],
                        time.monotonic() - t0 >= 0.5))
    assert answers[0] == answers[1]
    if case == "soft_deadline_with_quorum":
        assert answers[0][:3] == (["a", "b"], [], ["c"])
    else:
        assert answers[0] == (["a", "b"], [], [], True)


def test_latency_ewma_gives_the_jax_deadlines():
    ours, theirs = master_mod._LatencyEwma(), jmaster_mod._LatencyEwma()
    assert ours.soft_deadline_s(["a", "b"], 2) is None is theirs.soft_deadline_s(["a", "b"], 2)
    rng = np.random.default_rng(9)
    for _ in range(20):
        for key, base in (("a", 0.10), ("b", 0.12), ("c", 9.0)):
            x = float(base + 0.01 * rng.random())
            ours.record(key, x)
            theirs.record(key, x)
    for q in (1, 2, 3):
        assert ours.soft_deadline_s(["a", "b", "c"], q) == theirs.soft_deadline_s(
            ["a", "b", "c"], q)
    soft = ours.soft_deadline_s(["a", "b", "c"], 2)
    assert 0.1 <= soft < 1.0 and ours.soft_deadline_s(["a", "b", "c"], 3) > 9.0


# -- the heartbeat (as tests/test_fault_tolerance.py) -------------------------


def _hard_kill(worker):
    """A crash: the server goes with no unregistration."""
    worker._stopped.set()
    worker.server.stop(grace=0)


def test_heartbeat_eviction_then_fit(data):
    m = mm.Metrics()
    with _cluster(data, 3, metrics=m, heartbeat_s=0.2) as c:
        gone = c.workers[0]
        _hard_kill(gone)
        deadline = time.time() + 15
        while time.time() < deadline and len(c.master.members) > 2:
            time.sleep(0.05)
        assert len(c.master.members) == 2, "the heartbeat never evicted the dead worker"
        assert m.counter(mm.MASTER_EVICTIONS).value == 1
        res = c.master.fit_sync(2, B, LR, grad_timeout_s=5.0)
        assert res.epochs_run == 2 and np.isfinite(res.losses[-1])
        c.workers = c.workers[1:]


def test_worker_rejoins_mid_fit(data):
    """A worker dies mid-fit and the heartbeat evicts it; a replacement
    registers into the freed slot while the fit runs, and the fit's next
    window takes it in."""
    train, _, _ = data
    with _cluster(data, 3, heartbeat_s=0.2) as c:
        for wk in c.workers[1:]:
            _slow_down(wk, 0.02)
        gone = c.workers[0]
        first_call = threading.Event()
        orig0 = gone.compute_gradient
        gone.compute_gradient = lambda w, ids: (first_call.set(), orig0(w, ids))[1]
        box = {}

        def run():
            try:
                box["result"] = c.master.fit_sync(10, B, LR, grad_timeout_s=5.0)
            except Exception as e:  # noqa: BLE001 - surfaced below
                box["error"] = e

        t = threading.Thread(target=run, daemon=True)
        t.start()
        assert first_call.wait(30)
        _hard_kill(gone)
        deadline = time.time() + 20
        while time.time() < deadline and len(c.master.members) > 2:
            time.sleep(0.05)
        assert len(c.master.members) == 2 and t.is_alive()
        c.workers = c.workers[1:]
        served = threading.Event()
        joined = c.add_worker(seed=99)
        orig_r = joined.compute_gradient
        joined.compute_gradient = lambda w, ids: (served.set(), orig_r(w, ids))[1]
        assert len(c.master.members) == 3
        assert served.wait(30), "the replacement never served a Gradient"
        t.join(timeout=120)
        assert not t.is_alive() and "error" not in box, box.get("error")
        assert box["result"].epochs_run == 10
