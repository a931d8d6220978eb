"""The port's async engines (distributed_sgd_tpu_torch/parallel/hogwild.py,
local_sgd.py) and their helpers (core/split.py, parallel/topology.py)
against the JAX package's, on the CPU.

torch cannot reproduce ``jax.random``, so where the comparison is exact
the test draws JAX's own ids with JAX and hands them to the port: one
Hogwild dispatch and a whole local SGD fit then agree to atol 1e-5 (f32
gradient sums in another order).  A whole Hogwild fit races its threads,
so it is held to the JAX package's own async band instead: its best
smoothed test loss within ASYNC_TOL = 0.12 of the JAX engine's on the same
data and budget (tests/test_async_convergence.py)."""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core import split as jsplit
from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel import hogwild as jhog
from distributed_sgd_tpu.parallel import topology as jtopo
from distributed_sgd_tpu.parallel.local_sgd import LocalSGDEngine as JaxLocalSGD
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.core import split as tsplit
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.parallel import hogwild as thog
from distributed_sgd_tpu_torch.parallel import local_sgd as tlocal
from distributed_sgd_tpu_torch.parallel import topology as ttopo
from distributed_sgd_tpu_torch.parallel.sync import ShardedData
from distributed_sgd_tpu_torch.utils.metrics import Metrics

torch.set_num_threads(1)

ASYNC_TOL = 0.12  # tests/test_async_convergence.py, the JAX package's async band
LR = {"hinge": 0.5, "logistic": 0.5, "least_squares": 0.05}


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _models(model, d, ds, reg="dim_sparsity"):
    return (jax_make_model(model, 1e-4, d, dim_sparsity=jnp.asarray(ds), regularizer=reg),
            convert.model_from_jax(model, 1e-4, d, ds, reg, device="cpu"))


# -- helpers: the vanilla split and the gossip topology ---------------------

@pytest.mark.parametrize("n_workers", [1, 2, 3, 4, 7])
def test_vanilla_split_matches_jax(n_workers):
    for n in [0, 1, 2, 5, 10, 11, 99, 100, 101, 643531]:
        got, want = tsplit.vanilla_split(n, n_workers), jsplit.vanilla_split(n, n_workers)
        assert len(got) == len(want) == n_workers
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


KEYS = {
    "wids": list(range(7)),
    "endpoints": [("10.0.0.1", 5000 + i) for i in range(7)],
    "names": [f"worker-{i}" for i in range(7)],
}


@pytest.mark.parametrize("keys", sorted(KEYS))
@pytest.mark.parametrize("spec", ["all", "ring", "random:1", "random:2", "random:5"])
def test_gossip_peer_selection_matches_jax(spec, keys):
    assert ttopo.parse_topology(spec) == jtopo.parse_topology(spec)
    mode, k = ttopo.parse_topology(spec)
    members = KEYS[keys]
    suppress = {None: None, "odd": lambda p: ttopo.node_id(p) % 2 == 1,
                "all": lambda p: True}
    for n in range(1, len(members) + 1):
        for me in members[:n]:
            peers = [p for p in members[:n] if p != me]
            for rnd in range(12):
                for seed in (0, 7):
                    for name, fn in suppress.items():
                        got = ttopo.select_gossip_peers(mode, k, peers, me, rnd, seed=seed,
                                                        suppressed=fn)
                        want = jtopo.select_gossip_peers(mode, k, peers, me, rnd, seed=seed,
                                                         suppressed=fn)
                        assert got == want, (n, me, rnd, seed, name)


@pytest.mark.parametrize("spec", ["", "mesh", "random", "random:x", "random:0"])
def test_topology_typos_raise_as_in_jax(spec):
    with pytest.raises(ValueError) as want:
        jtopo.parse_topology(spec) if spec else jtopo.parse_topology("tree")
    with pytest.raises(ValueError) as got:
        ttopo.parse_topology(spec) if spec else ttopo.parse_topology("tree")
    assert str(got.value) == str(want.value)


# -- Hogwild ---------------------------------------------------------------

def _shard_on_cpu(ds):
    return ShardedData(torch.from_numpy(ds.indices), torch.from_numpy(ds.values),
                       torch.from_numpy(ds.labels).float(), n_true=len(ds))


@pytest.mark.parametrize("reg", ["dim_sparsity", "l2"])
@pytest.mark.parametrize("model", ["hinge", "logistic", "least_squares"])
def test_one_hogwild_dispatch_matches_the_jax_worker(model, reg):
    d, b, k = 1000, 16, 8
    data = rcv1_like(600, n_features=d, nnz=12, seed=5, idf_values=True)
    shard = data.slice(np.arange(100, 400))  # worker 1 of 2 over the first 400 rows
    jm, tm = _models(model, d, dim_sparsity(data), reg)
    jw = jhog._Worker(1, jm, shard, jax.devices()[0], b, LR[model], 0, JaxMetrics(),
                      steps_per_dispatch=k)
    tw = thog._Worker(1, tm, _shard_on_cpu(shard), b, LR[model], 0, Metrics(),
                      steps_per_dispatch=k)
    assert (tw.k, tw.shard_n) == (jw.k, len(shard))
    w0 = (np.random.default_rng(1).normal(size=d) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jw._step(jnp.asarray(w0), None, jw._idx, jw._val, jw._y, key)[0])
    # the JAX worker's own draws (hogwild.py: split the key, one randint a step)
    ids = np.stack([np.asarray(jax.random.randint(kk, (b,), 0, len(shard)))
                    for kk in jax.random.split(key, k)])[:, None, :].astype(np.int64)
    got = tw._step(torch.from_numpy(w0), torch.from_numpy(ids))
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_hogwild_worker_draws_k_batches_from_its_shard():
    data = rcv1_like(200, n_features=300, nnz=8, seed=2)
    _, tm = _models("hinge", 300, dim_sparsity(data))
    tw = thog._Worker(2, tm, _shard_on_cpu(data.slice(np.arange(50))), 8, 0.5, 3, Metrics(),
                      steps_per_dispatch=5)
    ids = tw._sample_ids()
    assert ids.shape == (5, 1, 8) and ids.dtype == torch.int64
    assert int(ids.min()) >= 0 and int(ids.max()) < 50
    again = thog._Worker(2, tm, _shard_on_cpu(data.slice(np.arange(50))), 8, 0.5, 3,
                         Metrics(), steps_per_dispatch=5)
    assert torch.equal(again._sample_ids(), ids)  # seeded seed + 1000 * (wid + 1)


@pytest.fixture(scope="module")
def hogwild_setup():
    data = rcv1_like(1600, n_features=1000, nnz=12, noise=0.02, seed=21)
    train, test = train_test_split(data)
    return train, test, _models("hinge", 1000, dim_sparsity(train))


def _live_hogwild_threads(before):
    return [t for t in threading.enumerate()
            if t.name.startswith("hogwild-") and t.is_alive() and t not in before]


def test_hogwild_fit_trains_and_lands_in_the_jax_band(hogwild_setup):
    train, test, (jm, tm) = hogwild_setup
    kw = dict(n_workers=2, batch_size=32, learning_rate=0.1, check_every=400,
              backoff_s=0.02, steps_per_dispatch=16)
    jr = jhog.HogwildEngine(jm, metrics=JaxMetrics(), **kw).fit(train, test, max_epochs=3)
    metrics = Metrics()
    before = set(threading.enumerate())
    res = thog.HogwildEngine(tm, metrics=metrics, device="cpu", **kw).fit(
        _torch(train), _torch(test), max_epochs=3)
    assert _live_hogwild_threads(before) == []
    budget = len(train) * 3
    assert res.state.updates >= budget  # no criterion: the budget ends the fit
    assert res.epochs_run == res.state.updates * 32 // len(train)
    # the first check runs at once, at w = 0 (loss 1.0) unless a worker's
    # first delta landed before it
    assert len(res.test_losses) >= 2 and res.test_losses[0] <= 1.0
    assert min(res.test_losses) < res.test_losses[0]
    assert res.state.loss == pytest.approx(min(res.test_losses), rel=1e-6)
    assert metrics.counter("slave.async.grad.update").value > 0
    assert metrics.counter("slave.async.batch").value == res.state.updates
    assert metrics.histogram("master.async.loss.value").count == len(res.test_losses)
    assert abs(res.state.loss - jr.state.loss) <= ASYNC_TOL, (res.state.loss, jr.state.loss)


def test_hogwild_early_stops_on_target(hogwild_setup):
    train, test, (_, tm) = hogwild_setup
    eng = thog.HogwildEngine(tm, 2, 8, 0.5, check_every=20, leaky_loss=1.0, backoff_s=0.02,
                             steps_per_dispatch=4, device="cpu")
    from distributed_sgd_tpu_torch.core.early_stopping import target

    res = eng.fit(_torch(train), _torch(test), max_epochs=1000, criterion=target(1e9))
    assert res.state.updates < len(train) * 1000 and len(res.test_losses) == 1


def test_hogwild_stress_counts_every_update(hogwild_setup, monkeypatch):
    """More worker threads than cores, a short switch interval and tiny
    inboxes that overflow: every dispatch reaches the coordinator exactly
    once, and every worker thread ends."""
    train, test, (_, tm) = hogwild_setup
    metrics = Metrics()
    eng = thog.HogwildEngine(tm, 6, 4, 0.01, check_every=100, leaky_loss=0.5,
                             backoff_s=0.01, seed=3, steps_per_dispatch=4, metrics=metrics,
                             device="cpu")
    real_worker = thog._Worker
    workers = []

    def small_inbox(*a, **kw):
        workers.append(real_worker(*a, max_inbox=2, **kw))
        return workers[-1]

    monkeypatch.setattr(thog, "_Worker", small_inbox)
    before = set(threading.enumerate())
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        res = eng.fit(_torch(train), _torch(test), max_epochs=1)
    finally:
        sys.setswitchinterval(old)
    assert _live_hogwild_threads(before) == []
    assert bool(torch.isfinite(res.state.weights).all())
    dispatches = res.state.updates // 4
    assert metrics.counter("slave.async.batch").value == res.state.updates == 4 * dispatches
    # every delta sent to a peer was merged, dropped, or is still queued
    pushed = 5 * dispatches
    queued = sum(w.inbox.qsize() for w in workers)
    assert (metrics.counter("slave.async.grad.update").value
            + metrics.counter("slave.async.grad.dropped").value + queued) == pushed
    assert metrics.counter("slave.async.grad.dropped").value > 0


def test_hogwild_replicas_agree_with_the_coordinator(hogwild_setup, monkeypatch):
    """Every delta reaches every peer and the coordinator, so after the fit
    each replica, less the deltas still in its inbox, is the coordinator's
    weights up to the order of the f32 sums."""
    train, test, (_, tm) = hogwild_setup
    real_worker, workers = thog._Worker, []
    monkeypatch.setattr(thog, "_Worker", lambda *a, **kw: workers.append(
        real_worker(*a, **kw)) or workers[-1])
    metrics = Metrics()
    eng = thog.HogwildEngine(tm, 3, 16, 0.5, check_every=200, backoff_s=0.01,
                             steps_per_dispatch=4, metrics=metrics, device="cpu")
    eng.fit(_torch(train), _torch(test), max_epochs=2)
    assert len(workers) == 3 and metrics.counter("slave.async.grad.dropped").value == 0
    master = eng._w_master
    assert float(master.abs().max()) > 1e-2
    for w in workers:
        pending = sum(w.inbox.queue, np.zeros(master.shape, np.float32))
        np.testing.assert_allclose((w.w - torch.from_numpy(pending)).numpy(), master.numpy(),
                                   atol=1e-5)


def test_hogwild_refuses_what_is_not_ported():
    tm = tmain.make_model("hinge", 1e-4, 10, device="cpu")
    # momentum and adam are ported; an unknown name or an optax object is not
    assert thog.HogwildEngine(tm, 2, 8, 0.5, optimizer="adam", device="cpu").optimizer.kind == "adam"
    with pytest.raises(ValueError, match="optimizer"):
        thog.HogwildEngine(tm, 2, 8, 0.5, optimizer="adagrad", device="cpu")
    with pytest.raises(TypeError, match="optax"):
        thog.HogwildEngine(tm, 2, 8, 0.5, optimizer=object(), device="cpu")
    with pytest.raises(NotImplementedError, match="compress"):
        thog.HogwildEngine(tm, 2, 8, 0.5, compress="topk", device="cpu")
    with pytest.raises(ValueError, match="DSGD_GOSSIP_TOPOLOGY"):
        thog.HogwildEngine(tm, 2, 8, 0.5, gossip_topology="mesh", device="cpu")
    with pytest.raises(ValueError, match="leaking"):
        thog.HogwildEngine(tm, 2, 8, 0.5, leaky_loss=1.5, device="cpu")


# -- local SGD ---------------------------------------------------------------

def _jax_local_sgd_draws(seed, n_rounds, h, b, shard_n):
    """The ids of a one-device JAX LocalSGDEngine fit, round by round
    (local_sgd.py: split the key per round, fold in the device index 0,
    then the step)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_rounds):
        key, rk = jax.random.split(key)
        dk = jax.random.fold_in(rk, 0)
        out.append(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(dk, t), (b,),
                                                           0, shard_n))
                             for t in range(h)])[:, None, :].astype(np.int64))
    return out


@pytest.mark.parametrize("model", ["hinge", "logistic"])
def test_local_sgd_fit_with_the_jax_draws_matches_jax(model):
    # 4,200 train rows pad to two eval chunks of 4,096: the draws cover the
    # 3,992 pad rows too, which add nothing and count in the mean's B
    d, b, h = 500, 16, 32
    data = rcv1_like(5250, n_features=d, nnz=8, noise=0.02, seed=9, idf_values=True)
    train, test = train_test_split(data)
    jm, tm = _models(model, d, dim_sparsity(train))
    kw = dict(batch_size=b, learning_rate=0.1, sync_period=h, check_every=1024, seed=4)
    jr = JaxLocalSGD(jm, make_mesh(1), metrics=JaxMetrics(), **kw).fit(train, test, 1)
    eng = tlocal.LocalSGDEngine(tm, metrics=Metrics(), device="cpu", **kw)
    draws = _jax_local_sgd_draws(4, -(-len(train) // h), h, b, 8192)
    seen = []

    def jax_ids(rnd, shard_n):
        seen.append(shard_n)
        return torch.from_numpy(draws[rnd])

    eng._sample_ids = jax_ids
    res = eng.fit(_torch(train), _torch(test), 1)
    assert set(seen) == {8192}
    assert res.state.updates == jr.state.updates == len(seen) * h >= len(train)
    assert res.epochs_run == jr.epochs_run
    assert len(res.test_losses) == len(jr.test_losses) >= 4
    np.testing.assert_allclose(res.test_losses, jr.test_losses, atol=1e-5)
    np.testing.assert_allclose(res.test_accuracies, jr.test_accuracies, atol=1e-5)
    assert res.state.loss == pytest.approx(jr.state.loss, abs=1e-5)
    assert min(res.test_losses) < res.test_losses[0]
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jr.weights), atol=1e-5)


def test_local_sgd_draws_over_the_padded_shard_and_records_rounds():
    data = rcv1_like(500, n_features=300, nnz=8, seed=3)
    train, test = train_test_split(data)
    _, tm = _models("hinge", 300, dim_sparsity(train))
    metrics = Metrics()
    eng = tlocal.LocalSGDEngine(tm, 8, 0.5, sync_period=5, check_every=50, metrics=metrics,
                                device="cpu")
    ids = eng._sample_ids(3, 400)
    assert ids.shape == (5, 1, 8) and int(ids.max()) < 400
    assert torch.equal(ids, eng._sample_ids(3, 400)) and not torch.equal(ids, eng._sample_ids(4, 400))
    res = eng.fit(_torch(train), _torch(test), 2)
    rounds = metrics.histogram("slave.async.round.seconds").count
    assert rounds == -(-2 * len(train) // 5) and res.state.updates == 5 * rounds


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["gossip", "local_sgd"])
def test_the_async_setting_reaches_its_engine(mode, monkeypatch):
    monkeypatch.setenv("DSGD_SYNTHETIC", "600")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "1")
    monkeypatch.setenv("DSGD_ASYNC", "1")
    monkeypatch.setenv("DSGD_ASYNC_MODE", mode)
    monkeypatch.setenv("DSGD_STEPS_PER_DISPATCH", "8")
    monkeypatch.setenv("DSGD_SYNC_PERIOD", "4")
    monkeypatch.setenv("DSGD_CHECK_EVERY", "120")
    built = []
    for name in ("HogwildEngine", "LocalSGDEngine", "SyncTrainer"):
        real = getattr(tmain, name)
        monkeypatch.setattr(tmain, name, type(name, (real,), {
            "__init__": lambda self, *a, _real=real, _name=name, **kw: (
                built.append((_name, kw)), _real.__init__(self, *a, **kw))[1]}))
    run = tmain.main(device="cpu")
    name, kw = built[0]
    assert len(built) == 1
    if mode == "gossip":
        assert name == "HogwildEngine"
        assert (kw["n_workers"], kw["steps_per_dispatch"], kw["gossip_topology"]) == (3, 8, "all")
    else:
        assert name == "LocalSGDEngine" and kw["sync_period"] == 4
    assert kw["check_every"] == 120 and kw["leaky_loss"] == 0.9
    assert run.fit.state.updates >= 480 and 1 <= len(run.fit.test_losses)
    assert np.isfinite(run.fit.test_losses).all()
