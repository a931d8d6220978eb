"""A model's own gradient coefficient in the port (ops/coeff.py), against
the JAX package, whose Pallas kernel takes any model's rule as its
``coeff_fn``.

The JAX examples' ``SquaredHinge`` (examples/custom_model.py) and its twin
in examples_torch/ (``grad_coeff`` in torch plus ``coeff_cuda``) get the
same numpy inputs: ``worker_grads`` against the Pallas kernel in
interpret mode, one sync epoch with injected ids against JAX's SyncEngine
with each of its kernels (pallas, mxu, scalar; momentum and adam with
scalar, their state too), one Hogwild dispatch and
a local SGD fit with JAX's own draws (the mean mode), and the RPC worker's
Gradient body and K-step window against the JAX worker's.  Each is held
to atol 1e-5, or 1e-6 for a single body (f32 sums in another order).

The two faults this repairs stay repaired: a LinearModel subclass with
only its own ``grad_coeff`` trains (it raised AttributeError), and a
SparseSVM subclass that overrides ``grad_coeff`` trains by its own rule,
JAX's result, not hinge's (it trained by hinge's, silently).  A user rule
without ``coeff_cuda`` raises before a CUDA launch, and each rule's
libraries carry its content key while the built-in ones keep their
names.  Each test runs under a time limit of its own (`LIMIT_S`)."""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core.worker import WorkerNode as JaxWorker
from distributed_sgd_tpu.data.rcv1 import train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import SparseSVM as JaxSVM
from distributed_sgd_tpu.ops import mxu, pallas_sparse
from distributed_sgd_tpu.parallel import hogwild as jhog
from distributed_sgd_tpu.parallel import sync as jsync
from distributed_sgd_tpu.parallel.local_sgd import LocalSGDEngine as JaxLocalSGD
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.models.linear import LinearModel, SparseSVM
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import coeff as co
from distributed_sgd_tpu_torch.ops import sync_epoch as se
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.parallel import hogwild as thog
from distributed_sgd_tpu_torch.parallel import local_sgd as tlocal
from distributed_sgd_tpu_torch.parallel import sync as tsync
from distributed_sgd_tpu_torch.parallel.sync import ShardedData
from distributed_sgd_tpu_torch.utils.metrics import Metrics
from examples.custom_model import SquaredHinge as JaxSquaredHinge
from examples_torch.custom_model import SquaredHinge

torch.set_num_threads(1)

N, D, NNZ, K, B, LR, LAM = 3000, 2000, 20, 3, 50, 0.1, 1e-4
ATOL = 1e-5
OPT_LR = {"momentum": 0.05, "adam": 0.001}  # the smoke's and the CLI docs' rates
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


class JaxShiftedSVM(JaxSVM):
    """The reference hinge model with its subgradient's switch moved from
    y*m < 0 to y*m < -0.5."""

    def grad_coeff(self, margins, y):
        yf = y.astype(jnp.float32)
        return jnp.where(yf * margins < -0.5, 0.0, yf)


class ShiftedSVM(SparseSVM):
    coeff_cuda = "return (y * m < -0.5f) ? 0.f : y;"

    def grad_coeff(self, margins, y):
        yf = y.float()
        return torch.where(yf * margins < -0.5, torch.zeros_like(yf), yf)


class NoCuda(SquaredHinge):
    """A user rule without its CUDA form: the CPU only."""

    coeff_cuda = None


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _pair(jcls, tcls, d=D, reg="l2"):
    return jcls(lam=LAM, n_features=d, regularizer=reg), tcls(LAM, d, regularizer=reg,
                                                               device="cpu")


# -- the coefficient object ----------------------------------------------------

def test_models_resolve_to_a_builtin_kind_or_their_own_rule():
    assert SparseSVM(LAM, D, regularizer="l2", device="cpu").coeff == co.Coeff(co.HINGE)
    rule = SquaredHinge(LAM, D, regularizer="l2", device="cpu").coeff
    assert (rule.kind, rule.cuda, rule.name) == (co.USER, SquaredHinge.coeff_cuda,
                                                 "SquaredHinge")
    assert rule.key == co.content_key(SquaredHinge.coeff_cuda) and len(rule.key) == 12
    shifted = ShiftedSVM(LAM, D, regularizer="l2", device="cpu").coeff
    assert shifted.kind == co.USER and shifted.key != rule.key
    # an int kind is still taken; anything else raises
    assert co.resolve(co.LOGISTIC) == co.Coeff(co.LOGISTIC)
    for bad in (9, co.USER, True, "hinge", co.Coeff(7)):
        with pytest.raises(ValueError):
            co.resolve(bad)

    class Bare(LinearModel):
        pass

    class CudaOnly(SparseSVM):
        coeff_cuda = "return y;"

    for cls, match in ((Bare, "neither coeff_kind nor grad_coeff"),
                       (CudaOnly, "no grad_coeff of its own")):
        with pytest.raises(ValueError, match=match):
            cls(LAM, D, regularizer="l2", device="cpu").coeff


def test_a_user_rule_without_cuda_raises_for_a_cuda_device_and_runs_on_the_cpu():
    rule = NoCuda(LAM, D, regularizer="l2", device="cpu").coeff
    for device in ("cuda", "cuda:1", torch.device("cuda", 0)):
        with pytest.raises(ValueError, match="coeff_cuda"):
            co.check_launchable(rule, device)
    co.check_launchable(rule, "cpu")
    for ok in (co.Coeff(co.HINGE), SquaredHinge(LAM, D, regularizer="l2", device="cpu").coeff):
        co.check_launchable(ok, "cuda")
    with pytest.raises(ValueError, match="coeff_cuda"):
        _build.library_path("sync_epoch", rule)
    # the CPU trains from the torch rule alone
    w, idx, val, y = _batches(1, 20, 6, seed=3)
    got = wg.worker_grads(*map(torch.from_numpy, (w, idx, val, y)), rule)
    want = wg.worker_grads_plain(*map(torch.from_numpy, (w, idx, val, y)),
                                 SquaredHinge(LAM, D, regularizer="l2", device="cpu").coeff)
    assert torch.equal(got, want) and bool((got != 0).any())


def test_each_rule_has_its_own_libraries_and_the_builtin_names_stay(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    builtin = {n: _build.library_path(n) for n in _build.KERNELS}
    a = SquaredHinge(LAM, D, regularizer="l2", device="cpu").coeff
    b = co.user(a.fn, a.cuda + "\n", "SquaredHinge")  # the same rule, another source
    for n in _build.KERNELS:
        pa, pb = _build.library_path(n, a), _build.library_path(n, b)
        assert pa.name.startswith(f"lib{n}-coeff{a.key}.") and pb.name.startswith(
            f"lib{n}-coeff{b.key}.")
        assert len({pa, pb, builtin[n]}) == 3 and a.key != b.key
        # a built-in kind, or no rule, is the built-in library
        assert _build.library_path(n, co.Coeff(co.HINGE)) == _build.library_path(n) == builtin[n]
        assert "coeff" not in builtin[n].name
        cmd = _build.nvcc_command(n, tmp_path / "out.so", a)
        assert cmd[cmd.index("-I") + 1] == str(_build.header_dir(a))
        assert "-DDSGD_USER_COEFF" in cmd and "-DDSGD_USER_COEFF" not in _build.nvcc_command(
            n, tmp_path / "out.so")
    _build._write_header(a)
    text = (_build.header_dir(a) / _build.USER_HEADER).read_text()
    assert a.cuda in text and "dsgd_user_coeff(float m, float y)" in text and a.key in text
    # the header the hook includes is not a source of the built-in libraries
    assert _build.USER_HEADER not in [p.name for p in _build._sources("worker_grads")]
    assert "coeff.cuh" in [p.name for p in _build._sources("sync_epoch")]


# -- worker_grads against the Pallas kernel's coeff_fn ---------------------------

def _batches(k, b, p, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, (k, b, p)).astype(np.int32)
    val = rng.normal(size=(k, b, p)).astype(np.float32)
    val[rng.random((k, b, p)) < 0.2] = 0.0
    y = rng.choice([-1.0, 1.0], (k, b)).astype(np.float32)
    idx[:, -1], val[:, -1], y[:, -1] = 0, 0.0, 0.0  # a pad row
    w = (rng.normal(size=D) * 0.3).astype(np.float32)
    return w, idx, val, y


@pytest.mark.parametrize("k,b", [(1, 10), (3, 37)])
@pytest.mark.parametrize("jcls,tcls", [(JaxSquaredHinge, SquaredHinge),
                                       (JaxShiftedSVM, ShiftedSVM)], ids=["sqhinge", "shifted"])
def test_worker_grads_matches_the_pallas_kernel_with_the_models_coeff_fn(jcls, tcls, k, b):
    w, idx, val, y = _batches(k, b, 6, seed=k * 100 + b)
    jm, tm = _pair(jcls, tcls)
    pallas = np.asarray(pallas_sparse.worker_grads(
        mxu.to_blocked(jnp.asarray(w), D), jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y),
        jm.grad_coeff, interpret=True))
    got = wg.worker_grads(*map(torch.from_numpy, (w, idx, val, y)), tm.coeff)
    np.testing.assert_allclose(convert.to_blocked(got.numpy(), D), pallas, rtol=1e-5, atol=ATOL)
    assert np.abs(pallas).max() > 1e-2
    # not the built-in rule of the class
    hinge = wg.worker_grads(*map(torch.from_numpy, (w, idx, val, y)), co.HINGE)
    assert float((got - hinge).abs().max()) > 1e-2


# -- the sync engine: one epoch with injected ids ----------------------------------

def _engines(jcls, tcls, kernel, seed=5, optimizer=None):
    data = rcv1_like(N, n_features=D, nnz=NNZ, seed=seed, idf_values=True)
    jm, tm = _pair(jcls, tcls)
    kw = dict(batch_size=B, learning_rate=OPT_LR.get(optimizer, LR), virtual_workers=K,
              optimizer=optimizer)
    jb = jsync.SyncEngine(jm, make_mesh(1), kernel=kernel, **kw).bind(data)
    tb = tsync.SyncEngine(tm, device="cpu", **kw).bind(_torch(data))
    return jb, tb, data


def _owned_ids(bound, seed=0):
    sub, starts, sizes = bound._subshards()
    rng = np.random.default_rng(seed)
    sel = rng.integers(0, sub, (bound.steps_per_epoch, bound.virtual_workers, bound.batch_size))
    return sel % np.minimum(sub, sizes)[:, None] + starts[:, None]


def _epoch(jb, tb):
    ids = _owned_ids(tb)
    jb._sample_ids = lambda key, step: jnp.asarray(ids, jnp.int32)[step]
    tb._sample_ids = lambda key: torch.from_numpy(ids)
    w_j = np.asarray(jb.epoch(jnp.zeros(D, jnp.float32), jax.random.PRNGKey(0)))
    return w_j, tb.epoch(torch.zeros(D), key=0), ids


@pytest.mark.parametrize("kernel,optimizer", [("pallas", None), ("mxu", None),
                                              ("scalar", None), ("scalar", "momentum"),
                                              ("scalar", "adam")])
def test_one_sync_epoch_with_injected_ids_matches_jax(kernel, optimizer):
    # the optimizer modes with the scalar kernel: its state is flat [D], as the port's
    jb, tb, _ = _engines(JaxSquaredHinge, SquaredHinge, kernel, optimizer=optimizer)
    assert tb.epoch_kernel and tb.steps_per_epoch == jb.steps_per_epoch == 20
    w_j, w_t, _ = _epoch(jb, tb)
    assert np.abs(w_j).max() > 1e-3
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=ATOL)
    np.testing.assert_allclose(tb.evaluate(w_t), jb.evaluate(jnp.asarray(w_j)), rtol=1e-5)
    if optimizer is not None:
        want = convert.opt_state_from_jax(jb.opt_state_leaves(), optimizer, D, device="cpu")
        assert tb._opt_state.count == want.count
        for g, w in zip(tb._opt_state.vectors, want.vectors, strict=True):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


def test_the_per_step_path_takes_the_rule_too():
    # 8 workers of the state do not change the function: every step is
    # one worker_grads call with the rule, then the regularizer and update
    jb, tb, data = _engines(JaxSquaredHinge, SquaredHinge, "pallas")
    w_j, w_t, ids = _epoch(jb, tb)
    tb.epoch_kernel = False
    w_steps = tb._run(torch.zeros(D), torch.from_numpy(ids))
    np.testing.assert_allclose(w_steps.numpy(), w_j, atol=ATOL)


def test_fault_1_a_linear_model_with_only_its_own_rule_trains():
    # it raised AttributeError: 'SquaredHinge' object has no attribute 'coeff_kind'
    data = rcv1_like(2000, n_features=2048, nnz=16, seed=1)
    train, test = train_test_split(data)
    model = SquaredHinge(LAM, data.n_features, regularizer="l2", device="cpu")
    assert not hasattr(model, "coeff_kind")
    eng = tsync.SyncEngine(model, batch_size=64, learning_rate=LR, device="cpu")
    bound, bound_test = eng.bind(_torch(train)), eng.bind(_torch(test))
    w = torch.zeros(data.n_features)
    loss0 = bound_test.evaluate(w)[0]
    for e in range(2):
        w = bound.epoch(w, tsync.fold_in(0, e))
    loss, acc = bound_test.evaluate(w)
    assert np.isfinite(loss) and loss < loss0 and acc > 0.6


@pytest.mark.parametrize("kernel", ["pallas", "scalar"])
def test_fault_2_a_sparse_svm_subclass_trains_by_its_own_rule_as_in_jax(kernel):
    # it trained by hinge's rule, bit for bit plain SparseSVM's result
    jb, tb, data = _engines(JaxShiftedSVM, ShiftedSVM, kernel)
    w_j, w_t, ids = _epoch(jb, tb)
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=ATOL)
    hinge = tsync.SyncEngine(SparseSVM(LAM, D, regularizer="l2", device="cpu"), batch_size=B,
                             learning_rate=LR, virtual_workers=K, device="cpu").bind(
        _torch(data))
    w_h = hinge._run(torch.zeros(D), torch.from_numpy(ids))
    assert float((w_t - w_h).abs().max()) > 1e-2


# -- the mean mode: Hogwild and local SGD with JAX's draws --------------------------

def test_one_hogwild_dispatch_matches_the_jax_worker():
    d, b, k = 1000, 16, 8
    data = rcv1_like(600, n_features=d, nnz=12, seed=5, idf_values=True)
    shard = data.slice(np.arange(100, 400))
    jm, tm = _pair(JaxSquaredHinge, SquaredHinge, d=d)
    jw = jhog._Worker(1, jm, shard, jax.devices()[0], b, LR, 0, JaxMetrics(),
                      steps_per_dispatch=k)
    tw = thog._Worker(1, tm, ShardedData(torch.from_numpy(shard.indices),
                                         torch.from_numpy(shard.values),
                                         torch.from_numpy(shard.labels).float(),
                                         n_true=len(shard)),
                      b, LR, 0, Metrics(), steps_per_dispatch=k)
    assert tw._steps.fused  # the mean mode of sync_epoch
    w0 = (np.random.default_rng(1).normal(size=d) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jw._step(jnp.asarray(w0), None, jw._idx, jw._val, jw._y, key)[0])
    ids = np.stack([np.asarray(jax.random.randint(kk, (b,), 0, len(shard)))
                    for kk in jax.random.split(key, k)])[:, None, :].astype(np.int64)
    got = tw._step(torch.from_numpy(w0), torch.from_numpy(ids))
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_local_sgd_fit_with_the_jax_draws_matches_jax():
    d, b, h = 500, 16, 32
    data = rcv1_like(5250, n_features=d, nnz=8, noise=0.02, seed=9, idf_values=True)
    train, test = train_test_split(data)
    jm, tm = _pair(JaxSquaredHinge, SquaredHinge, d=d)
    kw = dict(batch_size=b, learning_rate=LR, sync_period=h, check_every=1024, seed=4)
    jr = JaxLocalSGD(jm, make_mesh(1), metrics=JaxMetrics(), **kw).fit(train, test, 1)
    eng = tlocal.LocalSGDEngine(tm, metrics=Metrics(), device="cpu", **kw)
    key, draws = jax.random.PRNGKey(4), []
    for _ in range(-(-len(train) // h)):  # local_sgd.py: a key a round, device 0, then the step
        key, rk = jax.random.split(key)
        dk = jax.random.fold_in(rk, 0)
        draws.append(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(dk, t), (b,),
                                                             0, 8192))
                               for t in range(h)])[:, None, :].astype(np.int64))
    eng._sample_ids = lambda rnd, shard_n: torch.from_numpy(draws[rnd])
    res = eng.fit(_torch(train), _torch(test), 1)
    assert res.state.updates == jr.state.updates
    np.testing.assert_allclose(res.test_losses, jr.test_losses, atol=ATOL)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jr.weights), atol=ATOL)
    assert min(res.test_losses) < res.test_losses[0]


# -- the RPC worker: the Gradient body and the K-step window --------------------------

@pytest.fixture(scope="module")
def lone_workers():
    """A port worker and a JAX worker on SquaredHinge over the same rows,
    neither registered (their bodies are called directly)."""
    train, _ = train_test_split(rcv1_like(600, n_features=200, nnz=10, seed=11,
                                          idf_values=True))
    jm, tm = _pair(JaxSquaredHinge, SquaredHinge, d=200)
    jw = JaxWorker("127.0.0.1", 0, "127.0.0.1", 1, train, jm, device=jax.devices()[0])
    tw = WorkerNode("127.0.0.1", 0, "127.0.0.1", 1, _torch(train), tm)
    yield jw, tw
    for w in (jw, tw):
        w.server.stop(None)
        w._master_channel.close()


@pytest.mark.parametrize("n,k", [(16, 1), (55, 4), (64, 4)])
def test_the_gradient_body_and_the_window_match_the_jax_worker(lone_workers, n, k):
    jw, tw = lone_workers
    rng = np.random.default_rng(n + k)
    ids = rng.choice(480, size=n, replace=False).astype(np.int64)
    w = (rng.normal(size=200) * 0.3).astype(np.float32)
    if k == 1:
        got, want = tw.compute_gradient(w, ids), jw.compute_gradient(w, ids)
        # the body is the model's grad_regularized: worker_grads at K=1 with the rule
        tm = tw.model
        rows = torch.from_numpy(ids)
        direct = tm.grad_regularized(torch.from_numpy(w), tsync.SparseBatch(
            tw._resident.idx[rows], tw._resident.val[rows]), tw._resident.y[rows])
        np.testing.assert_array_equal(got, direct.numpy())
    else:
        got, want = (x.compute_local_window(w, ids, k, 16, LR) for x in (tw, jw))
    assert np.abs(want).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_the_window_is_the_plain_sum_mode_of_the_rule():
    # the sum mode (grad_divisor 1, one worker, sgd) of the variant's
    # plain version is the model's own rule, not hinge's
    w, idx, val, y = _batches(1, 40, 6, seed=8)
    data = [torch.from_numpy(a.reshape(40, 6) if a.ndim == 3 else a.reshape(40))
            for a in (idx, val, y)]
    ids = torch.arange(40).view(4, 1, 10)
    rule = SquaredHinge(LAM, D, regularizer="l2", device="cpu").coeff
    kw = dict(reg_kind="l2", lam=LAM, dim_sparsity=None, lr=LR, n_total_workers=1)
    got = se.sync_epoch(torch.from_numpy(w), ids, *data, coeff=rule, **kw)
    want = torch.from_numpy(w)
    for rows in ids:
        g = wg.worker_grads_plain(want, data[0][rows], data[1][rows], data[2][rows], rule)
        want = want - LR * (g[0] + 2 * LAM * want)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    hinge = se.sync_epoch(torch.from_numpy(w), ids, *data, coeff=co.HINGE, **kw)
    assert float((got - hinge).abs().max()) > 1e-3
