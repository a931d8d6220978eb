"""The port's optimizers (momentum = optax.sgd(lr, momentum=m), adam =
optax.adam(lr)) against the JAX package's, on the CPU: the sync engine's
epoch (through ``sync_epoch``'s plain version) and per-step path, the
async local steps (``MeanSteps``), a Hogwild worker across dispatches and
a local SGD fit, each fed the same sample ids as the JAX engine (JAX's own
draws where the JAX engine draws inside its program), the Pallas kernel in
interpret mode.

Tolerances.  Momentum: weights and the trace to atol 1e-5, as the sgd
tests (f32 gradient sums in another order).  Adam: weights and moments to
atol 1e-5 as well, with lr 0.01.  Adam's update divides by the bias
corrections ``1 - b**count``: JAX takes the power in float32 and the port
from a table (``ops/sync_epoch.bias_corrections``: JAX's float32 b raised
in double, rounded once), which differ by up to 7e-6 relative at b2 = 0.999
over the first 3,000 steps (held below); through ``sqrt(nu / bc2)`` that
moves a step's update by under 4e-6 relative, far inside the atol at these
step sizes.  Adam's first step on an entry is ``sign(g) * lr`` for any g
well above eps = 1e-8, so an entry whose g is an f32 rounding residue
could flip; none does at these shapes."""

import inspect
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_sgd_tpu.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel import hogwild as jhog
from distributed_sgd_tpu.parallel import sync as jsync
from distributed_sgd_tpu.parallel.local_sgd import LocalSGDEngine as JaxLocalSGD
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu.utils.metrics import Metrics as JaxMetrics
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch import main as tmain
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.ops import sync_epoch as se
from distributed_sgd_tpu_torch.parallel import hogwild as thog
from distributed_sgd_tpu_torch.parallel import local_sgd as tlocal
from distributed_sgd_tpu_torch.parallel import sync as tsync
from distributed_sgd_tpu_torch.parallel.sync import ShardedData
from distributed_sgd_tpu_torch.utils.metrics import Metrics


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

N, D, NNZ, B, LAM = 900, 700, 12, 37, 1e-3
LR = {"momentum": 0.05, "adam": 0.01}
ATOL = 1e-5
OPTS = ["momentum", "adam"]


def _torch(ds):
    return TDataset(ds.indices, ds.values, ds.labels, ds.n_features)


def _engines(opt, reg, k, kernel="mxu", model="hinge", momentum=0.9):
    data = rcv1_like(N, n_features=D, nnz=NNZ, seed=13, idf_values=True)
    ds = dim_sparsity(data)
    jm = jax_make_model(model, LAM, D, dim_sparsity=jnp.asarray(ds), regularizer=reg)
    tm = convert.model_from_jax(model, LAM, D, ds, reg, device="cpu")
    kw = dict(batch_size=B, learning_rate=LR[opt], virtual_workers=k, optimizer=opt,
              momentum=momentum)
    jb = jsync.SyncEngine(jm, make_mesh(1), kernel=kernel, **kw).bind(data)
    tb = tsync.SyncEngine(tm, device="cpu", **kw).bind(_torch(data))
    return jb, tb


def _owned_ids(bound, seed=0):
    """[steps, K, B] ids, each worker drawing from its own sub-shard."""
    sub, starts, sizes = bound._subshards()
    rng = np.random.default_rng(seed)
    shape = (bound.steps_per_epoch, bound.virtual_workers, bound.batch_size)
    return rng.integers(0, sub, shape) % np.minimum(sub, sizes)[:, None] + starts[:, None]


def _inject(jb, tb, ids):
    jb._sample_ids = lambda key, step: jnp.asarray(ids, jnp.int32)[step]
    tb._sample_ids = lambda key: torch.from_numpy(ids)


def _assert_state_matches(tb, jb, opt):
    """Every leaf, the JAX engine's brought to the port's flat layout."""
    want = convert.opt_state_from_jax(jb.opt_state_leaves(), opt, D, device="cpu")
    got = tb._opt_state
    assert got.count == want.count
    for g, w in zip(got.vectors, want.vectors, strict=True):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


# -- the sync engine ---------------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("reg", ["dim_sparsity", "l2", "none"])
@pytest.mark.parametrize("kernel", ["pallas", "mxu"])
@pytest.mark.parametrize("opt", OPTS)
def test_epoch_and_multi_epoch_with_an_optimizer_match_jax(opt, kernel, reg, k):
    jb, tb = _engines(opt, reg, k, kernel)
    assert tb.epoch_kernel and tb.steps_per_epoch == jb.steps_per_epoch
    ids = _owned_ids(tb)
    _inject(jb, tb, ids)
    w_t = tb.epoch(torch.zeros(D), key=0)
    w_j = jb.epoch(jnp.zeros(D, jnp.float32), jax.random.PRNGKey(0))
    assert np.abs(np.asarray(w_j)).max() > 1e-3  # the epoch moved the weights
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL)
    _assert_state_matches(tb, jb, opt)
    # two more epochs from there, the state carried on: the same ids each
    # epoch on both sides (the injected draws ignore the epoch key)
    w_t = tb.multi_epoch(w_t, key=1, n_epochs=2)
    w_j = jb.multi_epoch(w_j, jax.random.PRNGKey(1), 2)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL)
    _assert_state_matches(tb, jb, opt)
    if opt == "adam":
        assert tb._opt_state.count == 3 * tb.steps_per_epoch


@pytest.mark.parametrize("opt", OPTS)
def test_the_per_step_path_with_an_optimizer_matches_jax(opt, monkeypatch):
    monkeypatch.setattr(tsync, "cluster_plan", lambda k, d, n_state=0: None)
    jb, tb = _engines(opt, "dim_sparsity", 3, "pallas")
    assert not tb.epoch_kernel
    ids = _owned_ids(tb, seed=1)
    _inject(jb, tb, ids)
    monkeypatch.setattr(tsync, "sync_epoch", lambda *a, **kw: pytest.fail("kernel route"))
    w_t = tb.epoch(torch.zeros(D), key=0)
    w_j = jb.epoch(jnp.zeros(D, jnp.float32), jax.random.PRNGKey(0))
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=ATOL)
    _assert_state_matches(tb, jb, opt)


@pytest.mark.parametrize("opt", OPTS)
def test_state_persists_across_epochs_and_reset_equals_a_fresh_engine(opt):
    """The port's form of the JAX package's tests/test_optimizers.py
    momentum persistence test: epoch 2 from warm state differs from epoch 2
    on a fresh engine, and reset_optimizer gives the fresh engine's."""
    _, tb = _engines(opt, "l2", 3)
    ids = _owned_ids(tb, seed=2)
    tb._sample_ids = lambda key: torch.from_numpy(ids)
    w1 = tb.epoch(torch.zeros(D), 0)
    w2 = tb.epoch(w1, 1)  # warm state
    _, fresh = _engines(opt, "l2", 3)
    fresh._sample_ids = tb._sample_ids
    w2_cold = fresh.epoch(w1, 1)
    assert not np.allclose(w2.numpy(), w2_cold.numpy(), atol=1e-7)
    tb.reset_optimizer()
    assert tb._opt_state.count == 0 and all(not v.any() for v in tb._opt_state.vectors)
    np.testing.assert_array_equal(tb.epoch(w1, 1).numpy(), w2_cold.numpy())


def test_step_advances_the_state_by_one():
    _, tb = _engines("adam", "dim_sparsity", 3)
    ids = _owned_ids(tb, seed=3)
    tb._sample_ids = lambda key: torch.from_numpy(ids)
    w = tb.step(torch.zeros(D), 0)
    assert tb._opt_state.count == 1
    want, state = se.sync_epoch_plain(
        torch.zeros(D), torch.from_numpy(ids[:1]), tb.data.indices, tb.data.values,
        tb._labels_f32, coeff=tb.model.coeff_kind, reg_kind="dim_sparsity", lam=LAM,
        dim_sparsity=tb.model.dim_sparsity, lr=LR["adam"], n_total_workers=3,
        optimizer=tb.optimizer)
    assert torch.equal(w, want) and all(map(torch.equal, tb._opt_state.vectors, state.vectors))


@pytest.mark.parametrize("opt", OPTS)
def test_opt_state_leaves_round_trip_through_load(opt):
    _, tb = _engines(opt, "dim_sparsity", 3)
    tb._sample_ids = lambda key: torch.from_numpy(_owned_ids(tb, seed=4))
    tb.epoch(torch.zeros(D), 0)
    leaves = tb.opt_state_leaves()
    kinds = [(tuple(x.shape), x.dtype) for x in leaves]
    vec = ((D,), torch.float32)
    assert kinds == ([((), torch.int32), vec, vec] if opt == "adam" else [vec])
    saved = tb._opt_state
    tb.reset_optimizer()
    tb.load_opt_state_leaves(leaves)
    assert tb._opt_state.count == saved.count
    assert all(map(torch.equal, tb._opt_state.vectors, saved.vectors))
    # the JAX engine's blocked leaves load too
    tb.reset_optimizer()
    tb.load_opt_state_leaves(convert.opt_state_to_jax(saved, opt, blocked=True))
    assert all(map(torch.equal, tb._opt_state.vectors, saved.vectors))


# -- the kernel's optimizer modes: wrapper, budget, bias table ---------------

def test_cluster_plan_budgets_with_optimizer_state():
    d = 47236
    # the main path's K=3 fits in all three modes
    for n_state, k_max in [(0, 4), (1, 3), (2, 3)]:
        assert se.cluster_plan(k_max, d, n_state) is not None
        assert se.cluster_plan(k_max + 1, d, n_state) is None
    plan = se.cluster_plan(3, d, 2)
    assert plan.smem_bytes == (8 * 3 + 4 * 3) * 5908 + 4 * 50 <= se.SMEM_BYTES_PER_BLOCK
    # the mean mode (K = 1): the largest D each optimizer fits, no lower
    # than with the f32 sums and dim_sparsity in shared memory (the pushed
    # partials, 48 B more than the pulled ones, take 32 features from sgd
    # and momentum)
    for n_state, d_max in [(0, 154816), (1, 116096), (2, 92896)]:
        assert se.cluster_plan(1, d_max, n_state) is not None
        assert se.cluster_plan(1, d_max + 1, n_state) is None
    assert [se.Optimizer(kind).n_state for kind in se.OPT_KINDS] == [0, 1, 2]


def _op_case(opt, steps=4, k=3):
    _, tb = _engines(opt, "dim_sparsity", k)
    ids = torch.from_numpy(_owned_ids(tb, seed=5)[:steps])
    m = tb.model
    args = (torch.zeros(D), ids, tb.data.indices, tb.data.values, tb._labels_f32)
    kw = dict(coeff=m.coeff_kind, reg_kind=m.reg_kind, lam=m.lam,
              dim_sparsity=m.dim_sparsity, lr=LR[opt], n_total_workers=k,
              optimizer=tb.optimizer)
    return args, kw


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "missing_vector", "count",
                                 "state_without_optimizer", "kind"])
def test_wrapper_rejects_a_bad_optimizer_state(bad):
    args, kw = _op_case("adam")
    mu, nu = torch.zeros(D), torch.zeros(D)
    err = ValueError
    if bad == "dtype":
        mu, err = mu.double(), TypeError
    elif bad == "shape":
        nu = torch.zeros(D + 1)
    elif bad == "device":
        nu = nu.to("meta")
    elif bad == "missing_vector":
        kw["opt_state"] = se.OptState((mu,), 0)
    elif bad == "count":
        kw["opt_state"] = se.OptState((mu, nu), -1)
    elif bad == "state_without_optimizer":
        kw["optimizer"] = None
    else:
        kw["optimizer"] = se.Optimizer("rmsprop")
    kw.setdefault("opt_state", se.OptState((mu, nu), 0))
    with pytest.raises(err):
        se.sync_epoch(*args, **kw)


@pytest.mark.parametrize("opt", ["sgd", *OPTS])
def test_the_cpu_wrapper_is_the_plain_version_and_leaves_its_inputs(opt):
    args, kw = _op_case("adam")
    kw["optimizer"] = se.Optimizer(opt)
    state = se.init_opt_state(kw["optimizer"], D, "cpu")
    before = [v.clone() for v in state.vectors]
    launches = dict(se.sync_epoch.opt_launches)
    w, got = se.sync_epoch(*args, **kw, opt_state=state)
    w_p, want = se.sync_epoch_plain(*args, **kw, opt_state=state)
    assert torch.equal(w, w_p) and got.count == want.count == (4 if opt == "adam" else 0)
    assert all(map(torch.equal, got.vectors, want.vectors))
    assert all(map(torch.equal, state.vectors, before))  # the input state is untouched
    assert se.sync_epoch.opt_launches == launches  # the CPU launches nothing
    if opt == "sgd":  # the sgd mode is the update with no optimizer at all
        no_opt = {k: v for k, v in kw.items() if k != "optimizer"}
        assert got == ((), 0) and torch.equal(w, se.sync_epoch(*args, **no_opt))
    empty_w, empty = se.sync_epoch(args[0], args[1][:0], *args[2:], **kw, opt_state=state)
    assert torch.equal(empty_w, args[0]) and empty.count == 0
    assert all(e is not v and torch.equal(e, v) for e, v in zip(empty.vectors, state.vectors))


def test_bias_table_is_jax_float32_b_raised_in_double():
    table = se.bias_corrections(0, 3000)
    c = np.arange(1, 3001, dtype=np.int32)
    want = np.stack([np.asarray(jax.vmap(lambda n, b=b: 1 - b ** n)(jnp.asarray(c)))
                     for b in (se.ADAM_B1, se.ADAM_B2)], axis=1)
    assert table.dtype == np.float32 and table.shape == (3000, 2)
    rel = np.abs(table - want) / want
    assert rel[:, 0].max() < 1e-6 and rel[:, 1].max() < 7e-6  # JAX's float32 power
    # a table that starts later is the same rows
    np.testing.assert_array_equal(se.bias_corrections(100, 5), table[100:105])
    # optax's own correction divides by JAX's values
    mu = jnp.ones((), jnp.float32)
    got = float(optax.tree.bias_correction(mu, se.ADAM_B2, jnp.int32(7)))
    assert got == pytest.approx(1 / float(want[6, 1]), rel=1e-7)


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("blocked", [True, False])
def test_convert_round_trip(opt, blocked):
    rng = np.random.default_rng(6)
    vecs = tuple(torch.from_numpy(rng.normal(size=D).astype(np.float32))
                 for _ in range(se.Optimizer(opt).n_state))
    state = se.OptState(vecs, 17 if opt == "adam" else 0)
    leaves = convert.opt_state_to_jax(state, opt, blocked=blocked)
    shape = (convert.n_blocks(D), convert.LANES) if blocked else (D,)
    assert [x.shape for x in leaves[-len(vecs):]] == [shape] * len(vecs)
    if opt == "adam":
        assert leaves[0].dtype == np.int32 and leaves[0].shape == () and int(leaves[0]) == 17
    back = convert.opt_state_from_jax(leaves, opt, D, device="cpu")
    assert back.count == state.count and all(map(torch.equal, back.vectors, vecs))
    # the JAX engine's own state, as optax made it, converts too
    tx = optax.adam(0.1) if opt == "adam" else optax.sgd(0.1, momentum=0.9)
    params = jnp.asarray(leaves[-1])
    jstate = tx.init(params)
    assert len(jax.tree.leaves(jstate)) == len(leaves)
    zero = convert.opt_state_from_jax(jax.tree.leaves(jstate), opt, D, device="cpu")
    assert zero.count == 0 and all(not v.any() for v in zero.vectors)
    with pytest.raises(ValueError):
        convert.opt_state_from_jax(leaves[:-1], opt, D)


def test_resolve_optimizer_takes_the_three_names_and_no_optax():
    assert tsync.resolve_optimizer(None) == tsync.resolve_optimizer("sgd") == se.Optimizer()
    assert tsync.resolve_optimizer("momentum", 0.5) == se.Optimizer("momentum", momentum=0.5)
    assert tsync.resolve_optimizer("adam").kind == "adam"
    # the port's adam constants are optax.adam's defaults
    defaults = inspect.signature(optax.adam).parameters
    assert [defaults[k].default for k in ("b1", "b2", "eps", "eps_root")] == [
        se.ADAM_B1, se.ADAM_B2, se.ADAM_EPS, 0.0]
    with pytest.raises(ValueError, match="optimizer"):
        tsync.resolve_optimizer("bogus")
    with pytest.raises(TypeError, match="optax"):
        tsync.resolve_optimizer(optax.sgd(0.1))


# -- the async engines -----------------------------------------------------

def _worker_case(opt, model="hinge"):
    d, b, k = 600, 16, 8
    data = rcv1_like(500, n_features=d, nnz=10, seed=8, idf_values=True)
    shard = data.slice(np.arange(100, 400))
    ds = dim_sparsity(data)
    jm = jax_make_model(model, 1e-4, d, dim_sparsity=jnp.asarray(ds))
    tm = convert.model_from_jax(model, 1e-4, d, ds, device="cpu")
    jw = jhog._Worker(1, jm, shard, jax.devices()[0], b, LR[opt], 0, JaxMetrics(),
                      steps_per_dispatch=k, optimizer=opt, momentum=0.8)
    tw = thog._Worker(1, tm, ShardedData(torch.from_numpy(shard.indices),
                                         torch.from_numpy(shard.values),
                                         torch.from_numpy(shard.labels).float(),
                                         n_true=len(shard)),
                      b, LR[opt], 0, Metrics(), steps_per_dispatch=k,
                      optimizer=tsync.resolve_optimizer(opt, 0.8))
    assert not jw._blocked  # the JAX worker's state is flat [D] on the CPU

    def jax_ids(key):
        """The JAX worker's own draws for one dispatch."""
        return np.stack([np.asarray(jax.random.randint(kk, (b,), 0, len(shard)))
                         for kk in jax.random.split(key, k)])[:, None, :].astype(np.int64)

    return jw, tw, jax_ids, d


@pytest.mark.parametrize("opt", OPTS)
def test_mean_steps_with_an_optimizer_are_the_jax_hogwild_dispatch(opt):
    jw, tw, jax_ids, d = _worker_case(opt)
    w0 = (np.random.default_rng(1).normal(size=d) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jstate = jw._opt.init(jnp.zeros(d, jnp.float32))
    want, jstate = jw._step(jnp.asarray(w0), jstate, jw._idx, jw._val, jw._y, key)
    steps = tw._steps
    assert steps.fused and steps.optimizer == tsync.resolve_optimizer(opt, 0.8)
    w, state = steps.run(torch.from_numpy(w0), torch.from_numpy(jax_ids(key)))
    np.testing.assert_allclose(w0 - w.numpy(), np.asarray(want), atol=ATOL)
    jflat = convert.opt_state_from_jax(jax.tree.leaves(jstate), opt, d, device="cpu")
    assert state.count == jflat.count == (8 if opt == "adam" else 0)
    for g, wv in zip(state.vectors, jflat.vectors, strict=True):
        np.testing.assert_allclose(g.numpy(), wv.numpy(), atol=ATOL)


@pytest.mark.parametrize("opt", OPTS)
def test_a_hogwild_worker_state_advances_across_two_dispatches(opt):
    jw, tw, jax_ids, d = _worker_case(opt)
    w = np.zeros(d, np.float32)
    jstate = jw._opt.init(jnp.zeros(d, jnp.float32))
    keys = jax.random.split(jax.random.PRNGKey(4), 2)
    states = []
    for key in keys:  # two dispatches, each from the weights the last one left
        jdelta, jstate = jw._step(jnp.asarray(w), jstate, jw._idx, jw._val, jw._y, key)
        delta = tw._step(torch.from_numpy(w), torch.from_numpy(jax_ids(key)))
        np.testing.assert_allclose(delta.numpy(), np.asarray(jdelta), atol=ATOL)
        w = w - delta.numpy()
        states.append(tw._opt_state)
    jflat = convert.opt_state_from_jax(jax.tree.leaves(jstate), opt, d, device="cpu")
    assert states[1].count == jflat.count == (16 if opt == "adam" else 0)
    for g, wv in zip(states[1].vectors, jflat.vectors, strict=True):
        np.testing.assert_allclose(g.numpy(), wv.numpy(), atol=ATOL)
    assert not torch.equal(states[0].vectors[0], states[1].vectors[0])
    # StartAsync (the watchdog's restart too) makes the state anew
    tw._loop = lambda: None
    tw.start_async(w)
    tw._thread.join(timeout=30)
    assert not tw._thread.is_alive()
    assert tw._opt_state.count == 0 and all(not v.any() for v in tw._opt_state.vectors)


def _jax_local_sgd_draws(seed, n_rounds, h, b, shard_n):
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_rounds):
        key, rk = jax.random.split(key)
        dk = jax.random.fold_in(rk, 0)
        out.append(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(dk, t), (b,),
                                                           0, shard_n))
                             for t in range(h)])[:, None, :].astype(np.int64))
    return out


@pytest.mark.parametrize("opt", OPTS)
def test_local_sgd_fit_with_an_optimizer_and_the_jax_draws_matches_jax(opt):
    d, b, h = 400, 16, 32
    data = rcv1_like(2000, n_features=d, nnz=8, noise=0.02, seed=9, idf_values=True)
    train, test = train_test_split(data)
    ds = dim_sparsity(train)
    jm = jax_make_model("hinge", 1e-4, d, dim_sparsity=jnp.asarray(ds))
    tm = convert.model_from_jax("hinge", 1e-4, d, ds, device="cpu")
    kw = dict(batch_size=b, learning_rate=LR[opt], sync_period=h, check_every=256, seed=4,
              optimizer=opt, momentum=0.9)
    jr = JaxLocalSGD(jm, make_mesh(1), metrics=JaxMetrics(), **kw).fit(train, test, 1)
    eng = tlocal.LocalSGDEngine(tm, metrics=Metrics(), device="cpu", **kw)
    assert eng.optimizer.kind == opt
    shard_n = tsync.padded_layout(len(train), 1)[0]  # the padded shard both engines draw over
    draws = _jax_local_sgd_draws(4, -(-len(train) // h), h, b, shard_n)
    eng._sample_ids = lambda rnd, shard_n: torch.from_numpy(draws[rnd])
    res = eng.fit(_torch(train), _torch(test), 1)
    assert res.state.updates == jr.state.updates >= len(train)
    assert len(res.test_losses) == len(jr.test_losses) >= 4
    np.testing.assert_allclose(res.test_losses, jr.test_losses, atol=ATOL)
    np.testing.assert_allclose(res.test_accuracies, jr.test_accuracies, atol=ATOL)
    np.testing.assert_allclose(res.weights.numpy(), np.asarray(jr.weights), atol=ATOL)
    assert min(res.test_losses) < res.test_losses[0]


def test_local_sgd_averages_the_state_like_the_weights(monkeypatch):
    """The float vectors go through the same all_reduce_sum / n_workers as
    the weights, and adam's count through all_reduce_max."""
    data = rcv1_like(400, n_features=200, nnz=6, seed=10)
    train, test = train_test_split(data)
    tm = convert.model_from_jax("hinge", 1e-4, 200, dim_sparsity(train), device="cpu")
    summed, maxed = [], []
    monkeypatch.setattr(tlocal, "all_reduce_sum",
                        lambda t, group=None: summed.append(t.shape) or t)
    monkeypatch.setattr(tlocal, "all_reduce_max", lambda n, group=None: maxed.append(n) or n)
    eng = tlocal.LocalSGDEngine(tm, 8, 0.01, sync_period=4, check_every=1000,
                                optimizer="adam", metrics=Metrics(), device="cpu")
    eng.fit(_torch(train), _torch(test), 1)
    rounds = -(-len(train) // 4)
    assert summed == [(200,)] * (3 * rounds)  # w, mu, nu each round
    assert maxed == [4 * (r + 1) for r in range(rounds)]


@pytest.mark.parametrize("lr", [0.5, 0.001])
def test_adam_at_the_cli_learning_rate_diverges_in_both_packages(lr):
    """At the CLI's default lr 0.5 Adam's test loss grows every epoch and
    ends above 1.0 (its value at w = 0), in the JAX package and in the
    port alike; at 0.001 it falls every epoch.  Each package draws its own
    ids, so only the trend is held."""
    d = 47236  # the CLI's width: the divergence needs the many rare features
    data = rcv1_like(12000, n_features=d, seed=0, idf_values=True)
    train, test = train_test_split(data)
    ds = dim_sparsity(train)
    kw = dict(batch_size=100, learning_rate=lr, virtual_workers=3, optimizer="adam")
    from distributed_sgd_tpu.core.trainer import SyncTrainer as JaxTrainer
    from distributed_sgd_tpu_torch.core.trainer import SyncTrainer

    jm = jax_make_model("hinge", 1e-5, d, dim_sparsity=jnp.asarray(ds))
    want = JaxTrainer(jm, make_mesh(1), **kw).fit(train, test, 3).test_losses
    tm = convert.model_from_jax("hinge", 1e-5, d, ds, device="cpu")
    got = SyncTrainer(tm, device="cpu", **kw).fit(_torch(train), _torch(test), 3).test_losses
    for losses in (want, got):
        steps = list(zip([1.0] + losses, losses))
        if lr == 0.5:
            assert all(b > a for a, b in steps[1:]) and losses[-1] > 1.0, losses
        else:
            assert all(b < a for a, b in steps), losses


# -- the CLI ------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["sync", "gossip", "local_sgd"])
def test_dsgd_momentum_reaches_every_engine(engine, monkeypatch):
    monkeypatch.setenv("DSGD_SYNTHETIC", "600")
    monkeypatch.setenv("DSGD_MAX_EPOCHS", "1")
    monkeypatch.setenv("DSGD_OPTIMIZER", "momentum")
    monkeypatch.setenv("DSGD_MOMENTUM", "0.5")
    monkeypatch.setenv("DSGD_LEARNING_RATE", "0.05")
    if engine != "sync":
        monkeypatch.setenv("DSGD_ASYNC", "1")
        monkeypatch.setenv("DSGD_ASYNC_MODE", engine)
        monkeypatch.setenv("DSGD_STEPS_PER_DISPATCH", "8")
        monkeypatch.setenv("DSGD_CHECK_EVERY", "120")
    seen, real = [], se.apply_update

    def spy(w, g, lr, opt, state):
        out = real(w, g, lr, opt, state)
        # the trace's decay: t' = g + m * t (recorded: the Hogwild workers
        # call this from their own threads)
        seen.append((opt.momentum, torch.equal(out[1].vectors[0], g + 0.5 * state.vectors[0])))
        return out

    monkeypatch.setattr(se, "apply_update", spy)
    run = tmain.main(device="cpu")
    assert seen and set(seen) == {(0.5, True)}
    assert np.isfinite(run.fit.test_losses).all() and len(run.fit.test_losses) >= 1
