"""The port's whole-epoch op (distributed_sgd_tpu_torch/ops/sync_epoch.py)
and the sync engine's epoch through it, against the JAX package's
BoundSync.epoch fed the same sample ids.

On the CPU the wrapper runs its plain torch version; the CUDA cluster
kernel itself is held against that plain version on the card by
chip_smoke.py.  Weights after one epoch are held to atol 1e-5 (f32
gradient sums in another order over up to 82 steps); evaluate() to rtol
1e-5 (chunk sums in another order).  The mean mode (grad_divisor = B, the
async engines' local step) is held to the JAX composition of grad_mean,
regularize and local_update over the same ids, also to atol 1e-5."""

import logging
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.data.rcv1 import dim_sparsity
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.ops.sparse import SparseBatch as JaxBatch
from distributed_sgd_tpu.parallel import sync as jsync
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import sync_epoch as se
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch
from distributed_sgd_tpu_torch.parallel import sync as tsync

torch.set_num_threads(1)

N, D, NNZ, B, LAM = 3000, 2000, 20, 37, 1e-3
# least squares sums B squared-error gradients per worker: a smaller step
# keeps it from diverging at this batch
LR = {"hinge": 0.5, "logistic": 0.5, "least_squares": 0.05}


def _engines(model, reg, k, kernel, n=N):
    data = rcv1_like(n, n_features=D, nnz=NNZ, seed=11, idf_values=True)
    ds = dim_sparsity(data)
    jm = jax_make_model(model, LAM, D, dim_sparsity=jnp.asarray(ds), regularizer=reg)
    tm = convert.model_from_jax(model, LAM, D, ds, reg, device="cpu")
    jb = jsync.SyncEngine(jm, make_mesh(1), batch_size=B, learning_rate=LR[model],
                          kernel=kernel, virtual_workers=k).bind(data)
    tb = tsync.SyncEngine(tm, batch_size=B, learning_rate=LR[model], virtual_workers=k,
                          device="cpu").bind(TDataset(data.indices, data.values,
                                                      data.labels, data.n_features))
    return jb, tb


def _owned_ids(bound, seed=0, steps=None):
    """[steps, K, B] ids, each worker drawing from its own sub-shard."""
    sub, starts, sizes = bound._subshards()
    rng = np.random.default_rng(seed)
    shape = (steps or bound.steps_per_epoch, bound.virtual_workers, bound.batch_size)
    return rng.integers(0, sub, shape) % np.minimum(sub, sizes)[:, None] + starts[:, None]


def _op_args(tb, ids):
    m, d = tb.model, tb.data
    return ((torch.zeros(D), torch.as_tensor(ids), d.indices, d.values, tb._labels_f32),
            dict(coeff=m.coeff_kind, reg_kind=m.reg_kind, lam=m.lam,
                 dim_sparsity=m.dim_sparsity, lr=tb.learning_rate,
                 n_total_workers=tb.virtual_workers))


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("reg", ["dim_sparsity", "l2", "none"])
@pytest.mark.parametrize("model", ["hinge", "logistic", "least_squares"])
@pytest.mark.parametrize("kernel", ["pallas", "mxu"])
def test_epoch_through_sync_epoch_matches_jax(kernel, model, reg, k, monkeypatch):
    jb, tb = _engines(model, reg, k, kernel)
    assert tb.epoch_kernel and tb.steps_per_epoch == jb.steps_per_epoch
    ids = _owned_ids(tb)
    jb._sample_ids = lambda key, step: jnp.asarray(ids, jnp.int32)[step]
    tb._sample_ids = lambda key: torch.from_numpy(ids)
    calls = []
    monkeypatch.setattr(tsync, "sync_epoch", lambda *a, **kw: calls.append(
        tuple(a[1].shape)) or se.sync_epoch(*a, **kw))
    w_t = tb.epoch(torch.zeros(D), key=0)
    assert calls == [ids.shape]  # the whole epoch in one call

    w_j = np.asarray(jb.epoch(jnp.zeros(D, jnp.float32), jax.random.PRNGKey(0)))
    assert np.abs(w_j).max() > 1e-2  # the epoch moved the weights
    np.testing.assert_allclose(w_t.numpy(), w_j, atol=1e-5)
    np.testing.assert_allclose(tb.evaluate(w_t), jb.evaluate(jnp.asarray(w_j)), rtol=1e-5)


@pytest.mark.parametrize("reg", ["dim_sparsity", "l2", "none"])
def test_one_step_of_the_plain_version_is_the_per_step_path(reg):
    _, tb = _engines("hinge", reg, 3, "mxu")
    ids = _owned_ids(tb, seed=1, steps=2)
    w0 = torch.from_numpy(np.random.default_rng(2).normal(size=D).astype(np.float32) * 0.1)
    args, kw = _op_args(tb, ids[:1])
    got = se.sync_epoch_plain(w0, *args[1:], **kw)
    np.testing.assert_array_equal(got.numpy(), tb._one_step(w0, torch.from_numpy(ids[0])).numpy())
    # and step() takes the first step of the epoch's ids through the op
    tb._sample_ids = lambda key: torch.from_numpy(ids)
    np.testing.assert_array_equal(tb.step(w0, 5).numpy(), got.numpy())


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    _, tb = _engines("logistic", "dim_sparsity", 3, "mxu")
    args, kw = _op_args(tb, _owned_ids(tb, steps=4))
    launches, steps = se.sync_epoch.launches, se.sync_epoch.steps
    w0 = args[0].clone()
    got = se.sync_epoch(*args, **kw)
    np.testing.assert_array_equal(got.numpy(), se.sync_epoch_plain(*args, **kw).numpy())
    assert (se.sync_epoch.launches, se.sync_epoch.steps) == (launches, steps)
    assert torch.equal(args[0], w0)  # the input weights are left as they were
    empty = se.sync_epoch(args[0], args[1][:0], *args[2:], **kw)
    assert torch.equal(empty, w0) and empty is not args[0]


@pytest.mark.parametrize("bad", ["ids_dtype", "ids_shape", "values_shape", "device",
                                 "reg_kind", "no_dim_sparsity", "coeff_kind", "workers",
                                 "grad_divisor"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, tb = _engines("hinge", "dim_sparsity", 3, "mxu", n=300)
    (w, ids, idx, val, y), kw = _op_args(tb, _owned_ids(tb, steps=2))
    err = ValueError
    if bad == "ids_dtype":
        ids, err = ids.int(), TypeError
    elif bad == "ids_shape":
        ids = ids[0]
    elif bad == "values_shape":
        val = val[:, :-1].contiguous()
    elif bad == "device":
        ids = ids.to("meta")
    elif bad == "reg_kind":
        kw["reg_kind"] = "l1"
    elif bad == "no_dim_sparsity":
        kw["dim_sparsity"] = None
    elif bad == "coeff_kind":
        kw["coeff"] = 9
    elif bad == "grad_divisor":
        kw["grad_divisor"] = 0
    else:
        kw["n_total_workers"] = 0
    with pytest.raises(err):
        se.sync_epoch(w, ids, idx, val, y, **kw)


def test_cluster_plan_fits_the_main_shape_and_refuses_past_the_budget():
    # w at 4 B a feature and the integer sums at 8 B a worker and feature;
    # dim_sparsity's slice (4 B) fits beside them at K=3
    plan = se.cluster_plan(3, 47236)
    assert plan == se.ClusterPlan(blocks=8, slice=5908,
                                  smem_bytes=(8 * 3 + 4 + 4) * 5908 + 4 * 50, ds_local=True)
    assert plan.blocks * plan.slice >= 47236 and plan.smem_bytes <= se.SMEM_BYTES_PER_BLOCK
    assert se.cluster_plan(4, 47236) is not None
    assert se.cluster_plan(5, 47236) is None
    assert se.cluster_plan(3, 10 ** 6) is None
    assert se.cluster_plan(0, 100) is None


def test_an_engine_whose_shape_does_not_fit_takes_the_per_step_path(monkeypatch, caplog):
    monkeypatch.setattr(se, "SMEM_BYTES_PER_BLOCK", 4096)  # (8 * 3 + 4) * 252 B do not fit
    _, tb = _engines("hinge", "dim_sparsity", 3, "mxu", n=1200)
    assert not tb.epoch_kernel
    ids = _owned_ids(tb)
    tb._sample_ids = lambda key: torch.from_numpy(ids)

    def refuse(*a, **kw):
        raise AssertionError("sync_epoch called on the per-step path")

    monkeypatch.setattr(tsync, "sync_epoch", refuse)
    w = torch.zeros(D)
    with caplog.at_level(logging.INFO, logger="dsgd"):
        got = tb.epoch(w, 0)
        tb.epoch(w, 0)
    assert caplog.text.count("running the per-step path") == 1
    for rows in ids:
        w = tb._one_step(w, torch.from_numpy(rows))
    np.testing.assert_array_equal(got.numpy(), w.numpy())


def test_library_path_follows_the_included_header(tmp_path, monkeypatch):
    assert "sync_epoch" in _build.KERNELS
    for name in ("coeff.cuh", "worker_grads.cu", "sync_epoch.cu"):
        (tmp_path / name).write_bytes((_build.CSRC_DIR / name).read_bytes())
    monkeypatch.setattr(_build, "CSRC_DIR", tmp_path)
    # both kernels take the coefficient rules from the one header
    for name in ("worker_grads", "sync_epoch"):
        assert [p.name for p in _build._sources(name)] == [f"{name}.cu", "coeff.cuh"]
    before = {n: _build.library_path(n) for n in ("worker_grads", "sync_epoch")}
    with open(tmp_path / "coeff.cuh", "a") as f:
        f.write("// edited\n")
    after = {n: _build.library_path(n) for n in ("worker_grads", "sync_epoch")}
    assert all(before[n] != after[n] for n in before)
    with open(tmp_path / "sync_epoch.cu", "a") as f:
        f.write("// edited\n")
    assert _build.library_path("sync_epoch") != after["sync_epoch"]
    assert _build.library_path("worker_grads") == after["worker_grads"]



def _mean_case(model, reg, seed=3, steps=8):
    """JAX and port models over the same data; ids[S, 1, B]; a random w0."""
    data = rcv1_like(N, n_features=D, nnz=NNZ, seed=11, idf_values=True)
    ds = dim_sparsity(data)
    jm = jax_make_model(model, LAM, D, dim_sparsity=jnp.asarray(ds), regularizer=reg)
    tm = convert.model_from_jax(model, LAM, D, ds, reg, device="cpu")
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, (steps, 1, B))
    w0 = (rng.normal(size=D) * 0.1).astype(np.float32)
    return data, jm, tm, ids, w0


@pytest.mark.parametrize("reg", ["dim_sparsity", "l2", "none"])
@pytest.mark.parametrize("model", ["hinge", "logistic", "least_squares"])
def test_mean_mode_is_the_jax_async_local_step(model, reg):
    data, jm, tm, ids, w0 = _mean_case(model, reg)
    lr = LR[model]
    w = jnp.asarray(w0)
    for rows in ids[:, 0]:
        batch = JaxBatch(jnp.asarray(data.indices[rows]), jnp.asarray(data.values[rows]))
        g = jm.regularize(jm.grad_mean(w, batch, jnp.asarray(data.labels[rows])), w)
        w, _, _ = jsync.local_update(None, lr, g, w, None)
    want = np.asarray(w)
    assert np.abs(want - w0).max() > 1e-3  # the steps moved the weights

    y = torch.from_numpy(data.labels.astype(np.float32))
    idx, val = torch.from_numpy(data.indices), torch.from_numpy(data.values)
    got = se.sync_epoch(torch.from_numpy(w0), torch.from_numpy(ids), idx, val, y,
                        coeff=tm.coeff_kind, reg_kind=reg, lam=LAM,
                        dim_sparsity=tm.dim_sparsity, lr=lr, n_total_workers=1,
                        grad_divisor=B)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    # the port's own grad_mean is the same step
    w_t = torch.from_numpy(w0)
    for rows in ids[:, 0]:
        batch = SparseBatch(idx[rows], val[rows])
        w_t = w_t - lr * tm.regularize(tm.grad_mean(w_t, batch, y[rows]), w_t)
    np.testing.assert_allclose(got.numpy(), w_t.numpy(), atol=1e-6)
    # grad_divisor 1 is the sync step, bit for bit
    kw = dict(coeff=tm.coeff_kind, reg_kind=reg, lam=LAM, dim_sparsity=tm.dim_sparsity,
              lr=lr, n_total_workers=1)
    args = (torch.from_numpy(w0), torch.from_numpy(ids), idx, val, y)
    np.testing.assert_array_equal(se.sync_epoch_plain(*args, **kw, grad_divisor=1).numpy(),
                                  se.sync_epoch_plain(*args, **kw).numpy())


@pytest.mark.parametrize("fits", [True, False])
def test_mean_steps_take_the_kernel_or_the_per_step_route_by_shape(fits, monkeypatch):
    data, _, tm, ids, w0 = _mean_case("logistic", "dim_sparsity", seed=4, steps=5)
    if not fits:
        monkeypatch.setattr(tsync, "cluster_plan", lambda k, d, n_state=0: None)
    calls = []
    monkeypatch.setattr(tsync, "sync_epoch", lambda *a, **kw: calls.append(kw) or se.sync_epoch(*a, **kw))
    idx, val = torch.from_numpy(data.indices), torch.from_numpy(data.values)
    steps = tsync.MeanSteps(tm, idx, val, torch.from_numpy(data.labels), 0.5)
    assert steps.fused == fits
    w = torch.from_numpy(w0)
    got, state = steps.run(w, torch.from_numpy(ids))
    assert state == ((), 0)  # sgd keeps no state
    assert torch.equal(w, torch.from_numpy(w0))  # the input weights are left as they were
    want = se.sync_epoch_plain(w, torch.from_numpy(ids), idx, val,
                               torch.from_numpy(data.labels.astype(np.float32)),
                               coeff=tm.coeff_kind, reg_kind="dim_sparsity", lam=LAM,
                               dim_sparsity=tm.dim_sparsity, lr=0.5, n_total_workers=1,
                               grad_divisor=B)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert [(kw["grad_divisor"], kw["n_total_workers"]) for kw in calls] == ([(B, 1)] if fits else [])


def test_cluster_plan_fits_one_worker_at_the_main_width():
    plan = se.cluster_plan(1, 47236)
    assert plan == se.ClusterPlan(blocks=8, slice=5908, smem_bytes=16 * 5908 + 4 * 50,
                                  ds_local=True)
    # the pushed partials take 48 B more than the earlier pulled ones, so
    # the widest shape is 154,816 features (8 fewer a block) where it was
    # 154,848; there dim_sparsity stays in the L2 scratch
    assert se.cluster_plan(1, 154816) is not None and se.cluster_plan(1, 154817) is None
    assert not se.cluster_plan(1, 154816).ds_local


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_cluster_plan_keeps_dim_sparsity_in_shared_memory_where_it_fits(k):
    plan = se.cluster_plan(k, 47236)
    base = (8 * k + 4) * 5908 + 4 * 50
    assert plan.ds_local == (k <= 3)  # 4 B a feature more beside g[K] and w
    assert plan.ds_local == (base + 4 * 5908 <= se.SMEM_BYTES_PER_BLOCK)
    assert plan.smem_bytes == base + 4 * 5908 * plan.ds_local <= se.SMEM_BYTES_PER_BLOCK


@pytest.mark.parametrize("kind", ["momentum", "adam"])
def test_cluster_plan_of_an_optimizer_at_its_limit(kind):
    n_state = se.Optimizer(kind).n_state
    plan = se.cluster_plan(3, 47236, n_state)
    assert se.cluster_plan(4, 47236, n_state) is None
    base = (8 * 3 + 4 * (1 + n_state)) * 5908 + 4 * 50
    # momentum keeps dim_sparsity in shared memory, adam (12 B a feature
    # of w and state) does not
    assert plan.ds_local == (kind == "momentum")
    assert plan.smem_bytes == base + 4 * 5908 * plan.ds_local <= se.SMEM_BYTES_PER_BLOCK
    assert se.cluster_plan(1, {"momentum": 116096, "adam": 92896}[kind], n_state) is not None
    assert se.cluster_plan(1, {"momentum": 116097, "adam": 92897}[kind], n_state) is None


@pytest.mark.parametrize("reg", ["dim_sparsity", "none"])
@pytest.mark.parametrize("lr", [0.5, 0.0, 1e-30, -0.05, -0.0])
def test_sgd_keeps_an_untouched_weight_bit_for_bit_only_where_lr_has_no_sign(reg, lr):
    # the kernel's sparse sweep skips, with sgd and no l2 term, every entry
    # whose step sums are all 0; the plain version computes w - lr * 0
    # there, which is w bit for bit exactly where lr is finite with its
    # sign bit clear (the kernel takes the dense sweep otherwise)
    _, tb = _engines("hinge", reg, 3, "mxu", n=600)
    args, kw = _op_args(tb, _owned_ids(tb, steps=1))
    kw["lr"] = lr
    w0 = torch.from_numpy(np.random.default_rng(7).normal(size=D).astype(np.float32))
    touched = np.zeros(D, bool)
    rows = args[1].reshape(-1).numpy()
    touched[args[2][rows].numpy()[args[3][rows].numpy() != 0]] = True
    untouched = np.flatnonzero(~touched)
    w0[untouched[:3]] = torch.tensor([-0.0, 0.0, float("inf")])
    got = se.sync_epoch_plain(w0, *args[1:], **kw).numpy().view(np.int32)
    kept = np.array_equal(got[untouched], w0.numpy().view(np.int32)[untouched])
    assert kept == (not math.copysign(1.0, lr) < 0)


# -- the kernel's fixed-order sums: the scale of the integer accumulators ----

def _scaled(t: float, e: int) -> int:
    """A term as the kernel adds it: the f32 term times 2^e (exact in
    double), rounded to the nearest integer."""
    return round(math.ldexp(t, e))


@pytest.mark.parametrize("case", ["random", "worst"])
def test_scale_exponent_keeps_b_p_terms_at_the_bound_inside_int64(case):
    rng = np.random.default_rng(11)
    if case == "random":
        shapes = [(int(rng.integers(1, 4097)), int(rng.integers(1, 1025)),
                   float(np.float32(10.0 ** rng.uniform(-30, 30))),
                   float(np.float32(10.0 ** rng.uniform(-30, 30)))) for _ in range(200)]
    else:
        big = float(np.finfo(np.float32).max)
        tiny = float(np.finfo(np.float32).tiny)
        shapes = [(4096, 1024, big, 1.0), (1, 1, 1.0, 1.0), (100, 76, 1.0, 1.0),
                  (2 ** 20, 2 ** 10, 1.0, 1.0), (100, 76, 1.0, tiny),
                  (100, 76, 2.0 ** 64, 2.0 ** 64),
                  (100, 76, 1.0, float(np.nextafter(np.float32(1), np.float32(2))))]
    for b, p, y_max, v_max in shapes:
        e = se.scale_exponent(se.term_bound(0, se.DataBounds(y_max, v_max, 0.0)), b * p)
        with np.errstate(over="ignore"):
            t = float(np.float32(y_max) * np.float32(v_max))  # the f32 term at the bound
        if not math.isfinite(t):
            continue  # an overflowed term takes the non-finite path
        q = _scaled(t, e)
        assert b * p * abs(q) <= 2 ** se.SUM_BITS < 2 ** 63, (b, p, y_max, v_max, e)
        if abs(e) < se.SCALE_LIMIT:
            # a term at the bound converts back exactly: its last bit is
            # coarser than 2^-e
            assert math.ldexp(q, -e) == t, (b, p, y_max, v_max, e)
    assert se.scale_exponent(0.0, 7600) == 0  # no nonzero term
    assert se.scale_exponent(float("inf"), 7600) == se.SUM_BITS - 129 - 13
    # the main path's rows (ltc values <= 1, labels +-1): terms at 2^-49 and finer
    assert se.scale_exponent(1.0, 100 * 76) == 62 - 1 - 13


def test_least_squares_bounds_every_term_from_the_step_largest_weight():
    # least squares keeps the kernel: each step bounds c = 2 (m - y) from
    # the cluster's largest |w|, and no term it computes in f32 exceeds it
    rng = np.random.default_rng(12)
    for trial in range(20):
        n, p = 64, 24
        val = (rng.normal(size=(n, p)) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
        y = (rng.normal(size=n) * 10.0 ** rng.uniform(-2, 2)).astype(np.float32)
        w = (rng.normal(size=p) * 10.0 ** rng.uniform(-3, 3)).astype(np.float32)
        bounds = se.data_bounds(torch.from_numpy(val), torch.from_numpy(y))
        bound = se.term_bound(2, bounds, w_max=float(np.abs(w).max()))
        m = np.zeros(n, np.float32)
        for q in range(p):  # the margins summed in f32, as the kernel sums
            m = m + w[q] * val[:, q]
        c = np.float32(2) * (m - y)
        terms = np.abs(c[:, None] * val)
        assert terms.max() <= bound, trial
        e = se.scale_exponent(bound, 100 * 76)
        assert 100 * 76 * _scaled(float(terms.max()), e) <= 2 ** se.SUM_BITS


def test_data_bounds_skip_non_finite_entries_and_follow_writes():
    val = torch.tensor([[0.5, -3.0, 0.0], [float("inf"), 1.0, -1.0]])
    y = torch.tensor([1.0, -2.0])
    got = se.data_bounds(val, y)
    assert got == se.DataBounds(2.0, 3.0, 3.5)
    assert se.data_bounds(val, y) is got  # computed once for the same tensors
    val[0, 0] = -7.0  # a write: computed anew
    assert se.data_bounds(val, y) == se.DataBounds(2.0, 7.0, 10.0)
