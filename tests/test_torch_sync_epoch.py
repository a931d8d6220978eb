"""The port's whole-epoch op (distributed_sgd_tpu_torch/ops/sync_epoch.py)
and the sync engine's epoch through it, against the JAX package's
BoundSync.epoch fed the same sample ids.

On the CPU the wrapper runs its plain torch version; the CUDA cluster
kernel itself is held against that plain version on the card by
chip_smoke.py.  Weights after one epoch are held to atol 1e-5 (f32
gradient sums in another order over up to 82 steps); evaluate() to rtol
1e-5 (chunk sums in another order)."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.data.rcv1 import dim_sparsity
from distributed_sgd_tpu.data.synthetic import rcv1_like
from distributed_sgd_tpu.models.linear import make_model as jax_make_model
from distributed_sgd_tpu.parallel import sync as jsync
from distributed_sgd_tpu.parallel.mesh import make_mesh
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.data.rcv1 import Dataset as TDataset
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import sync_epoch as se
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
            dict(coeff_kind=m.coeff_kind, reg_kind=m.reg_kind, lam=m.lam,
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
                                 "reg_kind", "no_dim_sparsity", "coeff_kind", "workers"])
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
        kw["coeff_kind"] = 9
    else:
        kw["n_total_workers"] = 0
    with pytest.raises(err):
        se.sync_epoch(w, ids, idx, val, y, **kw)


def test_cluster_plan_fits_the_main_shape_and_refuses_past_the_budget():
    plan = se.cluster_plan(3, 47236)
    assert plan == se.ClusterPlan(blocks=8, slice=5908, smem_bytes=4 * (5 * 5908 + 34))
    assert plan.blocks * plan.slice >= 47236 and plan.smem_bytes <= se.SMEM_BYTES_PER_BLOCK
    assert se.cluster_plan(7, 47236) is not None
    assert se.cluster_plan(8, 47236) is None
    assert se.cluster_plan(3, 10 ** 6) is None
    assert se.cluster_plan(0, 100) is None


def test_an_engine_whose_shape_does_not_fit_takes_the_per_step_path(monkeypatch, caplog):
    monkeypatch.setattr(se, "SMEM_BYTES_PER_BLOCK", 4096)  # (2+3) * 252 floats do not fit
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

