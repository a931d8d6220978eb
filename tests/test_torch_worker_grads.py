"""The port's worker-gradient op (distributed_sgd_tpu_torch/ops/
worker_grads.py) against the JAX package's Pallas kernel, run in
interpret mode as tests/test_pallas_kernels.py runs it, and against the
JAX model's blocked gradient.

On the CPU the wrapper runs its plain torch version; the CUDA kernel
itself is held against that plain version on the card by chip_smoke.py.
Tolerance rtol 1e-4 / atol 1e-5: the bound tests/test_pallas_kernels.py
holds the Pallas kernel to against the blocked path (f32 sums taken in
another order)."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_sgd_tpu.models import linear as jlinear
from distributed_sgd_tpu.ops import mxu, pallas_sparse
from distributed_sgd_tpu.ops.sparse import SparseBatch as JBatch
from distributed_sgd_tpu_torch import convert
from distributed_sgd_tpu_torch.models import linear as tlinear
from distributed_sgd_tpu_torch.ops import _build
from distributed_sgd_tpu_torch.ops import coeff as co
from distributed_sgd_tpu_torch.ops import worker_grads as wg

torch.set_num_threads(1)

RTOL, ATOL = 1e-4, 1e-5
D = 700
MODELS = [(jlinear.SparseSVM, tlinear.SparseSVM),
          (jlinear.LogisticRegression, tlinear.LogisticRegression),
          (jlinear.LeastSquares, tlinear.LeastSquares)]


def _batches(k, b, p, seed):
    """idx/val/y [K, B, P] with zero values, a duplicate id inside row 0 of
    each worker and an all-pad last row (idx 0, val 0, y 0)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, D, (k, b, p)).astype(np.int32)
    val = rng.normal(size=(k, b, p)).astype(np.float32)
    val[rng.random((k, b, p)) < 0.2] = 0.0
    y = rng.choice([-1.0, 1.0], (k, b)).astype(np.float32)
    idx[:, 0, 1] = idx[:, 0, 0]
    val[:, 0, :2] = (0.7, -0.2)
    idx[:, -1], val[:, -1], y[:, -1] = 0, 0.0, 0.0
    w = (rng.normal(size=D) * 0.1).astype(np.float32)
    return w, idx, val, y


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("b", [10, 37])
@pytest.mark.parametrize("jcls,tcls", MODELS, ids=["hinge", "logistic", "least_squares"])
def test_plain_matches_pallas_kernel_and_blocked_gradient(jcls, tcls, b):
    w, idx, val, y = _batches(3, b, 6, seed=b)
    jmodel = jcls(lam=1e-3, n_features=D, regularizer="l2")
    w2 = mxu.to_blocked(jnp.asarray(w), D)
    pallas = np.asarray(pallas_sparse.worker_grads(
        w2, jnp.asarray(idx), jnp.asarray(val), jnp.asarray(y),
        jmodel.grad_coeff, interpret=True))

    got = wg.worker_grads_plain(*_torch(w, idx, val, y), tcls.coeff_kind)
    assert got.shape == (3, D)
    got_blocked = convert.to_blocked(got.numpy(), D)
    np.testing.assert_allclose(got_blocked, pallas, rtol=RTOL, atol=ATOL)
    for k in range(3):
        want = jmodel.grad_blocked(w2, JBatch(jnp.asarray(idx[k]), jnp.asarray(val[k])),
                                   jnp.asarray(y[k]))
        np.testing.assert_allclose(got_blocked[k], np.asarray(want), rtol=RTOL, atol=ATOL)


def test_pad_rows_and_duplicates_are_handled():
    w, idx, val, y = _batches(2, 5, 4, seed=7)
    g = wg.worker_grads_plain(*_torch(w, idx, val, y), co.LEAST_SQUARES).numpy()
    # the dense reference: every row's entries accumulate, duplicates too
    want = np.zeros((2, D), np.float32)
    for k in range(2):
        for r in range(5):
            m = float(np.dot(w[idx[k, r]], val[k, r]))
            np.add.at(want[k], idx[k, r], 2.0 * (m - y[k, r]) * val[k, r])
    np.testing.assert_allclose(g, want, rtol=RTOL, atol=ATOL)
    # the all-pad row contributes nothing: zero it out and compare
    idx2, val2 = idx.copy(), val.copy()
    idx2[:, -1], val2[:, -1] = 5, 0.0
    g2 = wg.worker_grads_plain(*_torch(w, idx2, val2, y), co.LEAST_SQUARES).numpy()
    np.testing.assert_array_equal(g, g2)


def test_hinge_at_zero_weights_adds_every_sample():
    # w = 0: y*m = 0 is not < 0, so every sample contributes y*x
    _, idx, val, y = _batches(1, 8, 5, seed=3)
    g = wg.worker_grads_plain(torch.zeros(D), *_torch(idx, val, y), co.HINGE).numpy()
    want = np.zeros(D, np.float32)
    for r in range(8):
        np.add.at(want, idx[0, r], y[0, r] * val[0, r])
    np.testing.assert_allclose(g[0], want, rtol=RTOL, atol=ATOL)


def test_cpu_wrapper_runs_plain_version_without_launching():
    w, idx, val, y = _batches(3, 10, 6, seed=1)
    before = wg.worker_grads.launches
    got = wg.worker_grads(*_torch(w, idx, val, y), co.LOGISTIC)
    np.testing.assert_array_equal(
        got.numpy(), wg.worker_grads_plain(*_torch(w, idx, val, y), co.LOGISTIC).numpy())
    assert wg.worker_grads.launches == before


@pytest.mark.parametrize("bad", ["idx_dtype", "shape", "kind", "noncontig"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    w, idx, val, y = _torch(*_batches(2, 4, 3, seed=2))
    kind = co.HINGE
    if bad == "idx_dtype":
        idx, err = idx.long(), TypeError
    elif bad == "shape":
        y, err = y[:, :3].contiguous(), ValueError
    elif bad == "kind":
        kind, err = 7, ValueError
    else:
        val, err = val.transpose(0, 1).contiguous().transpose(0, 1), ValueError
    with pytest.raises(err):
        wg.worker_grads(w, idx, val, y, kind)


def test_build_targets_hopper_and_needs_nvcc():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.KERNELS == ("worker_grads", "sync_epoch")
    for name in _build.KERNELS:
        assert (_build.CSRC_DIR / f"{name}.cu").exists()
        path = _build.library_path(name)
        assert path.parent == _build.BUILD_DIR and path.name.startswith(f"lib{name}.")
    if shutil.which("nvcc") is None:
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build()


PLAN_SHAPES = [(1, 100, 76), (8, 100, 76), (3, 37, 76), (64, 1, 1), (8, 1024, 76),
               (2, 4096, 128), (64, 512, 8), (1, 4, 2 ** 30)]
PLAN_DS = [1, 2, 127, 4096, 4097, 16384, 47236, 100003, 1_000_000]


SMEM_PER_BLOCK = 232_448  # a Hopper block's shared memory (the opt-in limit)


@pytest.mark.parametrize("k,b,p", PLAN_SHAPES, ids=[f"K{k}-B{b}-P{p}" for k, b, p in PLAN_SHAPES])
@pytest.mark.parametrize("d", PLAN_DS + ["boundary", "one past a boundary"])
def test_launch_plan_covers_every_feature_once_within_shared_memory(k, b, p, d):
    if d == "boundary":
        d = wg.SPAN_TARGET
    elif d == "one past a boundary":
        d = wg.SPAN_TARGET + 1
    plan = wg.launch_plan(k, b, p, d)
    assert plan.ranges >= 1 and plan.span >= 1 and 1 <= plan.cap <= b
    covered = np.zeros(d, np.int32)
    for r in range(plan.ranges):
        covered[r * plan.span:(r + 1) * plan.span] += 1
    assert (covered == 1).all()
    assert (plan.ranges - 1) * plan.span < d <= plan.ranges * plan.span  # no empty block
    # the kernel's whole shared memory is the plan's: it declares no static __shared__
    src = (_build.CSRC_DIR / "worker_grads.cu").read_text()
    code = [line for line in src.splitlines() if not line.strip().startswith("//")]
    static_smem = sum(1 for line in code if "__shared__" in line and "extern" not in line)
    assert static_smem == 0
    assert plan.smem == 8 * plan.span + 4 * plan.cap + 8 <= SMEM_PER_BLOCK - static_smem
    assert plan.span <= wg.SPAN_TARGET
    assert k * plan.ranges < 2 ** 31 and plan.cap * p <= 2 ** 31 - 1 - wg.WALK


def test_kernel_names_and_one_launch_are_unchanged_for_callers():
    assert _build.KERNELS == ("worker_grads", "sync_epoch")
    src = (_build.CSRC_DIR / "worker_grads.cu").read_text()
    assert 'extern "C" int dsgd_worker_grads(' in src
    assert src.count("__global__") == 1 and src.count("<<<") == 1
    wrapper = (_build.PACKAGE_DIR / "ops" / "worker_grads.py").read_text()
    assert ".dsgd_worker_grads" in wrapper
