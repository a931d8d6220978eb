"""The plain reference against hand-worked steps, and its frozen copies of
the program's sampling against the program."""

import numpy as np
import pytest
import torch

from gpubench.reference import linear as ref

# two rows over three features: x0 = (0.6, 0.8, 0) with y = +1 and
# x1 = (0, 0.8, 0.6) with y = -1
ROWS = ref.Split(torch.tensor([[0, 1], [1, 2]], dtype=torch.int32),
                 torch.tensor([[0.6, 0.8], [0.8, 0.6]]), torch.tensor([1, -1], dtype=torch.int32))


def problem(reg="l2", lam=0.01, precision=ref.REFERENCE):
    return ref.make_problem(ROWS, ROWS, 3, lam, reg, precision)


def test_local_sgd_steps_by_hand():
    # step 1 from w = 0: every margin is 0, so each coefficient is y; the mean
    # of (0.6, 0.8, 0) and -(0, 0.8, 0.6) is (0.3, 0, -0.3); w1 = -0.5 g.
    # step 2: both margins have y*m = -0.09 < 0, so only 2*lam*w1 is left
    p = problem()
    ids = torch.tensor([[[0, 1]], [[0, 1]]])
    st = ref.run_steps(p, ref.init_state(p, "sgd", "cpu"), ids[:1], 0.5, mean=True)
    assert torch.allclose(st.w, torch.tensor([-0.15, 0.0, 0.15]))
    st = ref.run_steps(p, st, ids[1:], 0.5, mean=True)
    assert torch.allclose(st.w, torch.tensor([-0.1485, 0.0, 0.1485]))


def test_sync_step_by_hand_with_dim_sparsity():
    # two workers of one row each: the sums' mean is (0.3, 0, -0.3); the
    # regulariser's scalar 2*lam*(w.ds) is 0 at w = 0 and again at w1, whose
    # w.ds = -0.15/2 + 0.15/2; at w1 both coefficients are 0, so g = 0
    p = problem("dim_sparsity")
    assert torch.allclose(p.dim_sparsity, torch.tensor([1 / 2, 1 / 3, 1 / 2]))
    st = ref.run_steps(p, ref.init_state(p, "sgd", "cpu"), torch.tensor([[[0], [1]]]), 0.5,
                       mean=False)
    assert torch.allclose(st.w, torch.tensor([-0.15, 0.0, 0.15]))
    st2 = ref.run_steps(p, st, torch.tensor([[[0], [1]]]), 0.5, mean=False)
    assert torch.equal(st2.w, st.w)
    # the half-batch fault takes the sync step's sum over the rows left
    half = ref.run_steps(p, ref.init_state(p, "sgd", "cpu"), torch.tensor([[[0, 1], [1, 0]]]),
                         0.5, mean=False, half_batch=True)
    assert torch.allclose(half.w, torch.tensor([-0.15, 0.0, 0.15]))


def test_adam_step_by_hand():
    # mu = 0.1 g, nu = 0.001 g^2, bias-corrected by 0.1 and 0.001: u = g/|g|
    p = problem(lam=0.0)
    st = ref.run_steps(p, ref.init_state(p, "adam", "cpu"), torch.tensor([[[0, 1]]]), 0.1,
                       mean=True)
    assert st.count == 1
    assert torch.allclose(st.w, torch.tensor([-0.1, 0.0, 0.1]), atol=1e-6)
    assert torch.allclose(ref.first_gradient(st, torch.zeros(3), 0.1).float(),
                          torch.tensor([0.3, 0.0, -0.3]))


def test_evaluation_by_hand_and_the_tie_band():
    p = problem()
    e = ref.evaluate(p, torch.tensor([-0.15, 0.0, 0.15]), "test")
    # both predictions -signum(m) equal y: accuracy 1, losses 0
    assert e.accuracy == 1.0 and e.objective == pytest.approx(0.01 * 0.045)
    assert (e.objective_lo, e.objective_hi) == (e.objective, e.objective)
    # w = (1, 1, 1): both margins are 1.4, predictions -1: row 0 misses (loss
    # 2), row 1 hits.  w = (0.8, -0.6, 0): row 0's margin is exactly 0, a tie
    # (loss 0 to 2, hit 0 to 1); row 1's is -0.48, a miss (loss 2)
    e = ref.evaluate(p, torch.tensor([1.0, 1.0, 1.0]), "test")
    assert e.accuracy == 0.5 and e.objective == pytest.approx(0.03 + 1.0)
    e = ref.evaluate(p, torch.tensor([0.8, -0.6, 0.0]), "test")
    assert (e.accuracy_lo, e.accuracy_hi) == (0.0, 0.5)
    assert e.objective_lo == pytest.approx(1.01) and e.objective_hi == pytest.approx(2.01)


def test_frozen_sampling_matches_the_program():
    from distributed_sgd_tpu_torch.data.rcv1 import Dataset
    from distributed_sgd_tpu_torch.models.linear import make_model
    from distributed_sgd_tpu_torch.parallel import local_sgd, sync

    rng = np.random.default_rng(0)
    n, d = 9001, 50
    data = Dataset(indices=rng.integers(0, d, (n, 4)).astype(np.int32),
                   values=rng.random((n, 4)).astype(np.float32),
                   labels=np.where(rng.random(n) < 0.5, 1, -1).astype(np.int32), n_features=d)
    for key, data_ in ((5, 0), (2 ** 40 + 3, 7)):
        assert ref.fold_in(key, data_) == sync.fold_in(key, data_)
    model = make_model("hinge", 1e-5, d, regularizer="l2", device="cpu")
    bound = sync.SyncEngine(model, 100, 0.5, virtual_workers=3, device="cpu").bind(data)
    assert bound.shard_n == ref.padded_rows(n)
    for seed, epoch in ((11, 0), (2 ** 31 + 9, 4)):
        want = bound._sample_ids(sync.fold_in(sync.fold_in(seed, epoch), 0))
        assert torch.equal(ref.sync_epoch_ids(seed, epoch, n, 3, 100, "cpu"), want)
    eng = local_sgd.LocalSGDEngine(model, 256, 0.5, sync_period=16, seed=13, device="cpu")
    assert torch.equal(ref.local_round_ids(13, 6, n, 16, 256, "cpu"),
                       eng._sample_ids(6, bound.shard_n))


def test_the_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import gpubench.reference.linear; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('distributed_sgd_tpu_torch', 'distributed_sgd_tpu', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
