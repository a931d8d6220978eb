"""The port's async loss checker (distributed_sgd_tpu_torch/core/
loss_check.py) against the JAX package's, fed the same raw loss and
accuracy sequences: equal smoothed series, best loss and weights, stop
decisions, and the same FitResult from async_fit_result.  Pure host
arithmetic on both sides, so the comparison is exact."""

import math

import numpy as np
import pytest
import torch

from distributed_sgd_tpu.core import early_stopping as jes
from distributed_sgd_tpu.core.loss_check import LossChecker as JaxChecker
from distributed_sgd_tpu.core.loss_check import async_fit_result as jax_fit_result
from distributed_sgd_tpu_torch.core import early_stopping as tes
from distributed_sgd_tpu_torch.core.loss_check import LossChecker, async_fit_result

D = 16


def _sequence(kind: str):
    """(raw losses, raw accuracies, weights at each check)."""
    rng = np.random.default_rng(len(kind))
    if kind == "falling":
        losses = list(1.0 / np.arange(1, 13))
    elif kind == "plateau":
        losses = [1.0, 0.6, 0.5, 0.495, 0.497, 0.494, 0.496, 0.495, 0.493, 0.5]
    elif kind == "noisy":
        losses = list(0.5 + 0.2 * rng.random(15))
    else:  # with a nan and a rise
        losses = [1.0, 0.7, float("nan"), 0.65, 0.9, 0.6, 0.61]
    accs = list(rng.random(len(losses)))
    weights = [rng.normal(size=D).astype(np.float32) for _ in losses]
    return losses, accs, weights


CRITERIA = {
    "none": lambda m: None,
    "no_improvement": lambda m: m.no_improvement(patience=3, min_delta=0.01),
    "target": lambda m: m.target(0.55),
}


@pytest.mark.parametrize("criterion", sorted(CRITERIA))
@pytest.mark.parametrize("leaky", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("kind", ["falling", "plateau", "noisy", "nan"])
def test_checker_and_fit_result_match_jax(kind, leaky, criterion):
    losses, accs, weights = _sequence(kind)
    jc = JaxChecker(leaky, CRITERIA[criterion](jes))
    tc = LossChecker(leaky, CRITERIA[criterion](tes))
    for i, (loss, acc, w) in enumerate(zip(losses, accs, weights)):
        stop_j = jc.check(loss, acc, w, step=100 * i)
        stop_t = tc.check(loss, acc, torch.from_numpy(w))
        assert stop_t == stop_j, i
        np.testing.assert_array_equal(tc.smoothed, jc.smoothed)
        np.testing.assert_array_equal(tc.smoothed_accs, jc.smoothed_accs)
        assert tc.best_loss == jc.best_loss
        np.testing.assert_array_equal(tc.best_weights.numpy(), jc.best_weights)
        if stop_j:
            break
    np.testing.assert_array_equal(tc.history, jc.history)  # nan equals nan here
    np.testing.assert_array_equal(tc.acc_history, jc.acc_history)

    w0 = np.zeros(D, np.float32)
    updates, n = 100 * (i + 1) + 7, 333
    jr = jax_fit_result(jc, w0, 12.5, updates, 32, n)
    tr = async_fit_result(tc, torch.from_numpy(w0), 12.5, updates, 32, n)
    assert (tr.epochs_run, tr.state.updates, tr.state.start) == (
        jr.epochs_run, jr.state.updates, jr.state.start)
    assert tr.state.loss == jr.state.loss and tr.state.end is not None
    np.testing.assert_array_equal(tr.test_losses, jr.test_losses)
    np.testing.assert_array_equal(tr.test_accuracies, jr.test_accuracies)
    np.testing.assert_array_equal(tr.weights.numpy(), np.asarray(jr.weights))


def test_a_fit_without_a_check_returns_the_initial_weights_and_a_nan_loss():
    w0 = np.arange(D, dtype=np.float32)
    jr = jax_fit_result(JaxChecker(0.9), w0, 0.0, 0, 100, 10)
    tr = async_fit_result(LossChecker(0.9), torch.from_numpy(w0), 0.0, 0, 100, 10)
    assert math.isnan(tr.state.loss) and math.isnan(jr.state.loss)
    assert tr.epochs_run == jr.epochs_run == 0 and tr.test_losses == jr.test_losses == []
    np.testing.assert_array_equal(tr.weights.numpy(), np.asarray(jr.weights))


def test_the_best_weights_are_a_copy():
    tc = LossChecker(1.0)
    w = torch.ones(D)
    tc.check(0.5, 0.5, w)
    w += 1.0
    assert torch.equal(tc.best_weights, torch.ones(D))


def test_checker_refuses_a_bad_leak_and_a_checkpointer(tmp_path):
    with pytest.raises(ValueError, match="leaking"):
        LossChecker(1.5)
    # a checkpointer on the JAX package's orbax format (a step directory
    # with its metadata file) is refused before a checker could start
    # from nothing beside it
    from distributed_sgd_tpu_torch.checkpoint import Checkpointer

    (tmp_path / "7").mkdir()
    (tmp_path / "7" / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        LossChecker(0.9, checkpointer=Checkpointer(str(tmp_path)), device="cpu")
