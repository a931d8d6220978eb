"""The port's examples (examples_torch/) must stay runnable: each main() at
the sizes of tests/test_examples.py on the CPU, with its assertions.

The single-card and custom-model examples are also held to the JAX
example's result at the same arguments.  The port draws its own sample
ids (torch's generator, not jax.random), so the two land apart by the
spread of the draws: over draw seeds 0-7 of each package at these sizes
(64 pairs), the final test losses of the two lay at most 0.2125 apart for
the single-card example and 0.1033 for the custom model (seed 0: 0.1125
and 0.0433).  The bands below are those, rounded up.  Each test runs
under a time limit of its own (`LIMIT_S`)."""

import signal

import numpy as np
import pytest

SINGLE_CHIP_BAND = 0.22  # |port - JAX| final test loss, main(n=800, max_epochs=2)
CUSTOM_MODEL_BAND = 0.11  # ... main(n=600)
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


def test_single_chip_example():
    from examples.train_single_chip import main as jax_main
    from examples_torch.train_single_chip import main

    loss = main(n=800, max_epochs=2, device="cpu")
    assert np.isfinite(loss)
    assert abs(loss - jax_main(n=800, max_epochs=2)) <= SINGLE_CHIP_BAND


def test_custom_model_example():
    from examples.custom_model import main as jax_main
    from examples_torch.custom_model import main

    loss = main(n=600, device="cpu")
    assert np.isfinite(loss)
    assert abs(loss - jax_main(n=600)) <= CUSTOM_MODEL_BAND


def test_async_hogwild_example():
    from examples_torch.train_async_hogwild import main

    loss = main(n=600, device="cpu")
    assert np.isfinite(loss)


def test_dense_example():
    from examples_torch.train_dense import main

    mse = main(n=800, d=32, epochs=2, device="cpu")
    assert np.isfinite(mse) and mse < 1.0


def test_feature_sharded_example():
    # starts its 2 x 4 gloo ranks as processes of its own file
    from examples_torch.train_feature_sharded import main

    loss = main(n=800, max_epochs=2, device="cpu")
    assert np.isfinite(loss)


def test_serve_predict_example():
    from examples_torch.serve_predict import main

    # returns the max micro-batch size; > 1 proves concurrent requests
    # were observably coalesced (the example itself asserts served
    # answers match model.predict on the checkpointed weights)
    max_batch = main(n=800, max_epochs=1, n_requests=24, device="cpu")
    assert max_batch > 1
