"""Dense-layout training: least-squares regression on fully-dense rows.

`Dataset.dense` stores values[N, D] only — no index array — and every
engine routes it through f32 `torch.matmul` steps (models/linear.py dense
path): no CUDA kernel of the port reads dense rows, as no Pallas kernel of
the JAX package does.

    python examples_torch/train_dense.py [n_samples] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from distributed_sgd_tpu_torch.data.rcv1 import Dataset, train_test_split  # noqa: E402
from distributed_sgd_tpu_torch.models.linear import make_model  # noqa: E402
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, fold_in  # noqa: E402


def main(n: int = 20_000, d: int = 256, epochs: int = 3, device=None) -> float:
    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, d)).astype(np.float32) / np.sqrt(d)  # unit-ish rows
    w_true = rng.normal(size=d).astype(np.float32)
    y = (x @ w_true + 0.01 * rng.normal(size=n)).astype(np.float32)
    data = Dataset.dense(x, y)
    assert data.is_dense

    train, test = train_test_split(data)
    model = make_model("least_squares", 0.0, d, regularizer="none", device=device)
    eng = SyncEngine(model, batch_size=256, learning_rate=0.05, device=device)
    bound, bound_test = eng.bind(train), eng.bind(test)
    assert bound.kernel == "dense"  # auto-selected from the layout

    w = torch.zeros(d, dtype=torch.float32, device=eng.device)
    for e in range(epochs):
        w = bound.epoch(w, fold_in(0, e))
        mse, _ = bound_test.evaluate(w)
        print(f"epoch {e}: test_mse={mse:.6f}")
    return mse


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=20_000)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args()
    main(args.n, device=args.device)
