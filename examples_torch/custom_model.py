"""Defining a custom linear model for the port: subclass LinearModel with a
margin-based coefficient rule, given twice -- ``grad_coeff`` in torch (the
plain version, the CPU route and the card's reference) and ``coeff_cuda``,
the body of the CUDA device function ``float coeff(float m, float y)`` --
and it trains on every engine: the first launch on the card compiles a
variant of each CUDA kernel with that body (ops/_build.py), kept under
the name of the source's content key.

This example adds a squared-hinge SVM (smooth variant, not in the
reference) and trains it with the sync engine, as
examples/custom_model.py does in the JAX package.

    python examples_torch/custom_model.py [n_samples] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from distributed_sgd_tpu_torch.data.rcv1 import train_test_split  # noqa: E402
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like  # noqa: E402
from distributed_sgd_tpu_torch.models.linear import LinearModel  # noqa: E402
from distributed_sgd_tpu_torch.parallel.sync import SyncEngine, fold_in  # noqa: E402


class SquaredHinge(LinearModel):
    """L(m, y) = max(0, 1 - y*m)^2 ; dL/dm = -2*y*max(0, 1 - y*m)."""

    # the same rule for the CUDA kernels (m the margin, y the label), NaN
    # kept as torch.clamp keeps it
    coeff_cuda = "const float t = 1.f - y * m;\nreturn -2.f * y * (t < 0.f ? 0.f : t);"

    def predict(self, margins):
        return torch.where(margins >= 0, 1.0, -1.0)

    def losses_from_margins(self, margins, y):
        yf = y.float()
        return torch.clamp(1.0 - yf * margins, min=0.0) ** 2

    def sample_loss(self, preds, y):  # margin-based; unused
        raise NotImplementedError

    def grad_coeff(self, margins, y):
        yf = y.float()
        return -2.0 * yf * torch.clamp(1.0 - yf * margins, min=0.0)


def main(n: int = 10_000, device=None) -> float:
    data = rcv1_like(n, n_features=2048, nnz=16, seed=1)
    train, test = train_test_split(data)
    model = SquaredHinge(lam=1e-4, n_features=data.n_features, regularizer="l2", device=device)
    eng = SyncEngine(model, batch_size=64, learning_rate=0.1, device=device)
    bound, bound_test = eng.bind(train), eng.bind(test)
    w = torch.zeros(data.n_features, dtype=torch.float32, device=eng.device)
    for e in range(5):
        w = bound.epoch(w, fold_in(0, e))
    loss, acc = bound_test.evaluate(w)
    print(f"squared-hinge: test_loss={loss:.4f} test_acc={acc:.4f}")
    return loss


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=10_000)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args()
    main(args.n, device=args.device)
