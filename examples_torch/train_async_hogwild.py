"""Asynchronous Hogwild training: 4 gossiping workers, leaky-smoothed loss
checking, best-weights return — the reference's async mode
(Slave.scala:79-111 / MasterAsync.scala), a thread and a stream a worker.

    python examples_torch/train_async_hogwild.py [n_samples] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributed_sgd_tpu_torch.core.early_stopping import no_improvement  # noqa: E402
from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity, train_test_split  # noqa: E402
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like  # noqa: E402
from distributed_sgd_tpu_torch.models.linear import make_model  # noqa: E402
from distributed_sgd_tpu_torch.parallel.hogwild import HogwildEngine  # noqa: E402


def main(n: int = 3_000, device=None) -> float:
    data = rcv1_like(n, seed=0, idf_values=True)  # ltc weighting: smooth at lr=0.5
    train, test = train_test_split(data)
    model = make_model("hinge", 1e-5, data.n_features, dim_sparsity=dim_sparsity(train),
                       device=device)
    eng = HogwildEngine(
        model, n_workers=4, batch_size=100, learning_rate=0.5, check_every=100, device=device
    )
    res = eng.fit(train, test, max_epochs=1,
                  criterion=no_improvement(patience=5, min_delta=0.001))
    print(f"updates={res.state.updates} best_test_loss={res.state.loss:.4f}")
    return res.state.loss


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=3_000)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args()
    main(args.n, device=args.device)
