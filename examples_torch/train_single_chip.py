"""Minimal single-card training run: synthetic RCV1-shaped data, hinge SVM,
sync epochs (one sync_epoch launch each on the card), early stopping.

    python examples_torch/train_single_chip.py [n_samples] [--device cpu]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from distributed_sgd_tpu_torch.core.early_stopping import no_improvement  # noqa: E402
from distributed_sgd_tpu_torch.core.trainer import SyncTrainer  # noqa: E402
from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity, train_test_split  # noqa: E402
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like  # noqa: E402
from distributed_sgd_tpu_torch.models.linear import make_model  # noqa: E402


def main(n: int = 20_000, max_epochs: int = 5, device=None) -> float:
    data = rcv1_like(n, seed=0, idf_values=True)  # ltc weighting: smooth at lr=0.5
    train, test = train_test_split(data)
    model = make_model("hinge", 1e-5, data.n_features, dim_sparsity=dim_sparsity(train),
                       device=device)
    trainer = SyncTrainer(
        model,
        batch_size=100,
        learning_rate=0.5,
        virtual_workers=3,  # the reference's default nodeCount, on one card
        device=device,
    )
    res = trainer.fit(
        train, test, max_epochs, criterion=no_improvement(patience=3, min_delta=0.01)
    )
    print(f"epochs={res.epochs_run} test_loss={res.test_losses[-1]:.4f} "
          f"test_acc={res.test_accuracies[-1]:.4f}")
    return res.test_losses[-1]


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=20_000)
    ap.add_argument("--device", default=None, help="cpu, or the card (the default)")
    args = ap.parse_args()
    main(args.n, device=args.device)
