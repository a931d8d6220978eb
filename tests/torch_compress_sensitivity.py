"""How far a top-k 1% + EF RPC sync fit moves when every reply carries a
relative noise of 1e-7 (about the card's distance from the CPU), and its
reply bytes against the knobs-off fit's, on the CPU.

    python tests/torch_compress_sensitivity.py

100,000 synthetic RCV1 rows (seed 0, ltc values), 47,236 features, hinge
with the dim-sparsity regularizer, a DevCluster of 3 workers, B=100, lr
0.5, 1 epoch: knobs off, top-k, and top-k with every Gradient body
multiplied by (1 + 1e-7 N(0, 1)).  Prints each fit's test loss, accuracy
and `master.sync.grad.bytes`, then the largest weight gaps.  A minute or
so; not a test (the file name keeps pytest from collecting it).
"""

import time

import numpy as np
import torch

from distributed_sgd_tpu_torch.core.cluster import DevCluster
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity, train_test_split
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.utils.metrics import Metrics

NOISE = 1e-7


def main() -> None:
    torch.set_num_threads(2)
    train, test = train_test_split(rcv1_like(100000, seed=0, idf_values=True))
    model = make_model("hinge", 1e-5, train.n_features, dim_sparsity=dim_sparsity(train),
                       device="cpu")
    real = WorkerNode.compute_gradient
    weights = {}
    for label, noise, codec in (("knobs off", 0.0, "none"), ("topk", 0.0, "topk"),
                                ("topk, noisy replies", NOISE, "topk")):
        rng = np.random.default_rng(1)

        def compute(self, w, ids, noise=noise, rng=rng):
            g = real(self, w, ids)
            if noise:
                g = (g * (1 + noise * rng.standard_normal(g.shape))).astype(np.float32)
            return g

        WorkerNode.compute_gradient = compute
        m = Metrics()
        t0 = time.perf_counter()
        try:
            with DevCluster(model, train, test, n_workers=3, seed=0, metrics=m,
                            compress=codec, compress_k=0.01) as c:
                fit = c.master.fit_sync(1, 100, 0.5)
        finally:
            WorkerNode.compute_gradient = real
        weights[label] = np.asarray(fit.weights)
        print(f"{label}: {time.perf_counter() - t0:.1f} s, test loss {fit.test_losses[0]:.7f}, "
              f"accuracy {fit.test_accuracies[0]:.5f}, master.sync.grad.bytes "
              f"{m.counter('master.sync.grad.bytes').value}", flush=True)
    gap = np.abs(weights["topk"] - weights["topk, noisy replies"]).max()
    print(f"topk against topk with noisy replies: max |dw| {gap:.3e}")
    print(f"topk against knobs off: max |dw| "
          f"{np.abs(weights['topk'] - weights['knobs off']).max():.3e}")


if __name__ == "__main__":
    main()
