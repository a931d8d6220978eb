"""PyTorch + CUDA port of distributed_sgd_tpu for one NVIDIA H100.

The JAX package (distributed_sgd_tpu/) is the reference and is not
imported here.  This package runs the sync SVM-family trainer end to end:
host-side data (data/), the linear models on flat weights (models/), the
sparse ops and the hand-written worker-gradient kernel (ops/,
csrc/worker_grads.cu), the sync engine (parallel/sync.py), the epoch
driver (core/trainer.py) and the CLI (main.py).

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain torch
version.
"""

__version__ = "0.1.0"
