"""Linear model family on sparse batches: hinge SVM, logistic, least squares.

The port of distributed_sgd_tpu/models/linear.py on flat ``f32[D]``
weights.  ``SparseSVM`` reproduces the reference model exactly, sign
quirks included:

- ``predict(m) = signum(m) * (-1)``
- ``loss(pred, y) = max(0, 1 - y * pred)``
- objective ``lambda * ||w||^2 + mean sample loss``
- subgradient coefficient ``0 if y*(x.w) < 0 else y``
- ``regularize(g, w) = g + 1[g != 0] * (lambda*2*(w . dimSparsity))``

The ``1[g != 0]`` mask is applied to each worker's gradient sum before the
sum over workers, as the JAX engine does.

Each model names its coefficient rule (`coeff_kind`, ops/worker_grads.py)
and its regularizer (`reg_kind`, ops/sync_epoch.py) for the CUDA kernels,
since a Python function cannot be traced into CUDA; ``grad_coeff`` and
``regularize`` evaluate those same rules in torch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.ops.sync_epoch import regularize
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch, matvec, scatter_add
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device


class LinearModel:
    """Shared machinery: margins, batched gradients, regularization.

    Subclasses define `predict(margins)`, `sample_loss(preds, y)` and
    `coeff_kind`.  `regularizer` is one of 'dim_sparsity' (reference
    parity), 'l2' (standard 2*lam*w), 'none'.
    """

    coeff_kind: int

    def __init__(
        self,
        lam: float,
        n_features: int,
        dim_sparsity=None,
        regularizer: str = "dim_sparsity",
        device: DeviceLike = None,
    ):
        if regularizer not in ("dim_sparsity", "l2", "none"):
            raise ValueError(
                f"regularizer must be 'dim_sparsity', 'l2' or 'none', got {regularizer!r}")
        self.device = resolve_device(device)
        self.lam = float(lam)
        self.n_features = int(n_features)
        self.regularizer = regularizer
        self.dim_sparsity: Optional[torch.Tensor] = None
        if regularizer == "dim_sparsity":
            if dim_sparsity is None:
                raise ValueError("dim_sparsity regularizer needs the dim_sparsity vector")
            self.dim_sparsity = torch.as_tensor(
                np.asarray(dim_sparsity, dtype=np.float32), device=self.device)

    # -- per model ---------------------------------------------------------
    def predict(self, margins: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def sample_loss(self, preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def grad_coeff(self, margins: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return wg.grad_coeff(self.coeff_kind, margins, y)

    @property
    def reg_kind(self) -> str:
        """The regularizer by name, as the sync_epoch kernel takes it."""
        return self.regularizer

    # -- shared ------------------------------------------------------------
    def margins(self, w: torch.Tensor, batch: SparseBatch) -> torch.Tensor:
        return matvec(batch, w)

    def losses_from_margins(self, margins: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-sample losses given precomputed margins."""
        return self.sample_loss(self.predict(margins), y)

    def grad_sum(self, w: torch.Tensor, batch: SparseBatch, y: torch.Tensor) -> torch.Tensor:
        """Sum of per-sample backward over one batch (plain torch)."""
        coeff = self.grad_coeff(self.margins(w, batch), y)
        return scatter_add(batch, coeff, self.n_features)

    def regularize(self, grad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Add the regularizer to gradient sums `grad` — [D], or [K, D] for
        K workers, each masked by its own nonzeros."""
        return regularize(grad, w, self.reg_kind, self.lam, self.dim_sparsity)


class SparseSVM(LinearModel):
    """Reference-exact hinge model (see module docstring)."""

    coeff_kind = wg.HINGE

    def predict(self, margins: torch.Tensor) -> torch.Tensor:
        # signum(x.w) * -1; preds in {-1, 0, +1}
        return torch.sign(margins) * -1.0

    def sample_loss(self, preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.clamp(1.0 - y.float() * preds, min=0.0)


class LogisticRegression(LinearModel):
    """Binary logistic loss on +/-1 labels."""

    coeff_kind = wg.LOGISTIC

    def predict(self, margins: torch.Tensor) -> torch.Tensor:
        return torch.where(margins >= 0, 1.0, -1.0)

    def sample_loss(self, preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("use losses_from_margins()")

    def losses_from_margins(self, margins: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # log(1 + exp(-y m)), stable
        return torch.nn.functional.softplus(-y.float() * margins)


class LeastSquares(LinearModel):
    """Squared-error regression."""

    coeff_kind = wg.LEAST_SQUARES

    def predict(self, margins: torch.Tensor) -> torch.Tensor:
        return margins

    def sample_loss(self, preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (preds - y.float()) ** 2


MODELS = {
    "hinge": SparseSVM,
    "svm": SparseSVM,
    "logistic": LogisticRegression,
    "least_squares": LeastSquares,
}


def make_model(
    name: str,
    lam: float,
    n_features: int,
    dim_sparsity=None,
    regularizer: Optional[str] = None,
    device: DeviceLike = None,
) -> LinearModel:
    if name not in MODELS:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(MODELS)}")
    if regularizer is None:
        regularizer = "dim_sparsity" if dim_sparsity is not None else "l2"
    return MODELS[name](lam, n_features, dim_sparsity=dim_sparsity,
                        regularizer=regularizer, device=device)
