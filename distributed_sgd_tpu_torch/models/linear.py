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

The CUDA kernels take a model's coefficient rule as `coeff` (ops/coeff.py,
the JAX kernel's ``coeff_fn``) and its regularizer as `reg_kind`
(ops/sync_epoch.py).  The built-in models name a compiled rule by
``coeff_kind``; ``grad_coeff`` is that rule in torch.  A model may instead
define its own rule, twice, as the JAX package's models define it once:

- ``grad_coeff(margins, y)`` in torch: the plain version (the CPU route and
  the card's reference);
- ``coeff_cuda``, a class attribute: the body of the CUDA device function
  ``float coeff(float m, float y)``, compiled into a variant of each kernel.

Such a model trains on the CPU from its ``grad_coeff`` alone; on the card
without ``coeff_cuda`` it raises (ops/coeff.py check_launchable).

Dense-layout rows (``Dataset.dense``: values ``[B, D]``, a zero-width
index array) take the dense path: ``margins_dense`` (``x @ w``) and
``grad_dense`` (``coeff @ x``), plain f32 ``torch.matmul``, where the JAX
package runs ``jnp.dot`` at ``Precision.HIGHEST`` outside any Pallas
kernel.  On the card f32 products stay f32 only while PyTorch's matmul
precision is "highest" and TF32 is off, which are its defaults; the port
never changes them.  ``margins``, ``forward``, ``grad_sum`` and
``grad_regularized`` route a dense batch there by its layout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from distributed_sgd_tpu_torch.ops import coeff as co
from distributed_sgd_tpu_torch.ops import worker_grads as wg
from distributed_sgd_tpu_torch.ops.sync_epoch import regularize
from distributed_sgd_tpu_torch.ops.sparse import SparseBatch, matvec, scatter_add
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device


class LinearModel:
    """Shared machinery: margins, batched gradients, regularization.

    Subclasses define `predict(margins)`, `sample_loss(preds, y)` and
    either `coeff_kind` (a built-in rule) or their own `grad_coeff` with
    `coeff_cuda` (see the module docstring).  `regularizer` is one of
    'dim_sparsity' (reference parity), 'l2' (standard 2*lam*w), 'none'.
    """

    coeff_kind: int
    coeff_cuda: Optional[str] = None

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
        return co.builtin_rule(self.coeff_kind, margins, y)

    @property
    def coeff(self) -> co.Coeff:
        """The rule as the kernels take it: the class's built-in kind, or,
        where a class overrides `grad_coeff`, a user rule of that function
        and `coeff_cuda`.  Resolved once a model: every kernel call of a
        route reads it."""
        rule = self.__dict__.get("_coeff")
        if rule is None:
            rule = self.__dict__["_coeff"] = self._resolve_coeff()
        return rule

    def _resolve_coeff(self) -> co.Coeff:
        name = type(self).__name__
        if type(self).grad_coeff is not LinearModel.grad_coeff:
            return co.user(self.grad_coeff, self.coeff_cuda, name)
        if self.coeff_cuda is not None:
            raise ValueError(f"{name} has a coeff_cuda but no grad_coeff of its own: the "
                             f"plain version would not be the same rule")
        kind = getattr(self, "coeff_kind", None)
        if kind is None:
            raise ValueError(f"{name} defines neither coeff_kind nor grad_coeff")
        return co.resolve(kind)

    @property
    def reg_kind(self) -> str:
        """The regularizer by name, as the sync_epoch kernel takes it."""
        return self.regularizer

    # -- shared ------------------------------------------------------------
    def margins(self, w: torch.Tensor, batch: SparseBatch) -> torch.Tensor:
        if batch.is_dense:
            return self.margins_dense(w, batch.values)
        return matvec(batch, w)

    def forward(self, w: torch.Tensor, batch: SparseBatch) -> torch.Tensor:
        """Predictions of the rows of `batch` (the worker's Forward body)."""
        return self.predict(self.margins(w, batch))

    def sample_losses(self, w: torch.Tensor, batch: SparseBatch, y: torch.Tensor) -> torch.Tensor:
        """Per-sample losses (no regularization term)."""
        return self.losses_from_margins(self.margins(w, batch), y)

    def losses_from_margins(self, margins: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """Per-sample losses given precomputed margins."""
        return self.sample_loss(self.predict(margins), y)

    def objective(self, w: torch.Tensor, batch: SparseBatch, y: torch.Tensor) -> torch.Tensor:
        """lambda*||w||^2 + mean sample loss."""
        reg = self.lam * torch.sum(w.float() ** 2)
        return reg + torch.mean(self.sample_loss(self.forward(w, batch), y))

    def accuracy(self, w: torch.Tensor, batch: SparseBatch, y: torch.Tensor) -> torch.Tensor:
        """fraction(forward == y)."""
        return torch.mean((self.forward(w, batch) == y.float()).float())

    def grad_sum(self, w: torch.Tensor, batch: SparseBatch, y: torch.Tensor) -> torch.Tensor:
        """Sum of per-sample backward over one batch (plain torch)."""
        if batch.is_dense:
            return self.grad_dense(w, batch.values, y, reduce="sum")
        coeff = self.grad_coeff(self.margins(w, batch), y)
        return scatter_add(batch, coeff, self.n_features)

    def grad_mean(self, w: torch.Tensor, batch: SparseBatch, y: torch.Tensor) -> torch.Tensor:
        """Mean of per-sample backward over one batch: the async engines'
        gradient (plain torch; on the card the sync_epoch kernel's mean
        mode computes it)."""
        return self.grad_sum(w, batch, y) / batch.batch_size

    # -- the dense layout ----------------------------------------------------
    def margins_dense(self, w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """Per-sample dots of dense rows: ``x[..., B, D] @ w[D]`` in f32."""
        return torch.matmul(x.float(), w.float())

    def grad_dense(self, w: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                   reduce: str = "sum") -> torch.Tensor:
        """The backward of dense rows: ``coeff[..., B] @ x[..., B, D]``, the
        sum over the batch, or with reduce='mean' each coefficient first
        divided by B (the JAX package's order).  Leading dimensions batch
        workers: x[K, B, D] gives [K, D]."""
        if reduce not in ("sum", "mean"):
            raise ValueError(f"reduce must be 'sum' or 'mean', got {reduce!r}")
        coeff = self.grad_coeff(self.margins_dense(w, x), y)
        if reduce == "mean":
            coeff = coeff / x.shape[-2]
        return torch.matmul(coeff.float().unsqueeze(-2), x.float()).squeeze(-2)

    def grad_regularized(self, w: torch.Tensor, batch: SparseBatch,
                         y: torch.Tensor) -> torch.Tensor:
        """The RPC worker's Gradient body (Slave.scala:142-157): the sum of
        per-sample backwards over `batch`, then `regularize`.  The sum is
        ``ops.worker_grads`` at K=1: the CUDA kernel on a CUDA tensor, its
        plain version on a CPU tensor; a dense batch takes `grad_dense`."""
        if batch.is_dense:
            return self.regularize(self.grad_dense(w, batch.values, y), w)
        g = wg.worker_grads(w, batch.indices[None].contiguous(),
                            batch.values[None].float().contiguous(),
                            y.float()[None].contiguous(), self.coeff)[0]
        return self.regularize(g, w)

    def regularize(self, grad: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """Add the regularizer to gradient sums `grad` — [D], or [K, D] for
        K workers, each masked by its own nonzeros."""
        return regularize(grad, w, self.reg_kind, self.lam, self.dim_sparsity)


class SparseSVM(LinearModel):
    """Reference-exact hinge model (see module docstring)."""

    coeff_kind = co.HINGE

    def predict(self, margins: torch.Tensor) -> torch.Tensor:
        # signum(x.w) * -1; preds in {-1, 0, +1}
        return torch.sign(margins) * -1.0

    def sample_loss(self, preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return torch.clamp(1.0 - y.float() * preds, min=0.0)


class LogisticRegression(LinearModel):
    """Binary logistic loss on +/-1 labels."""

    coeff_kind = co.LOGISTIC

    def predict(self, margins: torch.Tensor) -> torch.Tensor:
        return torch.where(margins >= 0, 1.0, -1.0)

    def sample_loss(self, preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError("use losses_from_margins()")

    def losses_from_margins(self, margins: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        # log(1 + exp(-y m)), stable
        return torch.nn.functional.softplus(-y.float() * margins)

    def objective(self, w: torch.Tensor, batch: SparseBatch, y: torch.Tensor) -> torch.Tensor:
        reg = self.lam * torch.sum(w.float() ** 2)
        return reg + torch.mean(self.sample_losses(w, batch, y))


class LeastSquares(LinearModel):
    """Squared-error regression."""

    coeff_kind = co.LEAST_SQUARES

    def predict(self, margins: torch.Tensor) -> torch.Tensor:
        return margins

    def sample_loss(self, preds: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return (preds - y.float()) ** 2

    def accuracy(self, w: torch.Tensor, batch: SparseBatch, y: torch.Tensor) -> torch.Tensor:
        # accuracy means nothing for regression: the negative MSE
        return -torch.mean((self.forward(w, batch) - y.float()) ** 2)


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
