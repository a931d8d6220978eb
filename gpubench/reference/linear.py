"""The plain reference of the benchmark's training cells.

Plain torch and numpy: it imports nothing of the program and takes
nothing the program made.  From the benchmark's own inputs (the rows,
the seed) it works out again what the program derives at set-up (the
dim-sparsity vector, the padded row layout, each step's sample ids) and
runs the steps of zifeo/distributed-sgd's hinge model one by one:

- margin ``m = x . w``; coefficient ``0 if y*m < 0 else y``; prediction
  ``-signum(m)``; loss ``max(0, 1 - y*prediction)``; objective
  ``lam*||w||^2 + mean loss``; accuracy ``mean(prediction == y)``;
- the regulariser ``dim_sparsity`` (each worker's sum plus
  ``1[g != 0] * 2*lam*(w . ds)``, ``ds_i = 1/(count_i + 1)`` over the
  train rows) or ``l2`` (``g + 2*lam*w``);
- the sync step: each of K workers sums its B rows' terms, regularises,
  and the sum over workers divided by K updates w; the local (mean) step:
  one worker's sum divided by B;
- the update ``w - lr*g`` ('sgd') or optax's ``adam`` (b1 0.9, b2 0.999,
  eps 1e-8, bias-corrected by ``1 - b**t``).

In float32 (`REFERENCE`) the sums over rows are taken in float64, so the
reference is as close as float32 state allows to the exact sums.  The
control (`CONTROL`) runs the same steps with the rows, the weights, the
optimizer state and every sum in bfloat16, the precision below the
configuration's float32.

`fold_in`, `padded_rows` and the id draws are frozen copies of the
program's sampling arithmetic, kept here so that the reference draws the
same sample ids from the same seed without importing the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

REFERENCE, CONTROL = "float32", "bfloat16"
WITNESS = "float32-sums"  # a second sound reference: float32 state and float32 sums
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
EVAL_BLOCK = 65_536  # rows an evaluation block holds
# A margin within TIE * sum_i |w_i x_i| of zero has a sign that float32
# rounding may turn either way: a dot product of 76 float32 terms, in any
# order, lands within 76 * 2**-24 (4.5e-6) of that sum of the exact value.
TIE = 1e-5


def fold_in(key: int, data: int) -> int:
    """A non-negative 63-bit seed from `key` and `data` (numpy's SeedSequence)."""
    state = np.random.SeedSequence([int(key), int(data)]).generate_state(1, np.uint64)
    return int(state[0] >> np.uint64(1))


def padded_rows(n_true: int, chunk: int = 4096) -> int:
    """Rows of one worker's shard once padded to a multiple of the
    evaluation chunk: pad rows are all zero with label 0."""
    chunk = min(chunk, n_true)
    return math.ceil(n_true / chunk) * chunk


def sync_steps_per_epoch(n_true: int, k: int, b: int) -> int:
    return max(1, math.ceil(math.ceil(n_true / k) / b))


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def sync_epoch_ids(fit_seed: int, epoch: int, n_true: int, k: int, b: int,
                   device) -> torch.Tensor:
    """int64[S, K, B]: epoch `epoch`'s ids into the padded train shard,
    worker k drawing uniformly, with replacement, from its contiguous
    ceil-split sub-shard."""
    shard = padded_rows(n_true)
    sub = -(-shard // k)
    starts = np.minimum(np.arange(k) * sub, shard - 1)
    wrap = np.minimum(sub, np.maximum(shard - starts, 1))
    gen = _generator(fold_in(fold_in(fit_seed, epoch), 0), device)
    sel = torch.randint(0, sub, (sync_steps_per_epoch(n_true, k, b), k, b), generator=gen,
                        device=device)
    return (sel % torch.as_tensor(wrap, device=device)[:, None]
            + torch.as_tensor(starts, device=device)[:, None])


def local_round_ids(fit_seed: int, rnd: int, n_true: int, h: int, b: int,
                    device) -> torch.Tensor:
    """int64[h, 1, B]: round `rnd`'s ids into the padded train shard."""
    gen = _generator(fold_in(fit_seed, rnd), device)
    return torch.randint(0, padded_rows(n_true), (h, 1, b), generator=gen, device=device)


@dataclass
class Split:
    indices: torch.Tensor  # int32[N, P]
    values: torch.Tensor  # [N, P]
    labels: torch.Tensor  # [N], +/-1

    def __len__(self) -> int:
        return self.labels.shape[0]


@dataclass
class Problem:
    """The rows and the model, in the precision `precision`."""

    train: Split
    test: Split
    n_features: int
    lam: float
    regularizer: str  # 'dim_sparsity' or 'l2'
    precision: str = REFERENCE
    dim_sparsity: Optional[torch.Tensor] = None

    @property
    def dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.precision == CONTROL else torch.float32

    @property
    def sum_dtype(self) -> torch.dtype:
        return {CONTROL: torch.bfloat16, WITNESS: torch.float32}.get(self.precision,
                                                                     torch.float64)


def make_problem(train: Split, test: Split, n_features: int, lam: float, regularizer: str,
                 precision: str = REFERENCE) -> Problem:
    """The problem over the benchmark's rows; the rows' values are cast to
    the precision's type, and ``dim_sparsity`` is counted from the train
    rows' nonzero entries."""
    if regularizer not in ("dim_sparsity", "l2"):
        raise ValueError(f"regularizer must be 'dim_sparsity' or 'l2', got {regularizer!r}")
    dtype = torch.bfloat16 if precision == CONTROL else torch.float32

    def cast(s: Split) -> Split:
        return Split(s.indices, s.values.to(dtype), s.labels)

    p = Problem(cast(train), cast(test), n_features, lam, regularizer, precision)
    if regularizer == "dim_sparsity":
        nz = train.values != 0
        counts = torch.bincount(train.indices[nz].long(), minlength=n_features)
        ds = torch.where(counts > 0, 1.0 / (counts.double() + 1.0), torch.zeros((), dtype=torch.float64,
                                                                              device=counts.device))
        p.dim_sparsity = ds.to(dtype)
    return p


def _rows(split: Split, ids: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(indices, values, labels) of padded-shard ids: a pad row (an id past
    the split) is all zeros with label 0."""
    n = len(split)
    real = ids < n
    safe = torch.where(real, ids, torch.zeros_like(ids))
    idx = split.indices[safe]
    val = split.values[safe] * real[..., None].to(split.values.dtype)
    y = split.labels[safe].to(split.values.dtype) * real.to(split.values.dtype)
    return idx, val, y


def _worker_sums(p: Problem, w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """[K, D]: each worker's sum of its rows' terms for ids[K, B], in the
    precision's sum type."""
    idx, val, y = _rows(p.train, ids)
    s = p.sum_dtype
    m = (w.to(s)[idx.long()] * val.to(s)).sum(dim=-1)  # [K, B]
    coeff = torch.where(y.to(s) * m < 0, torch.zeros_like(m), y.to(s))
    k = ids.shape[0]
    flat = (idx.long() + torch.arange(k, device=idx.device)[:, None, None] * p.n_features)
    g = torch.zeros(k * p.n_features, dtype=s, device=w.device)
    g.index_add_(0, flat.reshape(-1), (coeff[..., None] * val.to(s)).reshape(-1))
    return g.view(k, p.n_features)


def _regularize(p: Problem, g: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if p.regularizer == "dim_sparsity":
        scalar = p.lam * 2.0 * torch.dot(w.to(g.dtype), p.dim_sparsity.to(g.dtype))
        return g + torch.where(g != 0, scalar, torch.zeros_like(g))
    return g + 2.0 * p.lam * w.to(g.dtype)


@dataclass
class State:
    w: torch.Tensor
    optimizer: str = "sgd"
    mu: Optional[torch.Tensor] = None
    nu: Optional[torch.Tensor] = None
    count: int = 0

    def clone(self) -> "State":
        c = lambda t: None if t is None else t.clone()  # noqa: E731
        return State(self.w.clone(), self.optimizer, c(self.mu), c(self.nu), self.count)


def init_state(p: Problem, optimizer: str, device) -> State:
    z = lambda: torch.zeros(p.n_features, dtype=p.dtype, device=device)  # noqa: E731
    if optimizer == "sgd":
        return State(z(), optimizer)
    if optimizer == "adam":
        return State(z(), optimizer, z(), z(), 0)
    raise ValueError(f"optimizer must be 'sgd' or 'adam', got {optimizer!r}")


def _update(st: State, g: torch.Tensor, lr: float) -> State:
    """One update by the mean gradient g (in the state's type)."""
    g = g.to(st.w.dtype)
    if st.optimizer == "sgd":
        return State(st.w - lr * g, "sgd")
    t = st.count + 1
    mu = (1 - ADAM_B1) * g + ADAM_B1 * st.mu
    nu = (1 - ADAM_B2) * (g * g) + ADAM_B2 * st.nu
    bc1, bc2 = 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t
    u = (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)
    return State(st.w - lr * u, "adam", mu, nu, t)


def run_steps(p: Problem, st: State, ids: torch.Tensor, lr: float, mean: bool,
              half_batch: bool = False) -> State:
    """The state after the steps ids[S, K, B]: the sync step (the sum over
    each worker's rows, the mean over the K workers) or, with `mean`, the
    local step (K = 1, the mean over the B rows).  `half_batch` is a
    planted fault: each step reads only the first half of each worker's
    rows and takes the step's own reduction over those (the sync step's
    sum, the local step's mean over B/2)."""
    for rows in ids:
        if half_batch:
            rows = rows[:, : rows.shape[1] // 2]
        gk = _worker_sums(p, st.w, rows)
        if mean:
            gk = gk / rows.shape[1]
        gk = _regularize(p, gk, st.w)
        st = _update(st, gk.sum(dim=0) / rows.shape[0], lr)
    return st


class Evaluation(NamedTuple):
    """An evaluation of w over a split: the objective and the accuracy, and
    the least and most each can be where the rows whose margins lie within
    rounding of zero (`TIE`) take either sign."""

    objective: float
    accuracy: float
    objective_lo: float
    objective_hi: float
    accuracy_lo: float
    accuracy_hi: float


def evaluate(p: Problem, w: torch.Tensor, split: str) -> Evaluation:
    """The `Evaluation` of `w` over the train or test split, in blocks of
    rows; the margins in the precision's sum type."""
    s = getattr(p, split)
    t = p.sum_dtype
    wt = w.to(t)
    loss = hits = ties = tie_loss = tie_hits = 0.0
    for a in range(0, len(s), EVAL_BLOCK):
        idx, val = s.indices[a:a + EVAL_BLOCK].long(), s.values[a:a + EVAL_BLOCK].to(t)
        y = s.labels[a:a + EVAL_BLOCK].to(t)
        terms = wt[idx] * val
        m = terms.sum(dim=1)
        pred = -torch.sign(m)
        row_loss = torch.clamp(1.0 - y * pred, min=0.0).double()
        row_hit = (pred == y).double()
        tie = (m.abs() <= TIE * terms.abs().sum(dim=1)).double()
        loss += float(row_loss.sum())
        hits += float(row_hit.sum())
        ties += float(tie.sum())
        tie_loss += float((row_loss * tie).sum())
        tie_hits += float((row_hit * tie).sum())
    n = len(s)
    reg = p.lam * float((w.double() ** 2).sum())
    # a tied row's loss lies in [0, 2] and its hit in [0, 1]
    return Evaluation(reg + loss / n, hits / n,
                      reg + (loss - tie_loss) / n, reg + (loss - tie_loss + 2 * ties) / n,
                      (hits - tie_hits) / n, (hits - tie_hits + ties) / n)


def first_gradient(st1: State, w0: torch.Tensor, lr: float) -> torch.Tensor:
    """The first step's gradient as the optimizer holds it after that
    step: ``(w0 - w1)/lr`` for sgd, the bias-corrected first moment for adam."""
    if st1.optimizer == "sgd":
        return (w0.double() - st1.w.double()) / lr
    return st1.mu.double() / (1.0 - ADAM_B1 ** st1.count)


def follow(p: Problem, optimizer: str, lr: float, ids_of_step, n_steps: int, mean: bool,
           device, half_batch: bool = False, keep=None) -> Dict[int, State]:
    """The states after the steps (0-based) in `keep` (all `n_steps` when
    None), step s drawing ``ids_of_step(s)``."""
    st = init_state(p, optimizer, device)
    out = {}
    for s in range(n_steps):
        st = run_steps(p, st, ids_of_step(s), lr, mean, half_batch)
        if keep is None or s in keep:
            out[s] = st.clone()
    return out
