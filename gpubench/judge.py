"""The numbers that decide `correct` for a training cell.

The program's set-up drives its training object through its first three
steps (an epoch of the sync trainer, a round of local SGD), through the
window's own call and on its own rows.  The plain reference
(reference/linear.py) follows the same three steps from the same seed.
The numbers compared, each against a limit of the cell's own:

- ``eval_loss_gap``: the largest relative distance between an objective
  the program reported for its weights and the range the reference gives
  for the same weights, where rows whose margins lie within rounding of
  zero may take either sign (the evaluation layer);
- ``eval_acc_gap``: the same for accuracy, as an absolute distance;
- ``step_loss_gap``: over the three steps, the largest relative distance
  between the reference's ranges of the test objective of the program's
  weights and of its own (the training step);
- ``grad1_gap``: the gap between the norms of the first step's gradient as
  the optimizer holds it after that step, over the reference's norm;
- ``change3_gap``: the gap between the norms of the weights' change after
  the three steps, over the reference's norm;
- ``grad1_cos_gap``, ``change3_cos_gap``: one less the cosine between the
  program's and the reference's first gradient, and their changes after
  three steps: the direction, which a norm does not see (features
  mapped to the wrong place keep every norm).  A side that did not move
  reads 1.

The model has one parameter leaf, w, so the worst leaf is w.  A cell
compares the numbers its workload file gives limits for; a number left
out there is printed and not compared.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

from gpubench.reference.linear import Evaluation

NUMBERS = ("eval_loss_gap", "eval_acc_gap", "step_loss_gap", "loss1_gap", "grad1_gap",
           "change3_gap", "grad1_cos_gap", "change3_cos_gap")


@dataclass
class FirstSteps:
    """What one side produced over the first steps: the weights after each
    step, the first step's gradient as its optimizer holds it, and the
    evaluations it reported as (weights, split, objective, accuracy)."""

    weights: List[torch.Tensor]
    grad1: torch.Tensor
    reported: List[Tuple[torch.Tensor, str, float, float]] = field(default_factory=list)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def _cos_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """One less the cosine between a and b; 1 where either is zero."""
    a, b = a.double(), b.double()
    na, nb = float(torch.linalg.vector_norm(a)), float(torch.linalg.vector_norm(b))
    if na == 0.0 or nb == 0.0:
        return 1.0
    return 1.0 - float(torch.dot(a, b)) / (na * nb)


def _outside(x: float, lo: float, hi: float) -> float:
    return max(lo - x, x - hi, 0.0)


def numbers(side: FirstSteps, ref: FirstSteps,
            evaluate: Callable[[torch.Tensor, str], Evaluation]) -> Dict[str, float]:
    """The numbers of `side` (the program, or a control put in its
    place) against the reference; `evaluate(w, split)` is the reference's
    `Evaluation`."""
    if len(side.weights) != len(ref.weights):
        raise ValueError(f"{len(side.weights)} steps against the reference's {len(ref.weights)}")
    out = {"eval_loss_gap": 0.0, "eval_acc_gap": 0.0}
    for w, split, loss, acc in side.reported:
        e = evaluate(w, split)
        out["eval_loss_gap"] = max(out["eval_loss_gap"],
                                   _outside(loss, e.objective_lo, e.objective_hi) / e.objective)
        out["eval_acc_gap"] = max(out["eval_acc_gap"], _outside(acc, e.accuracy_lo, e.accuracy_hi))
    gaps = []
    for w, r in zip(side.weights, ref.weights):
        a, b = evaluate(w, "test"), evaluate(r, "test")
        apart = max(a.objective_lo - b.objective_hi, b.objective_lo - a.objective_hi, 0.0)
        gaps.append(apart / b.objective)
    out["step_loss_gap"], out["loss1_gap"] = max(gaps), gaps[0]
    norm = lambda t: float(torch.linalg.vector_norm(t.double()))  # noqa: E731
    out["grad1_gap"] = _rel(norm(side.grad1), norm(ref.grad1))
    out["change3_gap"] = _rel(norm(side.weights[-1]), norm(ref.weights[-1]))
    out["grad1_cos_gap"] = _cos_gap(side.grad1, ref.grad1)
    out["change3_cos_gap"] = _cos_gap(side.weights[-1], ref.weights[-1])
    # a number that is not finite (NaN weights, say) fails every limit
    return {k: (v if v == v and v != float("inf") else float("inf")) for k, v in out.items()}


def verdict(got: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, Dict]]:
    """(correct, each compared number beside its limit): correct when every
    number the cell gives a limit for is within it."""
    unknown = set(limits) - set(NUMBERS)
    if unknown or not limits:
        raise ValueError(f"limits must name some of {NUMBERS}, got {sorted(limits)}")
    checks = {k: {"value": got[k], "limit": float(limits[k])} for k in NUMBERS if k in limits}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks
