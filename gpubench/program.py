"""What the engine drivers share: the program's inputs and model, and the
reference's side of the check.

The program takes host arrays (its ``Dataset``), so the rows made on the
card are copied to the host once, in set-up.  The model is built as the
program's CLI builds it, with the dim-sparsity vector the program derives
from the train rows.  The reference works everything out again from the
rows on the card.
"""

from __future__ import annotations

import gc
from typing import Optional

import torch

from gpubench import judge, roofline
from gpubench.reference import linear as ref

# operations a feature and step of an update that touches every feature
SWEEP_OPS = {"sgd": 2, "adam": 14}
REG_OPS = {"dim_sparsity": 2, "l2": 2}  # the w.ds dot, or g + 2*lam*w


class EngineDriver:
    """The parts of a driver that do not depend on the engine.  A driver
    sets `unit`, `mean` (the local mean step, else the sync step), and
    defines `run` (one fit: its first steps, then the window),
    `measure` (the units, samples and engine totals between two of the
    window's marks), `reported_evaluations`, `ids_of_step`, `part_work`
    and `launch_work`."""

    unit = "step"
    mean = False

    def __init__(self, cell, train: ref.Split, test: ref.Split, seed: int, device):
        from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity
        from distributed_sgd_tpu_torch.models.linear import make_model

        self.cell, self.seed, self.device = cell, int(seed), device
        self.train, self.test = train, test
        self.settings = cell.settings
        self.optimizer = self.settings.get("optimizer", "sgd")
        self.lr = float(self.settings["learning_rate"])
        self.n_features = int(cell.config["data"]["n_features"])
        self.model_spec = cell.config["model"]

        def host(s: ref.Split) -> Dataset:
            return Dataset(indices=s.indices.cpu().numpy(), values=s.values.cpu().numpy(),
                           labels=s.labels.cpu().numpy(), n_features=self.n_features)

        self.host_train, self.host_test = host(train), host(test)
        reg = self.model_spec["regularizer"]
        self.model = make_model(
            self.model_spec["name"], float(self.model_spec["lam"]), self.n_features,
            dim_sparsity=dim_sparsity(self.host_train) if reg == "dim_sparsity" else None,
            regularizer=reg, device=device)
        self._problem: Optional[ref.Problem] = None

    # -- the reference's side --------------------------------------------------

    def problem(self, precision: str = ref.REFERENCE) -> ref.Problem:
        if precision != ref.REFERENCE:
            return self._make_problem(precision)
        if self._problem is None:
            self._problem = self._make_problem(precision)
        return self._problem

    def _make_problem(self, precision: str) -> ref.Problem:
        m = self.model_spec
        return ref.make_problem(self.train, self.test, self.n_features, float(m["lam"]),
                                m["regularizer"], precision)

    def evaluate(self, w: torch.Tensor, split: str) -> ref.Evaluation:
        return ref.evaluate(self.problem(), w, split)

    def ids_of_step(self, step: int) -> torch.Tensor:
        raise NotImplementedError

    def follow(self, precision: str, half_batch: bool = False) -> judge.FirstSteps:
        """The reference's first three steps, or with `precision` CONTROL
        the control's, which also reports its own evaluations where the
        program reports its."""
        p = self.problem(precision)
        reports = self.reported_evaluations() if precision == ref.CONTROL else []
        keep = {0, 1, 2} | {i for i, _ in reports}
        states = ref.follow(p, self.optimizer, self.lr, self.ids_of_step, max(keep) + 1,
                            self.mean, self.device, half_batch, keep)
        reported = []
        for i, split in reports:
            e = ref.evaluate(p, states[i].w, split)
            reported.append((states[i].w.float(), split, e.objective, e.accuracy))
        w0 = torch.zeros(self.n_features, dtype=torch.float64, device=self.device)
        return judge.FirstSteps([states[i].w.float() for i in range(3)],
                                ref.first_gradient(states[0], w0, self.lr), reported)

    def reported_evaluations(self):
        """(step index, split) of the evaluations the program reports over
        the steps the check reads."""
        raise NotImplementedError

    def first_gradient(self, w1: torch.Tensor, mu1: Optional[torch.Tensor], count: int):
        """The program's first gradient from its state after step 1."""
        if self.optimizer == "sgd":
            return -w1.double() / self.lr
        return mu1.double() / (1.0 - ref.ADAM_B1 ** count)

    # -- the work, from shapes -----------------------------------------------------

    def sweep_ops(self) -> int:
        reg = self.model_spec["regularizer"]
        if self.optimizer == "sgd" and reg == "dim_sparsity":
            return REG_OPS[reg]  # the update touches only the drawn features
        return SWEEP_OPS[self.optimizer] + REG_OPS[reg]

    def n_state(self) -> int:
        return {"sgd": 0, "momentum": 1, "adam": 2}[self.optimizer]

    def evaluation_work(self, split: ref.Split) -> roofline.Work:
        return roofline.evaluation(len(split), split.indices.shape[1], self.n_features)

    def release(self) -> None:
        """Drop the program's objects and their memory on the card."""
        for name in ("engine", "trainer", "model", "host_train", "host_test"):
            if hasattr(self, name):
                setattr(self, name, None)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
