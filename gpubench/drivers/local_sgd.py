"""One card's local SGD: ``LocalSGDEngine.fit`` (parallel/local_sgd.py).

One engine runs one fit from zero weights.  Its rounds up to its second
loss check (round 1, and round 1 + check_every / sync_period) are
set-up: they bind the rows, build or load the kernel and warm every
shape, and the check compares the first three rounds with the reference,
and both checks' evaluations.  The engine exposes no state between
rounds, so the harness reads the weights and optimizer state that those
rounds return through a subclass of the engine's ``MeanSteps``: it
records what ``run`` returns and changes nothing, and once the checked
rounds are recorded, its ``run`` is the engine's own (an attribute of the
instance), so the window runs the engine's code.  On one card the
replicas' average is the identity, so that is each round's state.  The
window opens at the second check; each later check is a boundary of the
window, which ends at the first after the window's length: the fit's
stopping criterion is the harness's.
"""

from __future__ import annotations

import math

import torch

from gpubench import judge, roofline
from gpubench.harness import Part
from gpubench.program import EngineDriver
from gpubench.reference import linear as ref

FIRST_ROUNDS = 3
NO_LIMIT = 10 ** 6  # epochs of budget: the harness's criterion ends the fit
ROUND_SECONDS = "slave.async.round.seconds"


class Driver(EngineDriver):
    unit = "round"
    mean = True

    def __init__(self, cell, train, test, seed, device):
        super().__init__(cell, train, test, seed, device)
        from distributed_sgd_tpu_torch.parallel.local_sgd import LocalSGDEngine
        from distributed_sgd_tpu_torch.utils.metrics import Metrics

        s = self.settings
        self.b, self.h = int(s["batch_size"]), int(s["sync_period"])
        self.leaky = float(s["leaky_loss"])
        self.engine = LocalSGDEngine(
            self.model, batch_size=self.b, learning_rate=self.lr, sync_period=self.h,
            check_every=int(s["check_every"]), leaky_loss=self.leaky,
            seed=self.seed, metrics=Metrics(), optimizer=self.optimizer, device=device)
        n_workers = self.engine.n_workers
        self.samples_per_round = self.h * self.b * n_workers
        # the rounds (1-based) after which the first two loss checks run
        self.check_rounds = (1, 1 + math.ceil(int(s["check_every"]) / (self.h * n_workers)))

    def run(self, window) -> judge.FirstSteps:
        from distributed_sgd_tpu_torch.parallel import local_sgd

        plain = local_sgd.MeanSteps
        kept = {}  # round (1-based) -> (w, state vectors, count)
        last = self.check_rounds[1]

        class Recording(plain):
            def __init__(self, *args, **kwargs):
                super().__init__(*args, **kwargs)
                local_sgd.MeanSteps = plain  # the fit has built its one instance
                self.rounds = 0

            def run(self, w, ids, state=None):
                out = plain.run(self, w, ids, state)
                self.rounds += 1
                if self.rounds <= FIRST_ROUNDS or self.rounds == last:
                    w_out, st = out
                    kept[self.rounds] = (w_out.clone(), [v.clone() for v in st.vectors],
                                         st.count)
                if self.rounds == last:
                    self.run = plain.run.__get__(self)  # the window runs the engine's own
                return out

        hist = self.engine.metrics.histogram(ROUND_SECONDS)
        checks = [0]

        def totals():
            return {"rounds": hist.count, "round_s": hist.sum, "checks": checks[0]}

        def stop(_smoothed_newest_first) -> bool:
            checks[0] += 1
            if checks[0] == 2:
                window.open(totals)
            return checks[0] > 2 and window.boundary()

        local_sgd.MeanSteps = Recording
        try:
            res = self.engine.fit(self.host_train, self.host_test, max_epochs=NO_LIMIT,
                                  criterion=stop)
        finally:
            local_sgd.MeanSteps = plain
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window.close()
        if sorted(kept) != [1, 2, 3, last]:
            raise RuntimeError(f"recorded rounds {sorted(kept)}, want 1-3 and {last}")
        weights = [kept[r][0].float() for r in (1, 2, 3)]
        _, vectors, count = kept[1]
        mu1 = vectors[0] if self.optimizer == "adam" else None
        # the checker reports its smoothed history: the second check's raw
        # value comes back out of the leaky average
        loss, acc = res.test_losses, res.test_accuracies
        raw = lambda s, i: (s[i] - (1 - self.leaky) * s[i - 1]) / self.leaky  # noqa: E731
        reported = [(weights[0], "test", loss[0], acc[0]),
                    (kept[last][0].float(), "test", raw(loss, 1), raw(acc, 1))]
        return judge.FirstSteps(weights, self.first_gradient(weights[0], mu1, count), reported)

    def measure(self, lo, hi):
        """(rounds, samples, the rounds' seconds and the loss checks) between
        two marks."""
        rounds = hi["rounds"] - lo["rounds"]
        return (rounds, rounds * self.samples_per_round,
                {"round_seconds": hi["round_s"] - lo["round_s"],
                 "checks": hi["checks"] - lo["checks"]})

    def reported_evaluations(self):
        return [(0, "test"), (self.check_rounds[1] - 1, "test")]

    def ids_of_step(self, step):
        return ref.local_round_ids(self.seed, step, len(self.train), self.h, self.b, self.device)

    def launch_work(self) -> roofline.Work:
        return roofline.sync_epoch_launch(
            self.h, 1, self.b, self.train.indices.shape[1], self.n_features,
            ref.padded_rows(len(self.train)), self.n_state(),
            self.model_spec["regularizer"] == "dim_sparsity", self.sweep_ops())

    def part_work(self, part: Part) -> roofline.Work:
        return (self.launch_work() * part.units
                + self.evaluation_work(self.test) * part.extra["checks"])
