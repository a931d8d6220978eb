"""The sync main path: ``SyncTrainer.fit`` (core/trainer.py).

One trainer runs one fit from zero weights.  Its first three epochs are
set-up: they bind the rows, build or load the kernel and warm every
shape, and the check compares them with the reference.  The trainer's
checkpointer, an object of this file that keeps the weights of those
three epochs and then does nothing, is how the harness sees them.  The
window opens at the end of the third epoch; each later epoch's end is a
boundary of the window, which ends at the first after the window's
length: the fit's stopping criterion is the harness's.  Every epoch
counts whole: its training launch and the train and test evaluations
after it.
"""

from __future__ import annotations

import torch

from gpubench import judge, roofline
from gpubench.harness import Part
from gpubench.program import EngineDriver
from gpubench.reference import linear as ref

FIRST_EPOCHS = 3
NO_LIMIT = 10 ** 9  # epochs: the harness's criterion ends the window's fit


class _EpochWeights:
    """A checkpointer that keeps what each save hands it and restores
    nothing: the weights and optimizer leaves after each epoch."""

    def __init__(self):
        self.saved = []

    def save(self, step, weights, extra=None):
        if len(self.saved) >= FIRST_EPOCHS:
            return True
        extra = extra or {}
        leaves = [torch.as_tensor(extra[f"opt_{i}"]).clone()
                  for i in range(len(extra)) if f"opt_{i}" in extra]
        self.saved.append((int(step), torch.as_tensor(weights).clone(), leaves))
        return True

    def restore_latest(self):
        return None


class Driver(EngineDriver):
    unit = "epoch"
    mean = False

    def __init__(self, cell, train, test, seed, device):
        super().__init__(cell, train, test, seed, device)
        from distributed_sgd_tpu_torch.core.trainer import SyncTrainer

        s = self.settings
        self.k, self.b = int(s["virtual_workers"]), int(s["batch_size"])
        self.saves = _EpochWeights()
        self.trainer = SyncTrainer(self.model, batch_size=self.b, learning_rate=self.lr,
                                   sampling=s["sampling"], seed=self.seed,
                                   virtual_workers=self.k, optimizer=self.optimizer,
                                   checkpointer=self.saves, device=device)

    def run(self, window) -> judge.FirstSteps:
        done = [0]  # epochs the fit has ended

        def stop(_test_losses_newest_first) -> bool:
            done[0] += 1
            if done[0] == FIRST_EPOCHS:
                window.open(lambda: {"epochs": done[0]})
            return done[0] > FIRST_EPOCHS and window.boundary()

        self.res = res = self.trainer.fit(self.host_train, self.host_test, max_epochs=NO_LIMIT,
                                          criterion=stop)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        window.close()
        if [s for s, _, _ in self.saves.saved] != list(range(1, FIRST_EPOCHS + 1)):
            raise RuntimeError(f"the trainer saved epochs {[s for s, _, _ in self.saves.saved]}")
        weights = [w.float() for _, w, _ in self.saves.saved]
        leaves = self.saves.saved[0][2]
        mu1, count = (leaves[1], int(leaves[0])) if self.optimizer == "adam" else (None, 0)
        reported = []
        for e in range(FIRST_EPOCHS):
            reported.append((weights[e], "train", res.losses[e], res.accuracies[e]))
            reported.append((weights[e], "test", res.test_losses[e], res.test_accuracies[e]))
        self.steps_per_epoch = res.steps_per_epoch
        return judge.FirstSteps(weights, self.first_gradient(weights[0], mu1, count), reported)

    def measure(self, lo, hi):
        """(epochs, samples, the trainer's own epoch seconds) between two marks."""
        a, b = lo["epochs"], hi["epochs"]
        return (b - a, (b - a) * self.res.steps_per_epoch * self.b * self.k,
                {"epoch_seconds": list(self.res.epoch_seconds[a:b])})

    def reported_evaluations(self):
        return [(e, split) for e in range(FIRST_EPOCHS) for split in ("train", "test")]

    def ids_of_step(self, step):
        return ref.sync_epoch_ids(self.seed, step, len(self.train), self.k, self.b, self.device)

    def launch_work(self) -> roofline.Work:
        pool = -(-ref.padded_rows(len(self.train)) // self.k)
        return roofline.sync_epoch_launch(
            self.steps_per_epoch, self.k, self.b, self.train.indices.shape[1], self.n_features,
            pool, self.n_state(), self.model_spec["regularizer"] == "dim_sparsity",
            self.sweep_ops())

    def part_work(self, part: Part) -> roofline.Work:
        epoch = (self.launch_work() + self.evaluation_work(self.train)
                 + self.evaluation_work(self.test))
        return epoch * part.units
