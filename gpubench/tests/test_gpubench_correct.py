"""`correct` comes out false for the control and for each planted fault.

At the CPU's size, with the cells' own limits: the control (the plain
reference in bfloat16 put in the program's place) fails a number of each
cell; and a run whose timed path is broken underneath, the look for a
card skipped, reports `correct` false: a step that returns its state
unchanged, half of each batch left out with the step's own reduction
taken over the rest, every weight written one feature along (which keeps
each norm), and an evaluation's answer altered where it is made.
The exchange between cards is not a fault these one-card cells can have."""

import time

import pytest
import torch

from gpubench import harness, judge
from gpubench.data import make_rows
from gpubench.reference.linear import CONTROL, REFERENCE, fold_in

CELLS = ["sync3-b100-sgd", "local-b256-h16-sgd", "local-b256-h16-adam"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails(tiny, cell):
    c = tiny.cell(cell)
    train, test = make_rows(c.config["data"], fold_in(17, 1), "cpu")
    drv = tiny.driver(c.config["engine"])(c, train, test, fold_in(17, 2), torch.device("cpu"))
    got = judge.numbers(drv.follow(CONTROL), drv.follow(REFERENCE), drv.evaluate)
    correct, checks = judge.verdict(got, c.limits)
    assert not correct, checks


def _unchanged(real):
    def fault(w, ids, *args, optimizer=None, opt_state=None, **kw):
        w = w.clone()
        return w if optimizer is None else (w, opt_state)
    return fault


def _half_batch(real):
    def fault(w, ids, *args, grad_divisor=1, **kw):
        half = ids.shape[2] // 2
        divisor = grad_divisor * half / ids.shape[2] if grad_divisor != 1 else 1
        return real(w, ids[:, :, :half].contiguous(), *args, grad_divisor=divisor, **kw)
    return fault


def _features_shifted(real):
    """Every weight written one feature along: each norm kept, the
    direction lost."""
    def fault(*args, **kw):
        out = real(*args, **kw)
        if isinstance(out, tuple):
            return (out[0].roll(1), *out[1:])
        return out.roll(1)
    return fault


FAULTS = {"unchanged": _unchanged, "half_batch": _half_batch,
          "features_shifted": _features_shifted}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [*FAULTS, "answer_altered"])
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, cell, fault):
    from distributed_sgd_tpu_torch.parallel import sync

    if fault == "answer_altered":
        real_eval = sync.BoundSync.evaluate

        def altered(self, w):
            loss, acc = real_eval(self, w)
            return loss * 1.001, acc
        monkeypatch.setattr(sync.BoundSync, "evaluate", altered)
    else:
        monkeypatch.setattr(sync, "sync_epoch", FAULTS[fault](sync.sync_epoch))
    out = harness.run_cell(tiny, cell, 23, 0.1, False, time.perf_counter(), device="cpu",
                           log=lambda m: None)
    assert out["correct"] is False, out["checks"]
    if fault == "features_shifted" and cell.startswith("sync"):
        cos = out["checks"]["grad1_cos_gap"]
        assert cos["value"] > cos["limit"], "the direction catches what the norms keep"


def test_the_sound_path_is_correct_on_the_same_seed(tiny):
    out = harness.run_cell(tiny, "sync3-b100-sgd", 23, 0.1, False, time.perf_counter(),
                           device="cpu", log=lambda m: None)
    assert out["correct"] is True, out["checks"]
