"""The CLI trained from a reference-format text corpus, on one device.

    python -m distributed_sgd_tpu_torch.tools.corpus_fit [--device cpu|cuda]
        [--rows 804414] [--epochs 2] [--seed 0] [--dir DIR]
        [--witness 0,1,2,3,4]

Writes a corpus with ``data/corpus.py`` (``--seed``; the reference's
804,414 rows by default: the 23,149-row train file, four test parts and
the qrels) into a temporary directory under ``--dir`` (removed after),
then runs ``main.main(device=...)`` over it with DSGD_DATA_PATH,
DSGD_FULL=1 and DSGD_MAX_EPOCHS=``--epochs`` and the CLI's defaults
otherwise (3 workers, B=100, lr 0.5, lambda 1e-5).  Prints the parser's
route, the write's seconds and bytes, then one JSON line: the run's data
seconds, rows, epoch seconds and its test losses and accuracies.

``--device cpu`` gives the reference that ``chip_smoke.py`` phase 18's
accuracy floor is set from (the CPU's plain sums against the card's
kernel); ``--device cuda`` needs one card and nvcc.

``--witness SEEDS`` (one card) runs, for each sampling seed (DSGD_SEED),
five fits over the same corpus and prints one JSON line each seed: the
card's (one ``sync_epoch`` launch an epoch; its sample ids kept), the
card's per-step path (``worker_grads`` each step) on those ids, the CPU
on those ids (the epoch kernel's plain version, and per step), and the
CPU on its own ids.  The first four share the ids, so they tell the
kernel's arithmetic from the draw; the last tells what the draw alone
does to the test losses.  Where the two per-step fits part, the line
gives the step and the smallest margin of its samples.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile
import time

from distributed_sgd_tpu_torch import main as port_main
from distributed_sgd_tpu_torch.data import _native
from distributed_sgd_tpu_torch.data.corpus import N_ROWS_FULL, N_TRAIN_ROWS, write_rcv1_corpus
from distributed_sgd_tpu_torch.parallel import sync

FIT_ENV = ("DSGD_DATA_PATH", "DSGD_FULL", "DSGD_MAX_EPOCHS", "DSGD_SEED")


def fit_from_text(folder: str, epochs: int, device=None, seed: int = 0):
    """``main()`` over the corpus in `folder` (all five files) with
    DSGD_SEED=`seed`; returns (the Run, the rows it loaded).  The DSGD_*
    settings it sets are restored afterwards; DSGD_SYNTHETIC must be
    unset."""
    if os.environ.get("DSGD_SYNTHETIC"):
        raise RuntimeError("DSGD_SYNTHETIC is set: main() would not read the text files")
    old = {k: os.environ.get(k) for k in FIT_ENV}
    os.environ.update({"DSGD_DATA_PATH": folder, "DSGD_FULL": "1",
                       "DSGD_MAX_EPOCHS": str(epochs), "DSGD_SEED": str(seed)})
    rows = {}
    build = port_main.build

    def counted(cfg, device=None):
        train, test, model = build(cfg, device)
        rows["n"] = len(train) + len(test)
        return train, test, model

    port_main.build = counted
    try:
        run = port_main.main(device=device)
    finally:
        port_main.build = build
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return run, rows["n"]


@contextlib.contextmanager
def sample_ids_route(record=None, replay=None, per_step: bool = False, trace=None):
    """Within: each train epoch's sample ids are taken in order from
    `replay` instead of drawn, and appended to `record` (on the host);
    with `per_step` the sync engine runs each step on its own
    (``worker_grads`` a step) where the epoch kernel would run, and
    `trace` (a dict) gets each step's weights before it ("w", on the host)
    and the train binding ("bound")."""
    draw, plan, one_step = sync.BoundSync._sample_ids, sync.cluster_plan, sync.BoundSync._one_step
    given = iter(replay) if replay is not None else None

    def sample_ids(self, key):
        ids = next(given).to(self.device) if given is not None else draw(self, key)
        if record is not None:
            record.append(ids.cpu())
        return ids

    def traced_step(self, w, ids):
        trace.setdefault("w", []).append(w.detach().cpu())
        trace["bound"] = self
        return one_step(self, w, ids)

    sync.BoundSync._sample_ids = sample_ids
    if per_step:
        sync.cluster_plan = lambda *a, **kw: None
    if trace is not None:
        sync.BoundSync._one_step = traced_step
    try:
        yield
    finally:
        sync.BoundSync._sample_ids, sync.cluster_plan = draw, plan
        sync.BoundSync._one_step = one_step


def first_divergence(a: dict, b: dict, ids, gap: float = 1e-5):
    """The first step after which two per-step traces on the same ids
    differ by more than `gap` in a weight: its number, the weights' gap
    before and after it, and the smallest non-zero |x . w| (in float64,
    from `a`'s weights before it) of the step's samples: the hinge's
    subgradient switches at 0, where two summation orders can disagree on
    the sign.  None when they never part."""
    steps = [s for epoch in ids for s in epoch]  # [K, B] each
    ws_a, ws_b = a["w"], b["w"]
    gaps = [float((x - y).abs().max()) for x, y in zip(ws_a, ws_b)]
    for s in range(len(gaps) - 1):
        if gaps[s + 1] > gap:
            data = b["bound"].data
            rows = steps[s].reshape(-1)
            idx, val = data.indices[rows].long(), data.values[rows].double()
            margins = (ws_a[s].double()[idx] * val).sum(dim=1).abs()
            nonzero = margins[margins > 0]  # an exact 0 is 0 in every order
            return {"step": s, "gap_before": gaps[s], "gap_after": gaps[s + 1],
                    "min_abs_nonzero_margin": float(nonzero.min()) if len(nonzero) else None}
    return None


def witness(folder: str, epochs: int, seed: int) -> dict:
    """The fits of ``--witness`` at sampling seed `seed`: their test
    losses and accuracies, the largest gaps between those that share the
    card's ids, and where the card's and the CPU's per-step fits part."""
    ids, card_trace, cpu_trace = [], {}, {}
    fits = {}
    with sample_ids_route(record=ids):
        fits["card"] = fit_from_text(folder, epochs, device="cuda", seed=seed)[0].fit
    with sample_ids_route(replay=ids, per_step=True, trace=card_trace):
        fits["card_per_step"] = fit_from_text(folder, epochs, device="cuda", seed=seed)[0].fit
    with sample_ids_route(replay=ids):
        fits["cpu_card_ids"] = fit_from_text(folder, epochs, device="cpu", seed=seed)[0].fit
    with sample_ids_route(replay=ids, per_step=True, trace=cpu_trace):
        fits["cpu_per_step_card_ids"] = fit_from_text(folder, epochs, device="cpu",
                                                      seed=seed)[0].fit
    fits["cpu_own_ids"] = fit_from_text(folder, epochs, device="cpu", seed=seed)[0].fit
    out = {"sampling_seed": seed}
    for name, fit in fits.items():
        out[name] = {"test_losses": fit.test_losses, "test_accuracies": fit.test_accuracies,
                     "loss_rose": any(b > a for a, b in zip(fit.test_losses,
                                                            fit.test_losses[1:]))}
    card = fits["card"].test_losses
    for name in ("card_per_step", "cpu_card_ids", "cpu_per_step_card_ids"):
        out[f"max_loss_gap_{name}"] = max(abs(a - b) for a, b in
                                          zip(card, fits[name].test_losses))
    out["per_step_parting"] = first_divergence(card_trace, cpu_trace, ids)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rows", type=int, default=N_ROWS_FULL)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dir", default=None, help="where the temporary corpus goes")
    ap.add_argument("--witness", default=None,
                    help="comma-separated sampling seeds: the five fits of each (one card)")
    args = ap.parse_args()
    print(f"native parser loaded: {_native.native_loaded()}", flush=True)
    folder = tempfile.mkdtemp(prefix="dsgd-corpus-", dir=args.dir)
    try:
        t0 = time.perf_counter()
        meta = write_rcv1_corpus(folder, n_rows=args.rows,
                                 n_train=min(N_TRAIN_ROWS, args.rows * 4 // 5), seed=args.seed)
        print(f"corpus written: {meta['n_rows']} rows, {meta['bytes']} bytes in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        if args.witness:
            for seed in (int(x) for x in args.witness.split(",")):
                t0 = time.perf_counter()
                out = witness(folder, args.epochs, seed)
                out.update(corpus_seed=args.seed, seconds=time.perf_counter() - t0)
                print(json.dumps(out), flush=True)
            return
        t0 = time.perf_counter()
        run, rows = fit_from_text(folder, args.epochs, device=args.device)
        fit = run.fit
        print(json.dumps({"device": args.device, "rows": rows, "seed": args.seed,
                          "data_seconds": run.data_seconds,
                          "seconds": time.perf_counter() - t0,
                          "epoch_seconds": fit.epoch_seconds,
                          "test_losses": fit.test_losses,
                          "test_accuracies": fit.test_accuracies}), flush=True)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


if __name__ == "__main__":
    main()
