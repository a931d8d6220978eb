"""Application entry point: the dev-mode scenario on one CUDA card.

The port of the JAX package's CLI run with no DSGD_ENGINE
(distributed_sgd_tpu/main.py): load RCV1 (or synthetic RCV1-shaped rows
with DSGD_SYNTHETIC=<n>), split 80/20, build the model with the train
split's dim-sparsity regularizer, and fit on the card, early-stopping on
the test loss.  The fit is the sync engine with K virtual workers, or with
DSGD_ASYNC=1 the Hogwild gossip engine with node_count workers
(DSGD_ASYNC_MODE=gossip, the default) or local SGD
(DSGD_ASYNC_MODE=local_sgd).  Every engine takes DSGD_OPTIMIZER
(sgd | momentum | adam) with DSGD_MOMENTUM.  DSGD_CHECKPOINT_DIR saves
and resumes every engine (checkpoint.py: the sync trainer every
DSGD_CHECKPOINT_EVERY epochs, the async engines' best weights), and
DSGD_PROFILE_DIR writes a torch.profiler trace of one sync epoch.
Behaviour is driven by DSGD_* env config (config.py).

Run: ``python -m distributed_sgd_tpu_torch``
"""

from __future__ import annotations

import logging
import os
import socket
import sys
import time
from dataclasses import dataclass

import numpy as np

from distributed_sgd_tpu_torch.checkpoint import Checkpointer
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.early_stopping import no_improvement
from distributed_sgd_tpu_torch.core.trainer import FitResult, SyncTrainer
from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity, load_rcv1, train_test_split
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.parallel.hogwild import HogwildEngine
from distributed_sgd_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device, world_size
from distributed_sgd_tpu_torch.utils.log import setup as setup_logging

log = logging.getLogger("dsgd.main")


@dataclass
class Run:
    """What `main` ran: the fit, and the seconds spent loading data."""

    fit: FitResult
    data_seconds: float


def load_data(cfg: Config) -> Dataset:
    """RCV1 from cfg.data_path, or synthetic via DSGD_SYNTHETIC=<n> when the
    corpus is absent."""
    synthetic = os.environ.get("DSGD_SYNTHETIC")
    train_file = os.path.join(cfg.data_path, "lyrl2004_vectors_train.dat")
    if synthetic or not os.path.exists(train_file):
        n = int(synthetic or 100_000)
        log.info("RCV1 not found or DSGD_SYNTHETIC set: generating %d synthetic rows", n)
        # ltc/IDF value weighting, like real RCV1-v2 term weighting: the
        # default lr=0.5 only descends smoothly with it
        return rcv1_like(n, seed=cfg.seed, idf_values=True)
    return load_rcv1(cfg.data_path, full=cfg.full, pad_width=cfg.pad_width)


def build(cfg: Config, device: DeviceLike = None):
    """(train, test, model) on `device`."""
    data = load_data(cfg)
    train, test = train_test_split(data)
    model = make_model(cfg.model, cfg.lam, train.n_features,
                       dim_sparsity=dim_sparsity(train), device=device)
    return train, test, model


def _make_checkpointer(cfg: Config):
    """cfg.checkpoint_dir -> a Checkpointer, or None: the sync trainer saves
    every cfg.checkpoint_every epochs and resumes from the latest snapshot;
    the async engines' loss checkers save each new best and resume from
    the latest."""
    return Checkpointer(cfg.checkpoint_dir) if cfg.checkpoint_dir else None


def _restore_weights(ckpt):
    """The latest snapshot's weights (an async fit's warm start), or None."""
    restored = ckpt.restore_latest() if ckpt is not None else None
    if restored is None:
        return None
    step, state = restored
    log.info("warm start from checkpoint at step %d", step)
    return np.asarray(state["weights"])


def select_topology(
    node_count: int, n_devices: int, use_async: bool,
    virtual_workers: int = 1, exact_topology: bool = False,
):
    """(devices, virtual workers per device) for the sync path: cover the
    full reference worker count even on fewer devices, the remaining
    workers emulated per device.  Default: every device with ceil-division
    virtual workers (the total may exceed node_count by < n_devices);
    exact_topology insists on exactly node_count workers via the largest
    divisor <= n_devices."""
    n_max = min(node_count, n_devices)
    virtual = virtual_workers
    if not use_async and virtual == 1 and node_count > n_max:
        if exact_topology:
            n = max(d for d in range(1, n_max + 1) if node_count % d == 0)
            virtual = node_count // n
            if n < n_max:
                log.warning(
                    "exact_topology: shrank to %d device(s) (the largest divisor "
                    "of node_count=%d that is <= %d; %d device(s) idle) to run "
                    "exactly %d workers", n, node_count, n_max, n_max - n, node_count)
        else:
            n = n_max
            virtual = -(-node_count // n)  # ceil
            if n * virtual != node_count:
                log.warning(
                    "node_count=%d rounded up to %d workers (%d devices x %d "
                    "virtual) to keep every device busy; set "
                    "DSGD_EXACT_TOPOLOGY=1 for exactly node_count workers",
                    node_count, n * virtual, n, virtual)
    else:
        n = n_max
    return n, virtual


def scenario_mesh(cfg: Config, train: Dataset, test: Dataset, model,
                  device: DeviceLike = None) -> FitResult:
    """Dev-mode scenario on one device: the sync trainer, or an async
    engine with DSGD_ASYNC=1."""
    n, virtual = select_topology(
        cfg.node_count, world_size(), cfg.use_async,
        cfg.virtual_workers, cfg.exact_topology)
    criterion = no_improvement(patience=cfg.patience, min_delta=cfg.conv_delta)
    if cfg.gossip_topology != "all" and not (cfg.use_async and cfg.async_mode == "gossip"):
        log.warning("DSGD_GOSSIP_TOPOLOGY=%s ignored: only the gossip engine "
                    "(async_mode=gossip) has a peer fan-out", cfg.gossip_topology)
    log.info("engine=mesh devices=%d virtual_workers=%d model=%s async=%s device=%s",
             n, virtual, cfg.model, cfg.use_async, resolve_device(device))
    ckpt = _make_checkpointer(cfg)
    if cfg.use_async and cfg.async_mode == "gossip":
        eng = HogwildEngine(
            model, n_workers=cfg.node_count, batch_size=cfg.batch_size,
            learning_rate=cfg.learning_rate, check_every=cfg.check_every,
            leaky_loss=cfg.leaky_loss, seed=cfg.seed, checkpointer=ckpt,
            steps_per_dispatch=cfg.steps_per_dispatch, optimizer=cfg.optimizer,
            momentum=cfg.momentum, compress=cfg.compress,
            gossip_topology=cfg.gossip_topology, device=device)
        res = eng.fit(train, test, cfg.max_epochs, criterion,
                      initial_weights=_restore_weights(ckpt))
    elif cfg.use_async:
        eng = LocalSGDEngine(
            model, batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
            sync_period=cfg.sync_period, check_every=cfg.check_every,
            leaky_loss=cfg.leaky_loss, seed=cfg.seed, checkpointer=ckpt,
            optimizer=cfg.optimizer, momentum=cfg.momentum, device=device)
        res = eng.fit(train, test, cfg.max_epochs, criterion,
                      initial_weights=_restore_weights(ckpt))
    else:
        trainer = SyncTrainer(
            model, batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
            seed=cfg.seed, virtual_workers=virtual, optimizer=cfg.optimizer,
            momentum=cfg.momentum, checkpointer=ckpt,
            checkpoint_every=cfg.checkpoint_every, profile_dir=cfg.profile_dir,
            device=device)
        res = trainer.fit(train, test, cfg.max_epochs, criterion)
    _finish(res)
    return res


def _finish(res: FitResult) -> None:
    log.info("fit done: %d epochs, final loss=%.6f, %d updates",
             res.epochs_run, res.state.loss, res.state.updates)
    log.info("test losses: %s", ", ".join(f"{x:.6f}" for x in res.test_losses))


def main(device: DeviceLike = None) -> Run:
    device = resolve_device(device)
    setup_logging()
    cfg = Config.from_env()
    log.info("host: %s (%s)", socket.gethostname(), sys.platform)
    log.info("config: %s", cfg.to_json())
    np.random.seed(cfg.seed)
    t0 = time.perf_counter()
    train, test, model = build(cfg, device)
    data_s = time.perf_counter() - t0
    log.info("data loaded: %d train + %d test rows in %.2fs", len(train), len(test), data_s)
    return Run(fit=scenario_mesh(cfg, train, test, model, device), data_seconds=data_s)


if __name__ == "__main__":
    main()
