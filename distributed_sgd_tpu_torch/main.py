"""Application entry point: config-driven role selection and scenario.

The port of the JAX package's CLI (distributed_sgd_tpu/main.py, after the
reference's Main.scala): no flags, DSGD_* env config (config.py).  The
role (config.py ``Config.role``) picks what runs:

- dev (DSGD_MASTER_HOST/PORT unset): load RCV1 (or synthetic RCV1-shaped
  rows with DSGD_SYNTHETIC=<n>), split 80/20, build the model with the
  train split's dim-sparsity regularizer, and fit, early-stopping on the
  test loss.  With DSGD_ENGINE=mesh (the default) the fit is the sync
  engine with K virtual workers, or with DSGD_ASYNC=1 the Hogwild gossip
  engine (DSGD_ASYNC_MODE=gossip) or local SGD (local_sgd), or with
  DSGD_FEATURE_SHARDS=F > 1 the dp x tp engine (parallel/
  feature_sharded.py).  Under ``torchrun`` (WORLD_SIZE set) the dev role
  joins the process group first (parallel/multihost.py), one rank a card
  (``cuda:LOCAL_RANK``), and the mesh engines span the ranks: the sync
  and local SGD fits over min(DSGD_NODE_COUNT, world) ranks (the rest wait
  for the result), the dp x tp fit over world / F data ranks.  With
  DSGD_ENGINE=rpc it is the fit of an in-process gRPC cluster
  (core/cluster.py: a master and DSGD_NODE_COUNT workers on loopback):
  the sync fit, or with DSGD_ASYNC=1 the async fit (Hogwild gossip
  between the workers, DSGD_STEPS_PER_DISPATCH local steps a dispatch,
  DSGD_GOSSIP_TOPOLOGY, DSGD_ASYNC_DRAIN), DSGD_HOST_DEVICES=D making each
  worker a host of D devices;
- master (DSGD_MASTER_HOST/PORT equal DSGD_NODE_HOST/PORT): load the
  data, serve on DSGD_NODE_PORT, wait for DSGD_NODE_COUNT workers, run
  the sync fit (or with DSGD_ASYNC=1 the async one) and exit;
- worker (any other DSGD_MASTER_HOST/PORT): load the data, serve on
  DSGD_NODE_PORT, register with the master and answer its calls
  (Gradient and Forward; StartAsync, UpdateGrad and StopAsync, with
  DSGD_STEPS_PER_DISPATCH and DSGD_GOSSIP_TOPOLOGY) until SIGTERM; with
  DSGD_HOST_DEVICES=D (0: every card of the host) it is one host of D
  cards (parallel/hier.py);
- serve (DSGD_ROLE=serve): no data; answer Predict on DSGD_SERVE_PORT
  from the weights under DSGD_CHECKPOINT_DIR, on the card, hot-reloading
  each newer checkpoint and applying pushed weights, until SIGTERM; with
  DSGD_SERVE_REPLICAS=N an in-process fleet of N replicas behind a router
  on DSGD_SERVE_PORT (DSGD_SERVE_SLO_MS adds the replica autoscaler);
- route (DSGD_ROLE=route): the fleet router over DSGD_SERVE_TARGETS
  (balancing, hedges, the canary gate on pushed versions, DSGD_SERVE_STATE,
  DSGD_SERVE_HA), until SIGTERM.  It computes on the host: its only
  arithmetic is the canary's probe loss over the replicas' margins.

The rpc fits (dev with DSGD_ENGINE=rpc, and the master and worker roles)
take the JAX CLI's fault tolerance: DSGD_HEARTBEAT_S (with
DSGD_HEARTBEAT_MAX_MISSES) starts the master's heartbeat, DSGD_QUORUM and
DSGD_STRAGGLER_SOFT_S the sync fit's quorum barrier with straggler hedges,
DSGD_FIT_CKPT_EVERY (under DSGD_CHECKPOINT_DIR) its crash-safe fit state,
from which a restarted master resumes, and DSGD_ELASTIC the async fit's
elastic membership and, on the worker role, the watch through which the
worker registers again with a restarted master.  The sync fit takes the
JAX CLI's pipelined levers: DSGD_LOCAL_STEPS (K local steps a round),
DSGD_DELTA_BROADCAST, DSGD_STREAM, DSGD_FANIN_LANES and DSGD_STAGE_POOL.
A worker with DSGD_ROW_STORE maps the packed corpus (data/row_store.py)
instead of building the data, and with DSGD_HOST_INDEX holds only its
slice of the train rows (+ DSGD_HOST_OVERPROVISION), reloading the delta
when an elastic resplit moves it.  DSGD_HEALTH_ACTION (warn | snapshot |
halt) puts the training-health monitor on the sync fit (telemetry/
health.py): a non-finite round is dropped, a trip leaves its flight dump,
and snapshot and halt write the fit state where the trip stopped it, from
which any later run under DSGD_CHECKPOINT_DIR resumes.

DSGD_CHAOS (a fault plan or scenario:NAME, chaos/) wraps every RPC
channel of the master and worker roles and of the dev rpc cluster in the
plan's seeded faults; the mesh engine warns about it.  DSGD_COMPILE_CACHE
builds and loads the kernels' libraries from a directory that processes
share (compile_cache.py) and warms the worker role's kernels (and the dev
rpc cluster's, the mesh engine's, a serving replica's) in the background.
DSGD_AUTOPILOT (autopilot/) runs the continual-learning flywheel in the
dev role (a DevCluster trains on a drifting stream's window, a fleet
serves it, drift at the router retrains and promotes hands-free), sources
the route role's canary probes from its own traffic, and trains the
master role on the stream's newest window.

DSGD_COMPRESS (topk | qint8, with DSGD_COMPRESS_K and DSGD_COMPRESS_EF)
encodes every gradient that crosses a wire (compress/): the Hogwild
engine's gossip and the rpc workers' sync replies and async gossip; the
sync, local SGD and dp x tp engines have no wire and warn, as the JAX CLI
does.

Every engine takes DSGD_OPTIMIZER (sgd | momentum | adam) with
DSGD_MOMENTUM.  DSGD_CHECKPOINT_DIR saves and resumes every fit
(checkpoint.py), and with DSGD_SERVE_PUSH the dev and master roles stream
each new checkpoint to a serving fleet (serving/push.py).
DSGD_PROFILE_DIR writes a torch.profiler trace of one sync epoch (or, on
the worker role, of its first dispatches; on the serve role, of its first
Predict batches).  DSGD_RESOURCE_PROBE_S starts the resource probe in any
role (telemetry/resources.py), DSGD_BLACKBOX_DIR its on-disk ring.
DSGD_TELEMETRY acts in every role as in the JAX CLI: the master (and the
dev rpc cluster's) scrapes its workers' registries over the Metrics RPC
and serves the merged view on DSGD_TELEMETRY_PORT, the workers publish
their health gauges, and the route role (and the fleet's router) scrapes
its replicas.  DSGD_TRACE writes per-process span timelines under
DSGD_TRACE_DIR (merge them with
``python -m distributed_sgd_tpu_torch.trace.merge``), DSGD_FLIGHT_RECORDER
sizes the post-mortem ring (SIGUSR2 dumps it), and DSGD_RECORD ships the
metrics registry to DSGD_METRICS_PORT (Prometheus) and/or
DSGD_INFLUX_URL.

Run: ``python -m distributed_sgd_tpu_torch``, or across N ranks
``torchrun --nproc_per_node=N -m distributed_sgd_tpu_torch.main``.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import signal
import socket
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.checkpoint import Checkpointer, fit_state_path
from distributed_sgd_tpu_torch.config import Config
from distributed_sgd_tpu_torch.core.early_stopping import no_improvement
from distributed_sgd_tpu_torch.core.trainer import FitResult, SyncTrainer
from distributed_sgd_tpu_torch.data.rcv1 import Dataset, dim_sparsity, load_rcv1, train_test_split
from distributed_sgd_tpu_torch.data.synthetic import rcv1_like
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.parallel.hogwild import HogwildEngine
from distributed_sgd_tpu_torch.parallel.local_sgd import LocalSGDEngine
from distributed_sgd_tpu_torch.parallel import multihost
from distributed_sgd_tpu_torch.parallel.mesh import (
    DeviceLike,
    distributed,
    rank,
    resolve_device,
    world_size,
)
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod
from distributed_sgd_tpu_torch.utils.log import setup as setup_logging

log = logging.getLogger("dsgd.main")


@dataclass
class Run:
    """What `main` ran: the fit (None on the worker role), and the seconds
    spent loading data."""

    fit: Optional[FitResult]
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
    """Dev-mode scenario over the ranks of the process group (one rank
    without one): the sync trainer, an async engine with DSGD_ASYNC=1, or
    the dp x tp engine with DSGD_FEATURE_SHARDS > 1.  The sync and local
    SGD fits take min(node_count, world) ranks, as the JAX scenario takes
    that many devices; the ranks past them take no part and return rank
    0's result.  The Hogwild engine runs on rank 0 alone."""
    world = world_size()
    criterion = no_improvement(patience=cfg.patience, min_delta=cfg.conv_delta)
    warn_mesh_ignored(cfg)
    ckpt = _make_checkpointer(cfg)
    if cfg.feature_shards > 1:
        # dp x tp: the config already refused async, rpc and optimizers
        from distributed_sgd_tpu_torch.parallel.feature_sharded import (
            FeatureShardedEngine,
            make_mesh_2d,
        )

        if world % cfg.feature_shards:
            raise ValueError(f"DSGD_FEATURE_SHARDS={cfg.feature_shards} does not divide the "
                             f"world of {world} rank(s)")
        n_w = max(1, world // cfg.feature_shards)
        log.info("engine=mesh 2-D dp=%d x tp=%d (feature_shards)", n_w, cfg.feature_shards)
        eng = FeatureShardedEngine(model, make_mesh_2d(n_w, cfg.feature_shards, device),
                                   batch_size=cfg.batch_size, learning_rate=cfg.learning_rate)
        res = eng.fit(train, test, cfg.max_epochs, criterion, checkpointer=ckpt,
                      checkpoint_every=cfg.checkpoint_every, seed=cfg.seed)
        _finish(res)
        return res
    gossip = cfg.use_async and cfg.async_mode == "gossip"
    n, virtual = select_topology(
        cfg.node_count, 1 if gossip else world, cfg.use_async,
        cfg.virtual_workers, cfg.exact_topology)
    log.info("engine=mesh devices=%d virtual_workers=%d model=%s async=%s device=%s",
             n, virtual, cfg.model, cfg.use_async, resolve_device(device))
    group = None
    if n < world:
        group = dist.new_group(list(range(n)))  # every rank makes it
    res = None
    if rank() >= n:
        log.info("rank %d takes no part in the fit (ranks 0..%d run it): waiting for "
                 "the result", rank(), n - 1)
    elif gossip:
        eng = HogwildEngine(
            model, n_workers=cfg.node_count, batch_size=cfg.batch_size,
            learning_rate=cfg.learning_rate, check_every=cfg.check_every,
            leaky_loss=cfg.leaky_loss, seed=cfg.seed, checkpointer=ckpt,
            steps_per_dispatch=cfg.steps_per_dispatch, optimizer=cfg.optimizer,
            momentum=cfg.momentum, compress=cfg.compress, compress_k=cfg.compress_k,
            compress_ef=cfg.compress_ef, gossip_topology=cfg.gossip_topology,
            device=device)
        res = eng.fit(train, test, cfg.max_epochs, criterion,
                      initial_weights=_restore_weights(ckpt))
    elif cfg.use_async:
        eng = LocalSGDEngine(
            model, batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
            sync_period=cfg.sync_period, check_every=cfg.check_every,
            leaky_loss=cfg.leaky_loss, seed=cfg.seed, checkpointer=ckpt,
            optimizer=cfg.optimizer, momentum=cfg.momentum, device=device, group=group)
        res = eng.fit(train, test, cfg.max_epochs, criterion,
                      initial_weights=_restore_weights(ckpt))
    else:
        trainer = SyncTrainer(
            model, batch_size=cfg.batch_size, learning_rate=cfg.learning_rate,
            seed=cfg.seed, virtual_workers=virtual, optimizer=cfg.optimizer,
            momentum=cfg.momentum, checkpointer=ckpt,
            checkpoint_every=cfg.checkpoint_every, profile_dir=cfg.profile_dir,
            device=device, group=group)
        res = trainer.fit(train, test, cfg.max_epochs, criterion)
    if n < world:
        res = _from_rank0(res, device)
    _finish(res)
    return res


def _from_rank0(res: Optional[FitResult], device) -> FitResult:
    """Rank 0's fit result on every rank of the default group (the ranks
    that took no part have none), its weights on this rank's device."""
    if res is not None:
        res.state = dataclasses.replace(res.state, weights=torch.as_tensor(res.state.weights).cpu())
    box = [res]
    dist.broadcast_object_list(box, src=0)
    res = box[0]
    res.state = dataclasses.replace(res.state, weights=res.state.weights.to(resolve_device(device)))
    return res


def warn_mesh_ignored(cfg: Config) -> None:
    """The JAX mesh scenario's warnings (distributed_sgd_tpu/main.py:
    152-206), in its words, for the settings of the rpc topology that the
    in-process engines ignore."""
    if cfg.compress != "none" and not (cfg.use_async and cfg.async_mode == "gossip"):
        # the sync, local SGD and dp x tp engines exchange gradients through
        # collectives: there is no wire to compress
        log.warning(
            "DSGD_COMPRESS=%s ignored: in-mesh engines have no wire path "
            "(use engine=rpc or async_mode=gossip)", cfg.compress)
    if (cfg.local_steps > 1 or cfg.delta_broadcast or cfg.stream
            or cfg.fanin_lanes or cfg.stage_pool or cfg.agg_tree
            or cfg.master_shards):
        log.warning(
            "DSGD_LOCAL_STEPS/DSGD_DELTA_BROADCAST/DSGD_STREAM/"
            "DSGD_FANIN_LANES/DSGD_STAGE_POOL/DSGD_AGG_TREE/"
            "DSGD_MASTER_SHARDS ignored: the pipelined sync engine is "
            "the rpc topology's (use engine=rpc; the mesh local-SGD "
            "equivalent is async_mode=local_sgd / sync_period)")
    if cfg.quorum is not None or cfg.chaos:
        # quorum barriers gate RPC fan-ins and chaos wraps RPC stubs; an
        # in-process collective has neither
        log.warning(
            "DSGD_QUORUM/DSGD_CHAOS ignored: the quorum barrier and the "
            "fault-injection layer live on the rpc topology's wire "
            "(use engine=rpc)")
    if cfg.elastic or cfg.async_drain or cfg.fit_ckpt_every:
        log.warning(
            "DSGD_ELASTIC/DSGD_ASYNC_DRAIN/DSGD_FIT_CKPT_EVERY ignored: "
            "the elastic + crash-recovery subsystem is the rpc topology's "
            "(use engine=rpc; docs/ELASTICITY.md)")
    if (cfg.gossip_topology != "all"
            and not (cfg.use_async and cfg.async_mode == "gossip")):
        log.warning(
            "DSGD_GOSSIP_TOPOLOGY=%s ignored: only the gossip engines "
            "(async_mode=gossip or engine=rpc async) have a peer fan-out",
            cfg.gossip_topology)
    if cfg.telemetry or cfg.health_action:
        log.warning(
            "DSGD_TELEMETRY/DSGD_HEALTH_ACTION ignored: the cluster "
            "telemetry plane is the rpc topology's (use engine=rpc; "
            "docs/OBSERVABILITY.md)")
    if cfg.host_devices != 1:
        log.warning(
            "DSGD_HOST_DEVICES ignored: the mesh engine already spans "
            "every device — the hierarchical in-host layer is the rpc "
            "topology's (use engine=rpc; docs/HIERARCHY.md)")


def _resolve_host_devices(cfg: Config, dev_workers: int = 0) -> int:
    """DSGD_HOST_DEVICES -> a worker host's device count: 0 = auto, every
    card of the host on a standalone worker role, or in dev mode the share
    of each of the `dev_workers` in-process workers (at least 1); 1 = the
    flat single-device worker, D = exactly D devices."""
    if cfg.host_devices == 0:
        d = torch.cuda.device_count()
        if dev_workers:
            d = d // dev_workers
        d = max(1, d)
        log.info("DSGD_HOST_DEVICES=0: auto-sized the in-host mesh to %d device(s)", d)
        return d
    return cfg.host_devices


def _rank_device(device: DeviceLike):
    """The device of this torchrun rank: `device` when given, else
    ``cuda:LOCAL_RANK``.  One rank a card: a LOCAL_RANK past the host's
    cards raises."""
    if device is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards == 0:
        return resolve_device(None)  # raises: no card and no device asked for
    if local >= cards:
        raise RuntimeError(
            f"rank {os.environ.get('RANK', '?')} has LOCAL_RANK {local} but this host has "
            f"{cards} card(s): the CLI runs one rank a card (at most "
            f"--nproc_per_node={cards}); of {os.environ.get('WORLD_SIZE')} ranks in all")
    return torch.device("cuda", local)


def _fit_state_args(cfg: Config) -> dict:
    """DSGD_FIT_CKPT_EVERY -> fit_sync's crash-safe fit-state arguments,
    empty when it is off (the config checked that DSGD_CHECKPOINT_DIR is
    set).  Any health action gets the path too (with fit_ckpt_every 0 the
    path alone, so no cadence snapshot runs): snapshot and halt write the
    trip's snapshot there, and every action, warn included, restores one
    that a halted run left, whatever the action of the restart."""
    if not (cfg.fit_ckpt_every or cfg.health_action) or not cfg.checkpoint_dir:
        return {}
    return {"fit_state_path": fit_state_path(cfg.checkpoint_dir),
            "fit_state_every": cfg.fit_ckpt_every}


def _health_monitor(cfg: Config, metrics=None):
    """DSGD_HEALTH_ACTION -> a telemetry.health.HealthMonitor (None when
    unset).  The resource probe's leak sentinel routes its trips through
    it, as a loss divergence's."""
    if not cfg.health_action:
        return None
    from distributed_sgd_tpu_torch.telemetry import resources
    from distributed_sgd_tpu_torch.telemetry.health import HealthMonitor

    log.info("training-health monitor on: action=%s", cfg.health_action)
    monitor = HealthMonitor(metrics=metrics, action=cfg.health_action)
    probe = resources.active()
    if probe is not None and probe.sentinel is not None:
        probe.sentinel.attach_health(monitor)
    return monitor


def _rpc_fit(cfg: Config, master) -> FitResult:
    """The master's fit: the async one with DSGD_ASYNC=1, else the sync
    one, with the JAX CLI's arguments.  Under DSGD_AUTOPILOT convergence is
    judged on the last 2 * patience + 1 evals only (continual eval): a
    warm-started retrain must not be stopped by a best earned on a
    distribution that no longer exists."""
    criterion = no_improvement(patience=cfg.patience, min_delta=cfg.conv_delta)
    if cfg.autopilot:
        from distributed_sgd_tpu_torch.autopilot import continual_criterion

        criterion = continual_criterion(criterion, horizon=2 * cfg.patience + 1)
    ckpt = _make_checkpointer(cfg)
    if cfg.use_async:
        return master.fit_async(
            cfg.max_epochs, cfg.batch_size, cfg.learning_rate, criterion,
            check_every=cfg.check_every, leaky_loss=cfg.leaky_loss,
            initial_weights=_restore_weights(ckpt), checkpointer=ckpt,
            optimizer=cfg.optimizer, momentum=cfg.momentum,
            elastic=cfg.elastic, batch_drain=cfg.async_drain)
    return master.fit_sync(
        cfg.max_epochs, cfg.batch_size, cfg.learning_rate, criterion,
        checkpointer=ckpt, checkpoint_every=cfg.checkpoint_every,
        optimizer=cfg.optimizer, momentum=cfg.momentum,
        local_steps=cfg.local_steps, delta_broadcast=cfg.delta_broadcast,
        stream=cfg.stream, fanin_lanes=cfg.fanin_lanes, stage_pool=cfg.stage_pool,
        agg_tree=cfg.agg_tree, master_shards=cfg.master_shards,
        quorum=cfg.quorum, straggler_soft_s=cfg.straggler_soft_s,
        health=_health_monitor(cfg, metrics=master.metrics), **_fit_state_args(cfg))


def scenario_rpc(cfg: Config, train: Dataset, test: Dataset, model,
                 metrics: Optional[metrics_mod.Metrics] = None) -> FitResult:
    """Dev-mode reference-parity path: the sync or async fit of an
    in-process gRPC cluster (core/cluster.py), every node on the model's
    device."""
    from distributed_sgd_tpu_torch.core.cluster import DevCluster

    log.info("engine=rpc workers=%d model=%s async=%s device=%s", cfg.node_count, cfg.model,
             cfg.use_async, model.device)
    with DevCluster(model, train, test, n_workers=cfg.node_count, seed=cfg.seed,
                    metrics=metrics, steps_per_dispatch=cfg.steps_per_dispatch,
                    compress=cfg.compress, compress_k=cfg.compress_k,
                    compress_ef=cfg.compress_ef,
                    gossip_topology=cfg.gossip_topology, heartbeat_s=cfg.heartbeat_s,
                    heartbeat_max_misses=cfg.heartbeat_max_misses,
                    telemetry_port=cfg.telemetry_port if cfg.telemetry else None,
                    host_devices=_resolve_host_devices(cfg, dev_workers=cfg.node_count),
                    chaos=cfg.chaos) as c:
        if cfg.compile_cache:
            # every in-process worker warms its kernels in the background
            # before the fit's first fan-out reaches it
            from distributed_sgd_tpu_torch import compile_cache

            for i, w in enumerate(c.workers):
                compile_cache.warmup_async(f"worker[w{i}]",
                                           w.warmup_thunks(cfg.batch_size, cfg.local_steps))
        w0 = np.zeros(model.n_features, dtype=np.float32)
        loss0, acc0 = c.master.local_loss(w0, test=False)
        log.info("initial loss=%.6f acc=%.4f", loss0, acc0)
        res = _rpc_fit(cfg, c.master)
        _finish(res, evaluator=lambda w: c.master.local_loss(w, test=True))
    return res


def _finish(res: FitResult, evaluator=None) -> None:
    log.info("fit done: %d epochs, final loss=%.6f, %d updates",
             res.epochs_run, res.state.loss, res.state.updates)
    log.info("test losses: %s", ", ".join(f"{x:.6f}" for x in res.test_losses))
    if evaluator is not None:
        tl, ta = evaluator(np.asarray(res.state.weights))
        log.info("final test loss=%.6f acc=%.4f", tl, ta)


def _run_master(cfg: Config, train: Dataset, test: Dataset, model) -> FitResult:
    """The master role: serve on DSGD_NODE_PORT, wait for DSGD_NODE_COUNT
    workers, run the sync (or async) fit, stop."""
    from distributed_sgd_tpu_torch.core.master import MasterNode

    master = MasterNode(cfg.host, cfg.port, train, test, model,
                        expected_workers=cfg.node_count, seed=cfg.seed).start(
        heartbeat_s=cfg.heartbeat_s, heartbeat_max_misses=cfg.heartbeat_max_misses)
    try:
        if cfg.telemetry:
            # the scrape and the one cluster-level /metrics endpoint
            master.enable_telemetry(cfg.telemetry_port)
        master.await_ready()
        res = _rpc_fit(cfg, master)
        _finish(res, evaluator=lambda w: master.local_loss(w, test=True))
    finally:
        master.stop()
    return res


def _install_chaos(cfg: Config) -> None:
    """DSGD_CHAOS on a standalone master or worker process: install the
    plan before any channel exists, so every outgoing stub is wrapped
    (chaos/).  Partition specs name endpoints as host:port here; the dev
    rpc cluster also names them master and w0..wN."""
    if not cfg.chaos:
        return
    from distributed_sgd_tpu_torch import chaos

    chaos.install(cfg.chaos, metrics=metrics_mod.global_metrics())
    log.warning("chaos plan active on this node: %s", cfg.chaos)


def _warmup_worker(cfg: Config, worker) -> None:
    """DSGD_COMPILE_CACHE on the worker role: the background warm-up of
    the worker's kernels while registration runs."""
    if not cfg.compile_cache:
        return
    from distributed_sgd_tpu_torch import compile_cache

    compile_cache.warmup_async(f"worker[:{cfg.port}]",
                               worker.warmup_thunks(cfg.batch_size, cfg.local_steps))


def _autopilot_probe_source(cfg: Config):
    """DSGD_AUTOPILOT on the route role -> (ProbeReservoir, refresh_s):
    live probe sourcing (autopilot/probe_source.py) in place of the
    operator-rotated probe file.  The env-driven role joins ground truth
    through the seeded DriftingStream's oracle -- the JAX CLI's assumption
    that the traffic IS the synthetic stream, which the dev role sends; a
    production integrator supplies its own labeler programmatically."""
    if not cfg.autopilot:
        return None, 0.0
    from distributed_sgd_tpu_torch.autopilot import DriftingStream, ProbeReservoir

    stream = DriftingStream(seed=cfg.seed)
    reservoir = ProbeReservoir(
        stream.oracle_labeler(), capacity=cfg.autopilot_probe_capacity,
        seed=cfg.seed, label_delay=cfg.autopilot_label_delay,
        recency=2 * cfg.autopilot_probe_capacity,
        min_fill=max(1, cfg.autopilot_probe_capacity // 2))
    log.info("autopilot probe sourcing: reservoir capacity=%d label_delay=%d refresh=%gs",
             reservoir.capacity, reservoir.label_delay, cfg.autopilot_source_refresh_s)
    return reservoir, cfg.autopilot_source_refresh_s


def _autopilot_stream_build(cfg: Config, device: DeviceLike = None):
    """DSGD_AUTOPILOT on the master role -> (train, test, model) of the
    stream plane (autopilot/stream.py): the corpus is the first
    DSGD_AUTOPILOT_WINDOW rows of the seeded drifting stream and the eval
    set is pinned at the window's trailing edge, so early stopping judges
    convergence on the CURRENT distribution.  A relaunch with a raised
    DSGD_MAX_EPOCHS warm-starts from the epoch checkpoints: one retrain
    round."""
    from distributed_sgd_tpu_torch.autopilot import DriftingStream

    stream = DriftingStream(seed=cfg.seed)
    t0 = time.perf_counter()
    train = stream.rows(0, cfg.autopilot_window)
    log.info("stream window materialized in %.2fs", time.perf_counter() - t0)
    test = stream.eval_set(max(256, cfg.autopilot_window // 8), at=cfg.autopilot_window)
    model = make_model(cfg.model, cfg.lam, train.n_features, dim_sparsity=dim_sparsity(train),
                       device=device)
    return train, test, model


def _run_dev_flywheel(cfg: Config, device: DeviceLike = None) -> None:
    """DSGD_ROLE=dev + DSGD_AUTOPILOT: the whole closed loop in one
    process (autopilot/flywheel.py), on `device`.  Pumps one complete
    shift through the fleet unpaced and waits up to 300 s for the
    controller to settle, as the JAX CLI does (whether the detector's
    warm-up sees pre-shift traffic then depends on how fast the pump
    runs), and logs the summary."""
    from distributed_sgd_tpu_torch.autopilot import DriftDetector, DriftingStream, Flywheel

    stream = DriftingStream(seed=cfg.seed)
    horizon = stream.shift_at + 2 * cfg.autopilot_window
    detector = DriftDetector(
        ratio=cfg.autopilot_drift_ratio, patience=cfg.autopilot_drift_patience,
        warmup=cfg.autopilot_drift_warmup, abs_floor=cfg.autopilot_drift_floor)
    fly = Flywheel(
        stream, horizon_rows=horizon, window_rows=cfg.autopilot_window,
        model=cfg.model, lam=cfg.lam, n_workers=2,
        n_replicas=max(2, cfg.serve_replicas),
        max_epochs=cfg.max_epochs, batch_size=cfg.batch_size,
        learning_rate=cfg.learning_rate, patience=cfg.patience,
        conv_delta=cfg.conv_delta,
        probe_capacity=cfg.autopilot_probe_capacity,
        label_delay=cfg.autopilot_label_delay,
        source_refresh_s=cfg.autopilot_source_refresh_s,
        canary_fraction=cfg.serve_canary or 0.5,
        detector=detector, poll_s=cfg.autopilot_poll_s,
        cooldown_s=cfg.autopilot_cooldown_s,
        canary_timeout_s=cfg.autopilot_canary_timeout_s,
        max_retrains=cfg.autopilot_max_retrains,
        recovery_band=cfg.autopilot_recovery_band,
        seed=cfg.seed, ckpt_dir=cfg.checkpoint_dir or None,
        telemetry_port=cfg.telemetry_port if cfg.telemetry else None,
        device=device)
    log.info("dev flywheel: horizon=%d rows (%s shift at %d), window=%d", horizon,
             stream.schedule, stream.shift_at, cfg.autopilot_window)
    fly.start()
    try:
        summary = fly.run()
    finally:
        fly.stop()
    log.info("flywheel done: served=%d dropped=%d retrains=%d promoted=%d rolled_back=%d "
             "state=%s", summary["served"], summary["dropped"], summary["retrains"],
             summary["promoted"], summary["rolled_back"], summary["state"])


_live_workers: list = []  # the worker role's nodes in this process
_live_lock = threading.Lock()


def stop_workers() -> None:
    """Stop every worker-role node of this process (what SIGTERM and
    SIGINT do): each unregisters, its server stops and its `main` returns."""
    with _live_lock:
        nodes = list(_live_workers)
    for node in nodes:
        node.stop()


def _build_worker_row_store(cfg: Config, device: DeviceLike = None):
    """DSGD_ROW_STORE on the worker role: map the packed corpus (data/
    row_store.py) instead of building it, and with DSGD_HOST_INDEX load
    ONLY this worker's slice of the train rows (+ the
    DSGD_HOST_OVERPROVISION neighbour margin) through the store's reader.
    Returns (data, model, the worker's keyword arguments).  A store that
    is missing is built once from the corpus under DSGD_DATA_PATH; the
    train split's dim-sparsity vector comes from the store's sidecar, so
    no worker scans the corpus to build its model."""
    from distributed_sgd_tpu_torch.data import host_shard
    from distributed_sgd_tpu_torch.data.row_store import RowStore, build_from_corpus, meta_path

    if not os.path.exists(meta_path(cfg.row_store)):
        log.info("row store %s missing: building from %s (one-time parse)", cfg.row_store,
                 cfg.data_path)
        build_from_corpus(cfg.data_path, cfg.row_store, full=cfg.full, pad_width=cfg.pad_width)
    store = RowStore(cfg.row_store)
    ds = store.dim_sparsity()
    if ds is None:
        log.warning("row store has no dim-sparsity sidecar: the model falls back to the "
                    "plain l2 regularizer")
    model = make_model(cfg.model, cfg.lam, store.n_features, dim_sparsity=ds, device=device)
    n_train = store.train_rows
    if cfg.host_index is None:
        log.info("row store mapped: %d train rows resident (full split)", n_train)
        return store.read_rows(0, n_train), model, {}
    lo, hi, start, end = host_shard.overprovisioned_slice(
        n_train, cfg.host_index, cfg.node_count, overprovision=cfg.host_overprovision)
    data = host_shard.load_host_shard(store.reader, n_train, store.n_features, store.pad_width,
                                      lo, hi, labels_dtype=store.labels_dtype)
    log.info("host-local slice %d/%d loaded through the row store: rows [%d, %d) resident "
             "(nominal [%d, %d) + overprovision %g)", cfg.host_index, cfg.node_count, lo, hi,
             start, end, cfg.host_overprovision)
    return data, model, dict(data_offset=lo, row_reader=store.reader, total_rows=n_train,
                             host_overprovision=cfg.host_overprovision)


def _run_worker(cfg: Config, train: Dataset, model, extra: Optional[dict] = None) -> None:
    """The worker role: serve on DSGD_NODE_PORT and register with the
    master at DSGD_MASTER_HOST:DSGD_MASTER_PORT; answer its calls until
    SIGTERM or SIGINT (or `stop_workers`), then unregister and return.
    `extra` carries a host-local slice's arguments (_build_worker_row_store)."""
    from distributed_sgd_tpu_torch.core.worker import WorkerNode

    # an elastic deployment survives a master restart: the watch pings
    # the master and registers again when it forgets or loses this worker;
    # DSGD_HOST_DEVICES makes it one host of that many cards
    worker = WorkerNode(cfg.host, cfg.port, cfg.master_host, cfg.master_port, train, model,
                        seed=cfg.seed, profile_dir=cfg.profile_dir,
                        steps_per_dispatch=cfg.steps_per_dispatch,
                        compress=cfg.compress, compress_k=cfg.compress_k,
                        compress_ef=cfg.compress_ef,
                        gossip_topology=cfg.gossip_topology,
                        master_watch_s=(cfg.heartbeat_s or 5.0) if cfg.elastic else None,
                        telemetry=cfg.telemetry, host_devices=_resolve_host_devices(cfg),
                        **(extra or {}))
    # the warm-up races registration, not traffic
    _warmup_worker(cfg, worker)

    def _on_signal(signum, _frame):
        log.info("signal %d: stopping the worker", signum)
        threading.Thread(target=stop_workers, name="worker-stop", daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_signal)
    with _live_lock:
        _live_workers.append(worker)
    try:
        worker.start(wait_registered=False)
        worker.await_termination()
    finally:
        with _live_lock:
            _live_workers.remove(worker)


_live_serving: list = []  # the serving roles' nodes in this process


class _ServingRole:
    """One serving role's node (a replica, a fleet or a router), stopped
    once by whichever comes first: a signal (`stop_serving`) or the role's
    own exit.  `stop` runs its steps in order (the autoscaler before its
    fleet)."""

    def __init__(self, node, *before_stop):
        self.node = node
        self._steps = list(before_stop) + [node.stop]
        self._lock = threading.Lock()
        self._stopped = False

    def stop(self) -> None:
        with self._lock:
            if not self._stopped:
                self._stopped = True
                for step in self._steps:
                    step()


def stop_serving() -> None:
    """Stop every serving role of this process (what SIGTERM and SIGINT
    do): its gRPC server stops and its `main` returns."""
    with _live_lock:
        roles = list(_live_serving)
    for r in roles:
        r.stop()


def _serve_until_stopped(role: _ServingRole) -> None:
    def _on_signal(signum, _frame):
        log.info("signal %d: stopping the serving role", signum)
        threading.Thread(target=stop_serving, name="serve-stop", daemon=True).start()

    if threading.current_thread() is threading.main_thread():
        for sig in (signal.SIGTERM, signal.SIGINT):
            signal.signal(sig, _on_signal)
    with _live_lock:
        _live_serving.append(role)
    try:
        role.node.await_termination()
    finally:
        with _live_lock:
            _live_serving.remove(role)
        role.stop()


def _load_probe(cfg: Config):
    """DSGD_SERVE_PROBE -> canary probe rows (None when unset)."""
    if not cfg.serve_probe:
        return None
    from distributed_sgd_tpu_torch.serving.router import load_probe

    probe = load_probe(cfg.serve_probe)
    log.info("canary probe set: %d rows from %s", len(probe), cfg.serve_probe)
    return probe


def _run_serving(cfg: Config, role: str, device) -> None:
    """The three serving branches of the JAX CLI's `_run_role`: the router
    (with HA), the in-process fleet (with the autoscaler), and the single
    serve node."""
    if role == "route":
        # the fleet router (serving/router.py): health-aware
        # power-of-two-choices balancing over DSGD_SERVE_TARGETS, the canary
        # gate on pushed versions; host work only
        from distributed_sgd_tpu_torch.serving.push import parse_targets
        from distributed_sgd_tpu_torch.serving.router import ServingRouter

        # DSGD_AUTOPILOT: the router samples its own Predict traffic into
        # the canary probe set (autopilot/probe_source.py)
        probe_source, source_refresh_s = _autopilot_probe_source(cfg)
        router = ServingRouter(
            parse_targets(cfg.serve_targets), port=cfg.serve_port, model=cfg.model,
            lam=cfg.lam, canary_fraction=cfg.serve_canary, probe=_load_probe(cfg),
            hedge_ms=cfg.serve_hedge_ms, health_s=cfg.serve_health_s,
            telemetry_port=cfg.telemetry_port if cfg.telemetry else None,
            metrics=metrics_mod.global_metrics(), seed=cfg.seed,
            state_path=cfg.serve_state, probe_path=cfg.serve_probe,
            probe_refresh_s=cfg.serve_probe_refresh_s, probe_source=probe_source,
            probe_source_refresh_s=source_refresh_s).start()
        if cfg.serve_ha:
            # dual LIVE routers: the lease-based coordinator and its
            # promoted-state peer sync (serving/ha.py)
            from distributed_sgd_tpu_torch.serving.ha import HACoordinator

            router.attach_ha(HACoordinator.from_spec(
                cfg.serve_ha, metrics=metrics_mod.global_metrics()))
            router._ha.start()
        log.info("routing on :%d over %s (canary=%g, hedge=%gms)", router.bound_port,
                 cfg.serve_targets, cfg.serve_canary, cfg.serve_hedge_ms)
        _serve_until_stopped(_ServingRole(router))
        return
    if cfg.serve_replicas > 0:
        # the one-machine fleet (serving/fleet.py): DSGD_SERVE_REPLICAS
        # replicas on the card behind an in-process router on serve_port
        from distributed_sgd_tpu_torch.serving.fleet import ServingFleet

        fleet = ServingFleet(
            cfg.checkpoint_dir, cfg.serve_replicas, model=cfg.model, lam=cfg.lam,
            router_port=cfg.serve_port, max_batch=cfg.serve_max_batch,
            max_delay_ms=cfg.serve_max_delay_ms, queue_depth=cfg.serve_queue_depth,
            ckpt_poll_s=cfg.serve_ckpt_poll_s, canary_fraction=cfg.serve_canary,
            probe=_load_probe(cfg), hedge_ms=cfg.serve_hedge_ms,
            health_s=cfg.serve_health_s,
            telemetry_port=cfg.telemetry_port if cfg.telemetry else None,
            metrics=metrics_mod.global_metrics(),
            seed=cfg.seed, state_path=cfg.serve_state, probe_path=cfg.serve_probe,
            probe_refresh_s=cfg.serve_probe_refresh_s, device=device).start()
        before_stop = []
        if cfg.serve_slo_ms > 0:
            # DSGD_SERVE_SLO_MS: the router's load signal against the SLO
            # grows and shrinks the fleet (serving/ha.py)
            from distributed_sgd_tpu_torch.serving.ha import ReplicaAutoscaler, router_load_ms

            autoscaler = ReplicaAutoscaler(
                signal_ms=lambda: router_load_ms(fleet.router),
                scale_up=fleet.add_replica, scale_down=fleet.drain_replica,
                count=lambda: len(fleet.replicas), slo_ms=cfg.serve_slo_ms,
                min_replicas=cfg.serve_replicas, max_replicas=cfg.serve_scale_max,
                cooldown_s=cfg.serve_scale_cooldown_s,
                metrics=metrics_mod.global_metrics()).start()
            before_stop.append(autoscaler.stop)
        log.info("serving fleet: router :%d over %d in-process replicas on %s",
                 fleet.router_port, cfg.serve_replicas, device)
        _serve_until_stopped(_ServingRole(fleet, *before_stop))
        return
    # one replica (serving/server.py): the weights on the card, hot-reloaded
    # from the trainer's checkpoints
    from distributed_sgd_tpu_torch.serving.server import ServingServer

    server = ServingServer.from_config(cfg, metrics=metrics_mod.global_metrics(),
                                       device=device).start()
    log.info("serving model=%s on :%d (ckpt=%s, max_batch=%d, max_delay_ms=%g, "
             "queue_depth=%d, device=%s)", cfg.model, server.bound_port, cfg.checkpoint_dir,
             cfg.serve_max_batch, cfg.serve_max_delay_ms, cfg.serve_queue_depth, device)
    _serve_until_stopped(_ServingRole(server))


def _serve_distributor(cfg: Config):
    """DSGD_SERVE_PUSH on a training role -> a started CheckpointDistributor
    (None when unset): every checkpoint the fit writes streams to the fleet
    as a versioned weight delta (the config required checkpoint_dir)."""
    if not cfg.serve_push:
        return None
    from distributed_sgd_tpu_torch.serving.push import CheckpointDistributor, parse_targets

    log.info("checkpoint distributor on: %s -> %s", cfg.checkpoint_dir, cfg.serve_push)
    return CheckpointDistributor(cfg.checkpoint_dir, parse_targets(cfg.serve_push),
                                 metrics=metrics_mod.global_metrics()).start()


def _resource_probe(cfg: Config, role: str):
    """DSGD_RESOURCE_PROBE_S > 0: the process's resource probe thread, with
    the leak-slope sentinel on its series and, with DSGD_BLACKBOX_DIR, the
    blackbox ring (telemetry/); None when unset (no thread, no file)."""
    if cfg.resource_probe_s <= 0:
        return None
    from distributed_sgd_tpu_torch.telemetry import blackbox as blackbox_mod
    from distributed_sgd_tpu_torch.telemetry import resources, slope

    sentinel = slope.LeakSentinel(metrics=metrics_mod.global_metrics())
    box = (blackbox_mod.Blackbox(cfg.blackbox_dir, service=f"{role}-{cfg.port}")
           if cfg.blackbox_dir else None)
    probe = resources.configure(cfg.resource_probe_s, metrics=metrics_mod.global_metrics(),
                                sentinel=sentinel, blackbox=box)
    log.info("resource probe on: every %gs (blackbox=%s)", cfg.resource_probe_s,
             cfg.blackbox_dir or "off")
    return probe


def _observability(cfg: Config, role: str):
    """DSGD_TRACE / DSGD_FLIGHT_RECORDER / DSGD_RECORD wiring, as the JAX
    CLI's (distributed_sgd_tpu/main.py:420-481), before any channel or
    server exists.  Returns the started (exporter, pusher), each or None."""
    trace_dir = cfg.trace_dir or ("dsgd-traces" if cfg.trace else None)
    if cfg.trace:
        trace_mod.configure(enabled=True, dir=trace_dir, sample=cfg.trace_sample,
                            service=f"{role}-{cfg.port}")
        log.info("tracing on: sample=%g dir=%s (merge with "
                 "`python -m distributed_sgd_tpu_torch.trace.merge %s`)",
                 cfg.trace_sample, trace_dir, trace_dir)
    flight.configure(capacity=cfg.flight_recorder, service=f"{role}-{cfg.port}",
                     dir=trace_dir or ".")
    flight.install_signal_handler()
    exporter = pusher = None
    if cfg.record:
        if cfg.metrics_port is not None:
            exporter = metrics_mod.PrometheusExporter(
                metrics_mod.global_metrics(), cfg.metrics_port).start()
            log.info("metrics exporter on :%d", exporter.port)
        if cfg.influx_url:
            pusher = metrics_mod.InfluxPusher(metrics_mod.global_metrics(),
                                              cfg.influx_url).start()
            log.info("influx pusher -> %s", cfg.influx_url)
        if exporter is None and pusher is None:
            log.warning("DSGD_RECORD=1 but neither DSGD_METRICS_PORT nor "
                        "DSGD_INFLUX_URL is set: metrics are collected but not shipped")
    return exporter, pusher


def main(device: DeviceLike = None, cfg: Optional[Config] = None) -> Run:
    """Run this process's role (see the module docstring) with `cfg`
    (default: the DSGD_* environment).  Under torchrun
    (WORLD_SIZE set) the dev role joins the process group first, on
    ``cuda:LOCAL_RANK`` unless `device` is given, and leaves it at the
    end."""
    setup_logging()
    cfg = Config.from_env() if cfg is None else cfg
    role = cfg.role
    joined = role == "dev" and "WORLD_SIZE" in os.environ and not distributed()
    if joined:
        device = multihost.initialize(device=_rank_device(device))
    device = resolve_device(device)
    log.info("host: %s (%s)", socket.gethostname(), sys.platform)
    log.info("config: %s", cfg.to_json())
    log.info("role: %s", role)
    np.random.seed(cfg.seed)
    if cfg.compile_cache:
        # the spin-up fast path: every kernel library of this process is
        # built and loaded under the shared directory from here on
        from distributed_sgd_tpu_torch import compile_cache

        compile_cache.configure(cfg.compile_cache)
    exporter, pusher = _observability(cfg, role)
    probe = _resource_probe(cfg, role)
    try:
        if role in ("serve", "route"):
            _run_serving(cfg, role, device)
            return Run(fit=None, data_seconds=0.0)
        if role == "dev" and cfg.autopilot:
            # the whole train/serve flywheel in one process
            _run_dev_flywheel(cfg, device)
            return Run(fit=None, data_seconds=0.0)
        if role in ("master", "worker"):
            _install_chaos(cfg)
        t0 = time.perf_counter()
        if role == "worker" and cfg.row_store:
            if cfg.host_index is not None and _resolve_host_devices(cfg) > 1:
                raise ValueError(
                    "DSGD_HOST_INDEX with a multi-device in-host mesh is "
                    "not supported (the mesh binds its slice at build "
                    "time); set DSGD_HOST_DEVICES=1")
            train, model, extra = _build_worker_row_store(cfg, device)
            data_s = time.perf_counter() - t0
            log.info("data mapped: %d rows resident in %.2fs", len(train), data_s)
            _run_worker(cfg, train, model, extra)
            return Run(fit=None, data_seconds=data_s)
        if role == "master" and cfg.autopilot:
            # the stream plane: the newest window, eval at its trailing edge
            train, test, model = _autopilot_stream_build(cfg, device)
        else:
            train, test, model = build(cfg, device)
        data_s = time.perf_counter() - t0
        log.info("data loaded: %d train + %d test rows in %.2fs", len(train), len(test),
                 data_s)
        if role == "worker":
            _run_worker(cfg, train, model)
            return Run(fit=None, data_seconds=data_s)
        distributor = _serve_distributor(cfg)
        try:
            if role == "master":
                fit = _run_master(cfg, train, test, model)
            elif cfg.engine == "rpc":
                fit = scenario_rpc(cfg, train, test, model)
            else:
                fit = scenario_mesh(cfg, train, test, model, device)
        finally:
            if distributor is not None:
                # its final sweep ships the checkpoint the fit wrote last
                distributor.stop()
        return Run(fit=fit, data_seconds=data_s)
    except Exception:
        # an uncaught exception leaves flight-recorder evidence
        flight.dump("exception")
        raise
    finally:
        # flush and stop on every exit path: a crashed run's tail metrics
        # and trace are the ones that matter
        if joined:
            dist.destroy_process_group()
        trace_mod.flush()
        if probe is not None:
            probe.stop()
        if exporter is not None:
            exporter.stop()
        if pusher is not None:
            pusher.stop()


if __name__ == "__main__":
    main()
