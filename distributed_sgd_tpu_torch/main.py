"""Application entry point: config-driven role selection and scenario.

The port of the JAX package's CLI (distributed_sgd_tpu/main.py, after the
reference's Main.scala): no flags, DSGD_* env config (config.py).  The
role (config.py ``Config.role``) picks what runs:

- dev (DSGD_MASTER_HOST/PORT unset): load RCV1 (or synthetic RCV1-shaped
  rows with DSGD_SYNTHETIC=<n>), split 80/20, build the model with the
  train split's dim-sparsity regularizer, and fit, early-stopping on the
  test loss.  With DSGD_ENGINE=mesh (the default) the fit is the sync
  engine with K virtual workers, or with DSGD_ASYNC=1 the Hogwild gossip
  engine (DSGD_ASYNC_MODE=gossip) or local SGD (local_sgd).  With
  DSGD_ENGINE=rpc it is the fit of an in-process gRPC cluster
  (core/cluster.py: a master and DSGD_NODE_COUNT workers on loopback):
  the sync fit, or with DSGD_ASYNC=1 the async fit (Hogwild gossip
  between the workers, DSGD_STEPS_PER_DISPATCH local steps a dispatch,
  DSGD_GOSSIP_TOPOLOGY, DSGD_ASYNC_DRAIN);
- master (DSGD_MASTER_HOST/PORT equal DSGD_NODE_HOST/PORT): load the
  data, serve on DSGD_NODE_PORT, wait for DSGD_NODE_COUNT workers, run
  the sync fit (or with DSGD_ASYNC=1 the async one) and exit;
- worker (any other DSGD_MASTER_HOST/PORT): load the data, serve on
  DSGD_NODE_PORT, register with the master and answer its calls
  (Gradient and Forward; StartAsync, UpdateGrad and StopAsync, with
  DSGD_STEPS_PER_DISPATCH and DSGD_GOSSIP_TOPOLOGY) until SIGTERM.

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
when an elastic resplit moves it.

Every engine takes DSGD_OPTIMIZER (sgd | momentum | adam) with
DSGD_MOMENTUM.  DSGD_CHECKPOINT_DIR saves and resumes every fit
(checkpoint.py), DSGD_PROFILE_DIR writes a torch.profiler trace of one
sync epoch (or, on the worker role, of its first dispatches).  DSGD_TRACE
writes per-process span timelines under DSGD_TRACE_DIR (merge them with
``python -m distributed_sgd_tpu_torch.trace.merge``), DSGD_FLIGHT_RECORDER
sizes the post-mortem ring (SIGUSR2 dumps it), and DSGD_RECORD ships the
metrics registry to DSGD_METRICS_PORT (Prometheus) and/or
DSGD_INFLUX_URL.

Run: ``python -m distributed_sgd_tpu_torch``
"""

from __future__ import annotations

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
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device, world_size
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
    """Dev-mode scenario on one device: the sync trainer, or an async
    engine with DSGD_ASYNC=1."""
    n, virtual = select_topology(
        cfg.node_count, world_size(), cfg.use_async,
        cfg.virtual_workers, cfg.exact_topology)
    criterion = no_improvement(patience=cfg.patience, min_delta=cfg.conv_delta)
    warn_mesh_ignored(cfg)
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


def warn_mesh_ignored(cfg: Config) -> None:
    """The JAX mesh scenario's warnings (distributed_sgd_tpu/main.py:
    152-206), in its words, for the settings of the rpc topology that the
    in-process engines ignore.  The JAX scenario also warns about
    DSGD_CHAOS, DSGD_TELEMETRY, DSGD_HEALTH_ACTION and DSGD_HOST_DEVICES
    > 1, which the port refuses in every role (config.py)."""
    if (cfg.local_steps > 1 or cfg.delta_broadcast or cfg.stream
            or cfg.fanin_lanes or cfg.stage_pool or cfg.agg_tree
            or cfg.master_shards):
        log.warning(
            "DSGD_LOCAL_STEPS/DSGD_DELTA_BROADCAST/DSGD_STREAM/"
            "DSGD_FANIN_LANES/DSGD_STAGE_POOL/DSGD_AGG_TREE/"
            "DSGD_MASTER_SHARDS ignored: the pipelined sync engine is "
            "the rpc topology's (use engine=rpc; the mesh local-SGD "
            "equivalent is async_mode=local_sgd / sync_period)")
    if cfg.quorum is not None:
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
    if cfg.host_devices != 1:
        log.warning(
            "DSGD_HOST_DEVICES ignored: the mesh engine already spans "
            "every device — the hierarchical in-host layer is the rpc "
            "topology's (use engine=rpc; docs/HIERARCHY.md)")


def _fit_state_args(cfg: Config) -> dict:
    """DSGD_FIT_CKPT_EVERY -> fit_sync's crash-safe fit-state arguments,
    empty when it is off (the config checked that DSGD_CHECKPOINT_DIR is
    set).  (The JAX CLI also passes the path for DSGD_HEALTH_ACTION, which
    the port refuses.)"""
    if not cfg.fit_ckpt_every or not cfg.checkpoint_dir:
        return {}
    return {"fit_state_path": fit_state_path(cfg.checkpoint_dir),
            "fit_state_every": cfg.fit_ckpt_every}


def _rpc_fit(cfg: Config, master) -> FitResult:
    """The master's fit: the async one with DSGD_ASYNC=1, else the sync
    one, with the JAX CLI's arguments."""
    criterion = no_improvement(patience=cfg.patience, min_delta=cfg.conv_delta)
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
        quorum=cfg.quorum, straggler_soft_s=cfg.straggler_soft_s, **_fit_state_args(cfg))


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
                    gossip_topology=cfg.gossip_topology, heartbeat_s=cfg.heartbeat_s,
                    heartbeat_max_misses=cfg.heartbeat_max_misses) as c:
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
        master.await_ready()
        res = _rpc_fit(cfg, master)
        _finish(res, evaluator=lambda w: master.local_loss(w, test=True))
    finally:
        master.stop()
    return res


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
    # the master and registers again when it forgets or loses this worker
    worker = WorkerNode(cfg.host, cfg.port, cfg.master_host, cfg.master_port, train, model,
                        seed=cfg.seed, profile_dir=cfg.profile_dir,
                        steps_per_dispatch=cfg.steps_per_dispatch,
                        gossip_topology=cfg.gossip_topology,
                        master_watch_s=(cfg.heartbeat_s or 5.0) if cfg.elastic else None,
                        **(extra or {}))

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
    (default: the DSGD_* environment).  Every setting the port does not
    serve in that role raises before any data loads."""
    device = resolve_device(device)
    setup_logging()
    cfg = Config.from_env() if cfg is None else cfg
    role = cfg.role
    cfg.refuse_for_role()
    log.info("host: %s (%s)", socket.gethostname(), sys.platform)
    log.info("config: %s", cfg.to_json())
    log.info("role: %s", role)
    np.random.seed(cfg.seed)
    exporter, pusher = _observability(cfg, role)
    try:
        t0 = time.perf_counter()
        if role == "worker" and cfg.row_store:
            train, model, extra = _build_worker_row_store(cfg, device)
            data_s = time.perf_counter() - t0
            log.info("data mapped: %d rows resident in %.2fs", len(train), data_s)
            _run_worker(cfg, train, model, extra)
            return Run(fit=None, data_seconds=data_s)
        train, test, model = build(cfg, device)
        data_s = time.perf_counter() - t0
        log.info("data loaded: %d train + %d test rows in %.2fs", len(train), len(test),
                 data_s)
        if role == "worker":
            _run_worker(cfg, train, model)
            return Run(fit=None, data_seconds=data_s)
        if role == "master":
            return Run(fit=_run_master(cfg, train, test, model), data_seconds=data_s)
        if cfg.engine == "rpc":
            return Run(fit=scenario_rpc(cfg, train, test, model), data_seconds=data_s)
        return Run(fit=scenario_mesh(cfg, train, test, model, device), data_seconds=data_s)
    except Exception:
        # an uncaught exception leaves flight-recorder evidence
        flight.dump("exception")
        raise
    finally:
        # flush and stop on every exit path: a crashed run's tail metrics
        # and trace are the ones that matter
        trace_mod.flush()
        if exporter is not None:
            exporter.stop()
        if pusher is not None:
            pusher.stop()


if __name__ == "__main__":
    main()
