"""Typed configuration with ``DSGD_*`` environment overrides.

The fields of the JAX package's Config (distributed_sgd_tpu/config.py)
that the port reads, under the same ``DSGD_*`` names and with the same
defaults.

Role selection follows the reference (Main.scala:122-159) as the JAX
package does: with ``DSGD_MASTER_HOST``/``DSGD_MASTER_PORT`` unset the
process runs the dev role; when they equal the node's own
``DSGD_NODE_HOST``/``DSGD_NODE_PORT`` it is the master; otherwise a
worker.  ``DSGD_ROLE`` overrides the derivation.  The dev role runs the
in-process engines (``engine='mesh'``: the sync trainer, or with
``use_async`` the Hogwild gossip or local SGD) or the in-process gRPC
cluster (``engine='rpc'``, the sync fit, or with ``use_async`` the async
fit over RPC, ``async_drain`` its batch-drain inbox).  ``optimizer`` ('sgd',
'momentum' or 'adam') and ``momentum`` reach every engine,
``checkpoint_dir`` (with ``checkpoint_every``) every engine and
``profile_dir`` the sync trainer and the worker role.  On the rpc fits
``heartbeat_s`` (with ``heartbeat_max_misses``) starts the master's
heartbeat, ``quorum`` and ``straggler_soft_s`` the sync fit's quorum
barrier, ``fit_ckpt_every`` its crash-safe fit state under
``checkpoint_dir``, and ``elastic`` the async fit's elastic membership and,
on the worker role, the watch of the master.  The sync fit takes the
pipelined levers ``local_steps``, ``delta_broadcast``, ``stream``,
``fanin_lanes`` and ``stage_pool``; the worker role maps ``row_store``
(data/row_store.py) and with ``host_index`` loads only its slice of the
train rows, widened by ``host_overprovision``.  ``trace``,
``trace_dir``, ``trace_sample``, ``flight_recorder``, ``record``,
``metrics_port`` and ``influx_url`` drive the observability planes
(main.py).

Settings that change what the JAX CLI does but are not ported are read
and refused with NotImplementedError before any data is loaded: here the
ones the JAX CLI acts on in every role, and in `refuse_for_role` the ones
it acts on in the rpc roles only (on the mesh engine main.py warns about
them, as the JAX mesh scenario does).  ``DSGD_KERNEL`` and
``DSGD_SCATTER`` are not read: in the JAX package they pick among XLA
formulations of the same function, so ignoring them changes no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

from distributed_sgd_tpu_torch.parallel.topology import parse_topology


def _env(name: str, default, cast):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return cast(raw)


def _not_ported(setting: str, where: str) -> NotImplementedError:
    return NotImplementedError(f"{setting}: not ported yet (ROADMAP.md Queue A {where})")


@dataclass
class Config:
    host: str = "127.0.0.1"
    port: int = 4000
    master_host: Optional[str] = None
    master_port: Optional[int] = None
    role_override: Optional[str] = None  # DSGD_ROLE
    batch_size: int = 100
    learning_rate: float = 0.5
    lam: float = 1e-5  # `lambda` in the reference; keyword in Python
    node_count: int = 3
    full: bool = False
    use_async: bool = False  # `async` in the reference; keyword in Python
    data_path: str = "data"
    max_epochs: int = 10
    conv_delta: float = 0.01
    patience: int = 5
    model: str = "hinge"  # hinge | svm | logistic | least_squares
    seed: int = 0
    pad_width: Optional[int] = None  # sparse-batch nnz padding (None = auto)
    virtual_workers: int = 1  # reference workers emulated per card
    exact_topology: bool = False  # insist on exactly node_count workers
    engine: str = "mesh"
    optimizer: str = "sgd"  # sgd (reference) | momentum | adam
    momentum: float = 0.9  # used by optimizer='momentum'
    # async (use_async): the loss checker, the local SGD period, the gossip
    check_every: int = 100
    leaky_loss: float = 0.9
    async_mode: str = "gossip"  # gossip | local_sgd
    sync_period: int = 16  # local-SGD averaging period (steps)
    steps_per_dispatch: int = 1  # gossip: k local steps per dispatch
    gossip_topology: str = "all"  # all | ring | random:k
    checkpoint_dir: Optional[str] = None  # snapshots: checkpoint.Checkpointer
    checkpoint_every: int = 1  # sync: epochs between snapshots
    profile_dir: Optional[str] = None  # sync: the trace of one epoch
    # observability (trace/, utils/metrics.py)
    record: bool = False  # ship metrics (with metrics_port and/or influx_url)
    metrics_port: Optional[int] = None
    influx_url: Optional[str] = None
    trace: bool = False
    trace_dir: Optional[str] = None
    trace_sample: float = 1.0
    flight_recorder: int = 512
    # the rpc engine's fault tolerance (core/master.py, core/worker.py)
    heartbeat_s: Optional[float] = None  # the master's probe period
    heartbeat_max_misses: int = 3  # misses in a row before an eviction
    quorum: Optional[int] = None  # the sync fit's quorum barrier
    straggler_soft_s: Optional[float] = None  # its soft deadline (None: adaptive)
    elastic: bool = False  # elastic async membership; the worker's master watch
    fit_ckpt_every: int = 0  # windows between crash-safe fit-state snapshots
    # the sync fit's pipelined levers (core/master.py fit_sync)
    local_steps: int = 1  # K local SGD steps a worker a round
    delta_broadcast: bool = False  # versioned sparse weight broadcasts
    stream: bool = False  # one persistent FitStream a worker
    fanin_lanes: int = 0  # the fan-in's decode lanes (0: one lock)
    stage_pool: int = 0  # threads staging the next round (0: none)
    async_drain: bool = False
    # worker-local rows (the worker role; data/row_store.py, host_shard.py)
    row_store: Optional[str] = None  # the packed corpus to map
    host_index: Optional[int] = None  # this worker's slot in the split
    host_overprovision: float = 0.0  # neighbour rows loaded, a fraction a side
    # read so that none is ignored without a word; each raises (or, on the
    # mesh engine, warns) when set
    compress: str = "none"  # none | topk | qint8
    feature_shards: int = 1
    agg_tree: str = ""
    master_shards: int = 0
    host_devices: int = 1
    chaos: Optional[str] = None
    telemetry: bool = False
    health_action: Optional[str] = None
    resource_probe_s: float = 0.0
    blackbox_dir: Optional[str] = None
    autopilot: bool = False
    serve_push: Optional[str] = None

    def __post_init__(self):
        if self.engine not in ("mesh", "rpc"):
            raise ValueError(f"DSGD_ENGINE={self.engine!r} must be 'mesh' or 'rpc'")
        if self.role_override not in (None, "dev", "master", "worker", "serve", "route"):
            raise ValueError(f"DSGD_ROLE={self.role_override!r} must be one of "
                             f"dev | master | worker | serve | route")
        if self.role_override in ("serve", "route"):
            raise _not_ported(f"DSGD_ROLE={self.role_override}", "[A12], serving/")
        if self.serve_push:
            raise _not_ported("DSGD_SERVE_PUSH", "[A12], serving/push.py")
        for bad, setting in ((self.autopilot, "DSGD_AUTOPILOT"),
                             (self.chaos, "DSGD_CHAOS"),
                             (self.telemetry, "DSGD_TELEMETRY"),
                             (self.health_action, "DSGD_HEALTH_ACTION"),
                             (self.resource_probe_s > 0, "DSGD_RESOURCE_PROBE_S > 0"),
                             (self.blackbox_dir, "DSGD_BLACKBOX_DIR")):
            if bad:
                raise _not_ported(setting, "[A13], item 2 (telemetry/) and item 8")
        if self.host_devices < 0:
            raise ValueError("host_devices must be >= 0")
        if self.host_devices > 1:
            raise _not_ported(f"DSGD_HOST_DEVICES={self.host_devices}",
                              "[A10], torch.distributed")
        if not 0.0 <= self.trace_sample <= 1.0:
            raise ValueError("trace_sample must be a probability in [0, 1]")
        if self.flight_recorder < 0:
            raise ValueError("flight_recorder must be >= 0 (0 disables)")
        if self.async_mode not in ("gossip", "local_sgd"):
            raise ValueError(
                f"config field async_mode={self.async_mode!r} must be 'gossip' or 'local_sgd'")
        if self.model not in ("hinge", "svm", "logistic", "least_squares"):
            raise ValueError(f"config field model={self.model!r} is not a known model")
        if self.compress not in ("none", "topk", "qint8"):
            raise ValueError(
                f"config field compress={self.compress!r} must be 'none', 'topk' or 'qint8'")
        if self.compress != "none":
            raise NotImplementedError(
                f"DSGD_COMPRESS={self.compress}: gossip compression is not ported yet "
                f"(ROADMAP.md Queue A 13: compress/)")
        if self.feature_shards < 1:
            raise ValueError("feature_shards must be >= 1")
        if self.feature_shards > 1:
            raise NotImplementedError(
                f"DSGD_FEATURE_SHARDS={self.feature_shards}: the dp x tp engine is not "
                f"ported yet (ROADMAP.md Queue A 11: parallel/feature_sharded.py)")
        parse_topology(self.gossip_topology)
        for name in ("checkpoint_every", "steps_per_dispatch", "sync_period"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1")
        if not 0.0 <= self.leaky_loss <= 1.0:
            raise ValueError("leaky_loss must be between 0 and 1")
        if self.optimizer not in ("sgd", "momentum", "adam"):
            raise ValueError(
                f"config field optimizer={self.optimizer!r} must be 'sgd', "
                f"'momentum' or 'adam'")
        if self.virtual_workers < 1:
            raise ValueError("virtual_workers must be >= 1")
        if self.seed < 0:
            raise ValueError("seed must be >= 0")
        if self.heartbeat_max_misses < 1:
            raise ValueError("heartbeat_max_misses must be >= 1")
        if self.quorum is not None and self.quorum < 1:
            raise ValueError("quorum must be >= 1 (or unset for a full barrier)")
        if self.straggler_soft_s is not None and self.straggler_soft_s <= 0:
            raise ValueError("straggler_soft_s must be > 0 (or unset for adaptive)")
        if self.fit_ckpt_every < 0:
            raise ValueError("fit_ckpt_every must be >= 0 (0 disables)")
        if self.fit_ckpt_every > 0 and not self.checkpoint_dir:
            raise ValueError("DSGD_FIT_CKPT_EVERY needs DSGD_CHECKPOINT_DIR: the crash "
                             "snapshot lives under the checkpoint directory")
        if self.local_steps < 1:
            raise ValueError("local_steps must be >= 1")
        if self.master_shards < 0:
            raise ValueError(f"DSGD_MASTER_SHARDS must be an integer >= 0, got "
                             f"{self.master_shards!r}")
        if self.master_shards:
            # the JAX config's composition matrix, at construction
            for bad, knob in ((self.stream, "DSGD_STREAM"),
                              (self.quorum is not None, "DSGD_QUORUM"),
                              (self.local_steps > 1, "DSGD_LOCAL_STEPS"),
                              (self.fanin_lanes > 0, "DSGD_FANIN_LANES"),
                              (self.stage_pool > 0, "DSGD_STAGE_POOL"),
                              (self.compress != "none", "DSGD_COMPRESS")):
                if bad:
                    raise ValueError(f"DSGD_MASTER_SHARDS does not compose with {knob} "
                                     f"(docs/MASTER_SHARDING.md composition table)")
        if self.fanin_lanes < 0:
            raise ValueError("DSGD_FANIN_LANES must be >= 0 (0 = decode after the "
                             "barrier; K shards the decode into K lanes)")
        if self.stage_pool < 0:
            raise ValueError("DSGD_STAGE_POOL must be >= 0 (0 = draws and request builds "
                             "on the dispatch path; P stages them on a P-thread pool "
                             "during the previous barrier)")
        if not 0.0 <= self.host_overprovision <= 1.0:
            raise ValueError("DSGD_HOST_OVERPROVISION must be a fraction in [0, 1] "
                             "(0 = exact slices; f loads ceil(f * slice) neighbor rows "
                             "on each side)")
        if self.host_index is not None:
            if not self.row_store:
                raise ValueError("DSGD_HOST_INDEX needs DSGD_ROW_STORE: a host-local "
                                 "slice is loaded through the store's row reader (the "
                                 "full-parse path always materializes the corpus)")
            if not 0 <= self.host_index < self.node_count:
                raise ValueError(f"DSGD_HOST_INDEX={self.host_index} outside "
                                 f"[0, node_count={self.node_count})")

    @classmethod
    def from_env(cls, **overrides) -> "Config":
        """Build from DSGD_* env vars."""
        cfg = cls(
            host=_env("DSGD_NODE_HOST", cls.host, str),
            port=_env("DSGD_NODE_PORT", cls.port, int),
            master_host=_env("DSGD_MASTER_HOST", None, str),
            master_port=_env("DSGD_MASTER_PORT", None, int),
            role_override=_env("DSGD_ROLE", None, str),
            batch_size=_env("DSGD_BATCH_SIZE", cls.batch_size, int),
            learning_rate=_env("DSGD_LEARNING_RATE", cls.learning_rate, float),
            lam=_env("DSGD_LAMBDA", cls.lam, float),
            node_count=_env("DSGD_NODE_COUNT", cls.node_count, int),
            full=_env("DSGD_FULL", cls.full, bool),
            use_async=_env("DSGD_ASYNC", cls.use_async, bool),
            data_path=_env("DSGD_DATA_PATH", cls.data_path, str),
            max_epochs=_env("DSGD_MAX_EPOCHS", cls.max_epochs, int),
            conv_delta=_env("DSGD_CONV_DELTA", cls.conv_delta, float),
            patience=_env("DSGD_PATIENCE", cls.patience, int),
            model=_env("DSGD_MODEL", cls.model, str),
            seed=_env("DSGD_SEED", cls.seed, int),
            pad_width=_env("DSGD_PAD_WIDTH", None, int),
            virtual_workers=_env("DSGD_VIRTUAL_WORKERS", cls.virtual_workers, int),
            exact_topology=_env("DSGD_EXACT_TOPOLOGY", cls.exact_topology, bool),
            engine=_env("DSGD_ENGINE", cls.engine, str),
            optimizer=_env("DSGD_OPTIMIZER", cls.optimizer, str),
            momentum=_env("DSGD_MOMENTUM", cls.momentum, float),
            check_every=_env("DSGD_CHECK_EVERY", cls.check_every, int),
            leaky_loss=_env("DSGD_LEAKY_LOSS", cls.leaky_loss, float),
            async_mode=_env("DSGD_ASYNC_MODE", cls.async_mode, str),
            sync_period=_env("DSGD_SYNC_PERIOD", cls.sync_period, int),
            steps_per_dispatch=_env("DSGD_STEPS_PER_DISPATCH", cls.steps_per_dispatch, int),
            gossip_topology=_env("DSGD_GOSSIP_TOPOLOGY", cls.gossip_topology, str),
            compress=_env("DSGD_COMPRESS", cls.compress, str),
            checkpoint_dir=_env("DSGD_CHECKPOINT_DIR", None, str),
            checkpoint_every=_env("DSGD_CHECKPOINT_EVERY", cls.checkpoint_every, int),
            profile_dir=_env("DSGD_PROFILE_DIR", None, str),
            feature_shards=_env("DSGD_FEATURE_SHARDS", cls.feature_shards, int),
            record=_env("DSGD_RECORD", cls.record, bool),
            metrics_port=_env("DSGD_METRICS_PORT", None, int),
            influx_url=_env("DSGD_INFLUX_URL", None, str),
            trace=_env("DSGD_TRACE", cls.trace, bool),
            trace_dir=_env("DSGD_TRACE_DIR", None, str),
            trace_sample=_env("DSGD_TRACE_SAMPLE", cls.trace_sample, float),
            flight_recorder=_env("DSGD_FLIGHT_RECORDER", cls.flight_recorder, int),
            heartbeat_s=_env("DSGD_HEARTBEAT_S", None, float),
            heartbeat_max_misses=_env("DSGD_HEARTBEAT_MAX_MISSES", cls.heartbeat_max_misses,
                                      int),
            quorum=_env("DSGD_QUORUM", None, int),
            straggler_soft_s=_env("DSGD_STRAGGLER_SOFT_S", None, float),
            local_steps=_env("DSGD_LOCAL_STEPS", cls.local_steps, int),
            delta_broadcast=_env("DSGD_DELTA_BROADCAST", cls.delta_broadcast, bool),
            stream=_env("DSGD_STREAM", cls.stream, bool),
            fanin_lanes=_env("DSGD_FANIN_LANES", cls.fanin_lanes, int),
            stage_pool=_env("DSGD_STAGE_POOL", cls.stage_pool, int),
            agg_tree=_env("DSGD_AGG_TREE", cls.agg_tree, str),
            master_shards=_env("DSGD_MASTER_SHARDS", cls.master_shards, int),
            elastic=_env("DSGD_ELASTIC", cls.elastic, bool),
            async_drain=_env("DSGD_ASYNC_DRAIN", cls.async_drain, bool),
            fit_ckpt_every=_env("DSGD_FIT_CKPT_EVERY", cls.fit_ckpt_every, int),
            host_devices=_env("DSGD_HOST_DEVICES", cls.host_devices, int),
            row_store=_env("DSGD_ROW_STORE", None, str),
            host_index=_env("DSGD_HOST_INDEX", None, int),
            host_overprovision=_env("DSGD_HOST_OVERPROVISION", cls.host_overprovision,
                                    float),
            chaos=_env("DSGD_CHAOS", None, str),
            telemetry=_env("DSGD_TELEMETRY", cls.telemetry, bool),
            health_action=_env("DSGD_HEALTH_ACTION", None, str),
            resource_probe_s=_env("DSGD_RESOURCE_PROBE_S", cls.resource_probe_s, float),
            blackbox_dir=_env("DSGD_BLACKBOX_DIR", None, str),
            autopilot=_env("DSGD_AUTOPILOT", cls.autopilot, bool),
            serve_push=_env("DSGD_SERVE_PUSH", None, str),
        )
        return dataclasses.replace(cfg, **overrides)

    @property
    def role(self) -> str:
        """'dev' | 'master' | 'worker' per Main.scala:122-159, or DSGD_ROLE."""
        if self.role_override is not None:
            return self.role_override
        if self.master_host is None or self.master_port is None:
            return "dev"
        if (self.master_host, self.master_port) == (self.host, self.port):
            return "master"
        return "worker"

    def refuse_for_role(self) -> None:
        """Raise NotImplementedError for a setting the JAX CLI acts on in
        this run's role that the port does not serve yet: on the rpc fits
        (the dev role with engine 'rpc', and the master) the aggregation
        tree and the sharded master.  The mesh engine and the worker role
        ignore them (main.py warns on the mesh engine, as the JAX CLI
        does)."""
        role = self.role
        if role == "worker" or (role == "dev" and self.engine == "mesh"):
            return
        for bad, setting, where in (
                (self.agg_tree, "DSGD_AGG_TREE", "[A13] item 8, aggtree/"),
                (self.master_shards, "DSGD_MASTER_SHARDS", "[A13] item 8, shardedps/")):
            if bad:
                raise _not_ported(f"{setting} on the {role} role", where)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)
