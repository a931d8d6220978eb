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
``fanin_lanes`` and ``stage_pool``, the aggregation tree ``agg_tree``
and the sharded master ``master_shards``; the worker role maps ``row_store``
(data/row_store.py) and with ``host_index`` loads only its slice of the
train rows, widened by ``host_overprovision``.  ``host_devices`` (D > 1;
0 sizes it from the host's cards) makes a worker one host of D devices
(parallel/hier.py), and ``feature_shards`` (F > 1) routes the dev role's
sync fit to the dp x tp engine over the process group
(parallel/feature_sharded.py).  ``trace``,
``trace_dir``, ``trace_sample``, ``flight_recorder``, ``record``,
``metrics_port`` and ``influx_url`` drive the observability planes
(main.py), ``resource_probe_s`` (with ``blackbox_dir``) the resource probe
in every role, and ``telemetry`` (with ``telemetry_port``) the cluster
telemetry scrape in every role: the master's and the router's merged
``/metrics`` endpoint, the workers' health gauges.  ``health_action``
('warn' | 'snapshot' | 'halt') puts the training-health monitor on the
rpc sync fit (telemetry/health.py; the last two need ``checkpoint_dir``).
``compress`` ('topk' | 'qint8', with ``compress_k`` and ``compress_ef``)
encodes the gradients that cross a wire: the Hogwild gossip, the rpc
workers' sync replies and async gossip.  ``DSGD_ROLE=serve``
runs a serving replica (or, with ``serve_replicas``, an in-process fleet)
and ``DSGD_ROLE=route`` the fleet router; the ``serve_*`` fields are the
JAX Config's, with its defaults and validation, and ``serve_push``
streams a training role's checkpoints to the fleet.  ``chaos``
(DSGD_CHAOS, a plan or ``scenario:NAME``, parsed here by chaos/
``parse_plan`` so a typo stops the run before any data loads) injects
faults into every RPC channel of the master and worker roles and of the
dev rpc cluster; ``compile_cache`` (DSGD_COMPILE_CACHE) shares the
kernels' build directory between processes and warms each role's
kernels in the background (compile_cache.py); ``autopilot``
(DSGD_AUTOPILOT, with the 13 ``autopilot_*`` knobs, validated whether or
not it is set) runs the continual-learning flywheel in the dev role,
sources the route role's canary probes from live traffic and trains the
master role on the drifting stream's window (autopilot/).

Every setting of the JAX CLI is read and acted on, or warned about where
the JAX CLI warns (main.py: the mesh engine and the rpc topology's
settings), except ``DSGD_KERNEL`` and ``DSGD_SCATTER``: in the JAX
package they pick among XLA formulations of the same function, so
ignoring them changes no result.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

from distributed_sgd_tpu_torch.aggtree.plan import parse_agg_tree
from distributed_sgd_tpu_torch.parallel.topology import parse_topology
from distributed_sgd_tpu_torch.shardedps.plan import parse_master_shards


def _env(name: str, default, cast):
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    if cast is bool:
        return raw.strip().lower() in ("1", "true", "yes", "on")
    return cast(raw)


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
    feature_shards: int = 1  # F > 1: the dp x tp engine (mesh, sync, sgd)
    host_devices: int = 1  # a worker host's devices (0: the host's cards)
    # gradient compression on the wire paths (compress/): 'none' keeps every
    # send byte-identical to the uncompressed wire
    compress: str = "none"  # none | topk | qint8
    compress_k: float = 0.01  # topk size: fraction of dim if < 1, count if >= 1
    compress_ef: bool = True  # error-feedback residual accumulation
    agg_tree: str = ""
    master_shards: int = 0
    # fault injection on the rpc wire (chaos/): a plan or scenario:NAME
    chaos: Optional[str] = None
    # the spin-up fast path (compile_cache.py): the kernels' shared build
    # directory and the background warm-up.  None: libraries in _build/,
    # no warm-up thread, no instrument
    compile_cache: Optional[str] = None
    # the cluster telemetry plane (telemetry/aggregate.py): the master (or
    # router) scrapes its members' registries over the Metrics RPC and
    # serves the merged view on telemetry_port (0: OS-assigned); workers
    # publish their health gauges.  Off: no Metrics RPC is ever sent
    telemetry: bool = False
    telemetry_port: int = 9091
    # the rpc sync fit's training-health monitor (telemetry/health.py):
    # None = no observation; warn | snapshot | halt on a trip
    health_action: Optional[str] = None
    # the continual-learning autopilot (autopilot/), the JAX Config's knobs
    # and defaults: the dev role runs the flywheel, the route role sources
    # its probes from live traffic, the master role trains on the stream's
    # window; the serve and worker roles refuse it
    autopilot: bool = False
    autopilot_poll_s: float = 1.0  # controller probe-loss poll period
    autopilot_cooldown_s: float = 5.0  # post-verdict settle before re-arming
    autopilot_drift_ratio: float = 1.5  # EWMA > max(ratio x baseline, ...
    autopilot_drift_patience: int = 2  # ... baseline + floor) this many refreshes
    autopilot_drift_warmup: int = 4  # refreshes that set the baseline
    autopilot_drift_floor: float = 0.1
    autopilot_window: int = 4096  # the newest stream rows a retrain fits
    autopilot_max_retrains: int = 0  # 0 = unbounded
    autopilot_canary_timeout_s: float = 120.0  # verdict wait before giving up
    autopilot_recovery_band: float = 1.35  # residual settling (0 disables)
    autopilot_probe_capacity: int = 64  # the probe reservoir's rows
    autopilot_label_delay: int = 0  # requests before a row's truth arrives
    autopilot_source_refresh_s: float = 2.0  # reservoir -> probe set cadence
    # the resource plane (telemetry/): the probe's period (0: no probe) and
    # the blackbox ring's directory, which needs the probe
    resource_probe_s: float = 0.0
    blackbox_dir: Optional[str] = None
    # serving (serving/): the replica, the fleet and the router
    serve_port: int = 4100  # gRPC dsgd.Serving bind port (replica OR router)
    serve_max_batch: int = 64  # micro-batch flush size cap
    serve_max_delay_ms: float = 5.0  # coalescing window from oldest queued row
    serve_queue_depth: int = 256  # admission bound -> RESOURCE_EXHAUSTED
    serve_ckpt_poll_s: float = 2.0  # checkpoint hot-reload poll period
    serve_replicas: int = 0  # role=serve: N in-process replicas + a router (0: one node)
    serve_targets: Optional[str] = None  # role=route: 'host:port,...' replicas
    serve_push: Optional[str] = None  # training roles: fleet endpoints to push to
    serve_canary: float = 0.0  # fleet fraction a pushed version lands on first
    serve_probe: Optional[str] = None  # the canary's held-out probe set (.npz)
    serve_hedge_ms: float = 0.0  # a routed Predict slower than this is hedged (0: never)
    serve_health_s: float = 1.0  # router ServeHealth poll period
    serve_state: Optional[str] = None  # the router's promoted-state sidecar (JSON)
    serve_probe_refresh_s: float = 0.0  # re-read the probe file this often (0: never)
    serve_ha: Optional[str] = None  # 'peers:<host:port,...>[;self=..][;sync=..][;ttl=..]'
    serve_slo_ms: float = 0.0  # the fleet autoscaler's SLO (0: fixed fleet size)
    serve_scale_max: int = 8  # autoscale ceiling (the boot size is the floor)
    serve_scale_cooldown_s: float = 5.0  # dead time after every autoscale action

    def __post_init__(self):
        if self.engine not in ("mesh", "rpc"):
            raise ValueError(f"DSGD_ENGINE={self.engine!r} must be 'mesh' or 'rpc'")
        if self.role_override not in (None, "dev", "master", "worker", "serve", "route"):
            raise ValueError(f"DSGD_ROLE={self.role_override!r} must be one of "
                             f"dev | master | worker | serve | route")
        if self.chaos:
            # a typo fails here, not mid-fit: the grammar is chaos/'s
            from distributed_sgd_tpu_torch.chaos import parse_plan

            parse_plan(self.chaos)
        self._check_autopilot()
        if self.telemetry_port < 0:
            raise ValueError("telemetry_port must be >= 0 (0 = OS-assigned)")
        if self.health_action not in (None, "warn", "snapshot", "halt"):
            raise ValueError(
                f"DSGD_HEALTH_ACTION={self.health_action!r} must be one of "
                f"warn | snapshot | halt (unset = no health monitor)")
        if self.health_action in ("snapshot", "halt") and not self.checkpoint_dir:
            raise ValueError(
                f"DSGD_HEALTH_ACTION={self.health_action} needs "
                f"DSGD_CHECKPOINT_DIR: the resumable trip snapshot lives "
                f"under the checkpoint directory")
        if self.resource_probe_s < 0:
            raise ValueError("DSGD_RESOURCE_PROBE_S must be >= 0 (0 = no resource probe)")
        if self.blackbox_dir and self.resource_probe_s <= 0:
            raise ValueError("DSGD_BLACKBOX_DIR needs DSGD_RESOURCE_PROBE_S > 0: the "
                             "resource probe is the blackbox's only writer")
        self._check_serving()
        if self.host_devices < 0:
            raise ValueError(
                "host_devices must be >= 0 (0 = auto from "
                "torch.cuda.device_count(); 1 = flat single-device worker)")
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
        if self.compress_k <= 0:
            raise ValueError("compress_k must be > 0 (fraction of dim or count)")
        if self.feature_shards < 1:
            raise ValueError("feature_shards must be >= 1")
        if self.feature_shards > 1 and self.use_async:
            raise ValueError(
                "feature_shards is a sync (2-D mesh) engine; it cannot be "
                "combined with use_async")
        if self.feature_shards > 1 and self.engine == "rpc":
            raise ValueError(
                "feature_shards needs the mesh engine (2-D shard_map); the "
                "rpc topology has no feature axis")
        if self.feature_shards > 1 and self.optimizer != "sgd":
            raise ValueError(
                "the feature-sharded engine runs the reference's plain SGD "
                "update; optimizer must be 'sgd' when feature_shards > 1")
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
        # the grammars are aggtree/plan.py's and shardedps/plan.py's, as in
        # the JAX config: a typo fails here, not windows into a fit
        parse_agg_tree(self.agg_tree)
        if parse_master_shards(self.master_shards):
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
        if self.host_index is not None and self.host_devices not in (0, 1):
            raise ValueError(
                "DSGD_HOST_INDEX with DSGD_HOST_DEVICES > 1 is not "
                "supported yet: the in-host mesh binds its slice at build "
                "time (no incremental reload)")

    def _check_autopilot(self) -> None:
        """The JAX Config's validation of the autopilot knobs, whether or
        not DSGD_AUTOPILOT is set."""
        if self.autopilot_poll_s <= 0:
            raise ValueError("DSGD_AUTOPILOT_POLL_S must be > 0")
        if self.autopilot_cooldown_s < 0:
            raise ValueError("DSGD_AUTOPILOT_COOLDOWN_S must be >= 0")
        if self.autopilot_drift_ratio <= 1.0:
            raise ValueError(
                "DSGD_AUTOPILOT_DRIFT_RATIO must be > 1 (the drift rule "
                "compares EWMA probe loss against ratio x baseline)")
        if self.autopilot_drift_patience < 1:
            raise ValueError("DSGD_AUTOPILOT_DRIFT_PATIENCE must be >= 1")
        if self.autopilot_drift_warmup < 0:
            raise ValueError("DSGD_AUTOPILOT_DRIFT_WARMUP must be >= 0")
        if self.autopilot_drift_floor < 0:
            raise ValueError("DSGD_AUTOPILOT_DRIFT_FLOOR must be >= 0")
        if self.autopilot_window < 1:
            raise ValueError("DSGD_AUTOPILOT_WINDOW must be >= 1 rows")
        if self.autopilot_max_retrains < 0:
            raise ValueError("DSGD_AUTOPILOT_MAX_RETRAINS must be >= 0 (0 = unbounded)")
        if self.autopilot_canary_timeout_s <= 0:
            raise ValueError("DSGD_AUTOPILOT_CANARY_TIMEOUT_S must be > 0")
        if self.autopilot_recovery_band and self.autopilot_recovery_band <= 1:
            raise ValueError(
                "DSGD_AUTOPILOT_RECOVERY_BAND must be > 1 (0 disables "
                "residual settling)")
        if self.autopilot_probe_capacity < 1:
            raise ValueError("DSGD_AUTOPILOT_PROBE_CAPACITY must be >= 1")
        if self.autopilot_label_delay < 0:
            raise ValueError("DSGD_AUTOPILOT_LABEL_DELAY must be >= 0")
        if self.autopilot_source_refresh_s <= 0:
            raise ValueError("DSGD_AUTOPILOT_SOURCE_REFRESH_S must be > 0")
        if self.autopilot and self.role_override in ("serve", "worker"):
            raise ValueError(
                f"DSGD_AUTOPILOT has no {self.role_override} half: the "
                f"flywheel lives in the dev/route/master roles "
                f"(docs/CONTINUAL.md)")
        if self.autopilot and self.serve_probe_refresh_s > 0:
            raise ValueError(
                "DSGD_AUTOPILOT and DSGD_SERVE_PROBE_REFRESH_S are "
                "mutually exclusive: the traffic reservoir REPLACES the "
                "operator-rotated probe file (docs/CONTINUAL.md)")

    def _check_serving(self) -> None:
        """The JAX Config's validation of the serving fields."""
        if self.role_override == "serve" and not self.checkpoint_dir:
            raise ValueError("role=serve needs checkpoint_dir (DSGD_CHECKPOINT_DIR): "
                             "serving loads and hot-reloads the trainer's checkpoints")
        if self.serve_max_batch < 1:
            raise ValueError("serve_max_batch must be >= 1")
        if self.serve_max_delay_ms < 0:
            raise ValueError("serve_max_delay_ms must be >= 0")
        if self.serve_queue_depth < 1:
            raise ValueError("serve_queue_depth must be >= 1")
        if self.serve_ckpt_poll_s <= 0:
            raise ValueError("serve_ckpt_poll_s must be > 0")
        if self.serve_replicas < 0:
            raise ValueError("serve_replicas must be >= 0 (0 = single node)")
        if self.role_override == "route" and not self.serve_targets:
            raise ValueError("role=route needs DSGD_SERVE_TARGETS: the router balances "
                             "over an explicit replica endpoint list (host:port,...)")
        for spec in (self.serve_targets, self.serve_push):
            if spec:
                from distributed_sgd_tpu_torch.serving.push import parse_targets

                parse_targets(spec)  # endpoint-list typos fail here, not mid-route
        if self.serve_push and not self.checkpoint_dir:
            raise ValueError("DSGD_SERVE_PUSH needs DSGD_CHECKPOINT_DIR: the checkpoint "
                             "distributor watches the trainer's checkpoint directory")
        if not 0.0 <= self.serve_canary <= 1.0:
            raise ValueError("serve_canary must be a fraction in [0, 1]")
        if (self.serve_canary > 0 and not self.serve_probe
                and self.role_override in ("route", "serve")):
            # an armed canary with nothing to evaluate would promote every
            # version ungated
            raise ValueError("DSGD_SERVE_CANARY > 0 needs DSGD_SERVE_PROBE: the canary "
                             "gate evaluates pushed versions against a held-out probe set")
        if self.serve_hedge_ms < 0:
            raise ValueError("serve_hedge_ms must be >= 0 (0 = no hedging)")
        if self.serve_health_s <= 0:
            raise ValueError("serve_health_s must be > 0")
        if self.serve_probe_refresh_s < 0:
            raise ValueError("DSGD_SERVE_PROBE_REFRESH_S must be >= 0 (0 = fixed probe set)")
        if (self.serve_probe_refresh_s > 0 and not self.serve_probe
                and self.role_override in ("route", "serve")):
            raise ValueError("DSGD_SERVE_PROBE_REFRESH_S > 0 needs DSGD_SERVE_PROBE: the "
                             "refresh re-reads the probe file on its cadence")
        if self.serve_ha:
            if self.role_override != "route":
                raise ValueError("DSGD_SERVE_HA is a router knob (DSGD_ROLE=route): peer "
                                 "promoted-state sync runs between LIVE routers")
            from distributed_sgd_tpu_torch.serving.ha import parse_ha_spec

            parse_ha_spec(self.serve_ha)
        if self.serve_slo_ms < 0:
            raise ValueError("DSGD_SERVE_SLO_MS must be >= 0 (0 = autoscale off)")
        if self.serve_slo_ms > 0 and self.role_override == "serve" and self.serve_replicas < 1:
            raise ValueError("DSGD_SERVE_SLO_MS needs the fleet mode (DSGD_SERVE_REPLICAS "
                             ">= 1): the autoscaler grows and shrinks an in-process "
                             "replica fleet")
        if self.serve_scale_max < 1:
            raise ValueError("DSGD_SERVE_SCALE_MAX must be >= 1")
        if self.serve_slo_ms > 0 and self.serve_scale_max < max(1, self.serve_replicas):
            raise ValueError("DSGD_SERVE_SCALE_MAX must be >= the boot fleet size "
                             "(DSGD_SERVE_REPLICAS): the boot size is the scale floor")
        if self.serve_scale_cooldown_s < 0:
            raise ValueError("DSGD_SERVE_SCALE_COOLDOWN_S must be >= 0")

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
            compress_k=_env("DSGD_COMPRESS_K", cls.compress_k, float),
            compress_ef=_env("DSGD_COMPRESS_EF", cls.compress_ef, bool),
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
            compile_cache=_env("DSGD_COMPILE_CACHE", None, str),
            telemetry=_env("DSGD_TELEMETRY", cls.telemetry, bool),
            telemetry_port=_env("DSGD_TELEMETRY_PORT", cls.telemetry_port, int),
            health_action=_env("DSGD_HEALTH_ACTION", None, str),
            resource_probe_s=_env("DSGD_RESOURCE_PROBE_S", cls.resource_probe_s, float),
            blackbox_dir=_env("DSGD_BLACKBOX_DIR", None, str),
            autopilot=_env("DSGD_AUTOPILOT", cls.autopilot, bool),
            autopilot_poll_s=_env("DSGD_AUTOPILOT_POLL_S", cls.autopilot_poll_s, float),
            autopilot_cooldown_s=_env("DSGD_AUTOPILOT_COOLDOWN_S", cls.autopilot_cooldown_s,
                                      float),
            autopilot_drift_ratio=_env("DSGD_AUTOPILOT_DRIFT_RATIO",
                                       cls.autopilot_drift_ratio, float),
            autopilot_drift_patience=_env("DSGD_AUTOPILOT_DRIFT_PATIENCE",
                                          cls.autopilot_drift_patience, int),
            autopilot_drift_warmup=_env("DSGD_AUTOPILOT_DRIFT_WARMUP",
                                        cls.autopilot_drift_warmup, int),
            autopilot_drift_floor=_env("DSGD_AUTOPILOT_DRIFT_FLOOR",
                                       cls.autopilot_drift_floor, float),
            autopilot_window=_env("DSGD_AUTOPILOT_WINDOW", cls.autopilot_window, int),
            autopilot_max_retrains=_env("DSGD_AUTOPILOT_MAX_RETRAINS",
                                        cls.autopilot_max_retrains, int),
            autopilot_recovery_band=_env("DSGD_AUTOPILOT_RECOVERY_BAND",
                                         cls.autopilot_recovery_band, float),
            autopilot_canary_timeout_s=_env("DSGD_AUTOPILOT_CANARY_TIMEOUT_S",
                                            cls.autopilot_canary_timeout_s, float),
            autopilot_probe_capacity=_env("DSGD_AUTOPILOT_PROBE_CAPACITY",
                                          cls.autopilot_probe_capacity, int),
            autopilot_label_delay=_env("DSGD_AUTOPILOT_LABEL_DELAY",
                                       cls.autopilot_label_delay, int),
            autopilot_source_refresh_s=_env("DSGD_AUTOPILOT_SOURCE_REFRESH_S",
                                            cls.autopilot_source_refresh_s, float),
            serve_port=_env("DSGD_SERVE_PORT", cls.serve_port, int),
            serve_max_batch=_env("DSGD_SERVE_MAX_BATCH", cls.serve_max_batch, int),
            serve_max_delay_ms=_env("DSGD_SERVE_MAX_DELAY_MS", cls.serve_max_delay_ms, float),
            serve_queue_depth=_env("DSGD_SERVE_QUEUE_DEPTH", cls.serve_queue_depth, int),
            serve_ckpt_poll_s=_env("DSGD_SERVE_CKPT_POLL_S", cls.serve_ckpt_poll_s, float),
            serve_replicas=_env("DSGD_SERVE_REPLICAS", cls.serve_replicas, int),
            serve_targets=_env("DSGD_SERVE_TARGETS", None, str),
            serve_push=_env("DSGD_SERVE_PUSH", None, str),
            serve_canary=_env("DSGD_SERVE_CANARY", cls.serve_canary, float),
            serve_probe=_env("DSGD_SERVE_PROBE", None, str),
            serve_hedge_ms=_env("DSGD_SERVE_HEDGE_MS", cls.serve_hedge_ms, float),
            serve_health_s=_env("DSGD_SERVE_HEALTH_S", cls.serve_health_s, float),
            serve_state=_env("DSGD_SERVE_STATE", None, str),
            serve_probe_refresh_s=_env("DSGD_SERVE_PROBE_REFRESH_S",
                                       cls.serve_probe_refresh_s, float),
            serve_ha=_env("DSGD_SERVE_HA", None, str),
            serve_slo_ms=_env("DSGD_SERVE_SLO_MS", cls.serve_slo_ms, float),
            serve_scale_max=_env("DSGD_SERVE_SCALE_MAX", cls.serve_scale_max, int),
            serve_scale_cooldown_s=_env("DSGD_SERVE_SCALE_COOLDOWN_S",
                                        cls.serve_scale_cooldown_s, float),
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

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        """The inverse of `to_json` (validated as any Config is)."""
        return cls(**json.loads(s))
