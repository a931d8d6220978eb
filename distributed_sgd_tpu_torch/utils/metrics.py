"""Counters, gauges, histograms and timers, with the Prometheus and
InfluxDB exporters.

The port's copy of the JAX package's utils/metrics.py (after the
reference's Kamon surface: ``master.sync.batch.duration``,
``master.sync.loss``/``acc``, the ``slave.*`` counters): the same
instrument classes, the same histogram buckets and reservoir, and the same
exposition text.  ``Metrics.prometheus_text`` and
``Metrics.influx_lines(ts_ns=)`` give the JAX package's text for the same
recorded values.  Exporters:

- `PrometheusExporter`: an HTTP endpoint serving the text exposition
  format at ``/metrics`` (DSGD_METRICS_PORT);
- `InfluxPusher`: a background loop POSTing `influx_lines()` to an
  InfluxDB write endpoint every second (DSGD_INFLUX_URL), the
  reference's ``record=true`` push.

The instrument constants are those the port records: the sync trainer,
the async engines, the RPC master and worker (core/master.py,
core/worker.py), the async RPC fit included, the aggregation tree and
the sharded master, the gradient compressors (compress/), the serving
fleet (serving/), the resource probe, the cluster telemetry scrape and
the training-health monitor (telemetry/), the spin-up fast path
(compile_cache.py) and the continual-learning autopilot (autopilot/).
"""

from __future__ import annotations

import bisect
import http.server
import math
import os
import random
import threading
import time
import zlib
from typing import Dict, List, Optional, Tuple


class Counter:
    __slots__ = ("name", "_value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def increment(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value


class Gauge:
    """Last-write-wins instantaneous value: neither monotone (Counter)
    nor distributional (Histogram) — the CURRENT value is the signal
    (process RSS, open descriptors).  A never-set gauge is NaN and stays
    off both exporters."""

    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        # plain float slot: a GIL-atomic assignment needs no lock, and the
        # hot paths that set gauges (per sync round / per dispatch) must
        # not pay one
        self.value = float("nan")

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Streaming histogram: count/sum/min/max/mean/last + quantiles +
    fixed log-spaced buckets.

    The reference's Kamon histograms feed Grafana percentile panels; the
    cheap streaming aggregates cover mean-style dashboards, and a fixed-size
    uniform reservoir (Vitter's algorithm R, 512 slots) adds p50/p95/p99 —
    serving latency SLOs are unreadable without percentiles.  Exact while
    count <= 512, an unbiased uniform sample of the full stream after; both
    exporters emit the estimates.  The reservoir RNG is seeded from the
    instrument name, so a replayed value stream reproduces its quantiles.

    Buckets: every recorded value
    also lands in one of `BUCKET_BOUNDS` — three log-spaced bounds per
    decade over [1e-6, 1e7], wide enough for seconds, bytes, losses, and
    counts — from which the Prometheus exporter emits a REAL `le`-bucketed
    cumulative histogram family (``<name>_hist_bucket``), so PromQL
    ``histogram_quantile`` works server-side on top of the client-side
    reservoir estimates.  Unlike the reservoir, bucket counts never
    subsample: they are exact over the full stream.
    """

    RESERVOIR_SIZE = 512
    QUANTILES = (0.5, 0.95, 0.99)
    # 3 bounds per decade, 1e-6 .. 1e7; values beyond the last bound count
    # only in the implicit +Inf bucket (values <= 1e-6, including zero and
    # negatives, land in the first)
    BUCKET_BOUNDS = tuple(10.0 ** (k / 3.0) for k in range(-18, 22))

    __slots__ = ("name", "count", "sum", "min", "max", "last", "_reservoir",
                 "_rng", "_lock", "_buckets")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.last = float("nan")
        self._reservoir: List[float] = []
        self._rng = random.Random(zlib.crc32(name.encode()))
        self._lock = threading.Lock()
        self._buckets = [0] * len(self.BUCKET_BOUNDS)

    def record(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.sum += v
            self.min = min(self.min, v)
            self.max = max(self.max, v)
            self.last = v
            i = bisect.bisect_left(self.BUCKET_BOUNDS, v)
            if i < len(self._buckets):
                self._buckets[i] += 1  # past the last bound: +Inf only
            if len(self._reservoir) < self.RESERVOIR_SIZE:
                self._reservoir.append(v)
            else:  # algorithm R: keep slot j with probability SIZE/count
                j = self._rng.randrange(self.count)
                if j < self.RESERVOIR_SIZE:
                    self._reservoir[j] = v

    def bucket_counts(self) -> List[int]:
        """Per-bucket (non-cumulative) counts, snapshot under the lock;
        `count - sum(bucket_counts())` is the +Inf-only tail."""
        with self._lock:
            return list(self._buckets)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (exact while count <= reservoir size).
        Linear interpolation between order statistics; NaN when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} must be in [0, 1]")
        with self._lock:
            snap = sorted(self._reservoir)
        if not snap:
            return float("nan")
        pos = q * (len(snap) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(snap) - 1)
        return snap[lo] + (snap[hi] - snap[lo]) * (pos - lo)

    def quantiles(self) -> Dict[float, float]:
        """{q: estimate} for the exported QUANTILES (p50/p95/p99)."""
        return {q: self.quantile(q) for q in self.QUANTILES}


class Timer:
    """Histogram of elapsed seconds with a context-manager interface."""

    def __init__(self, hist: Histogram):
        self._hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._hist.record(time.perf_counter() - self._t0)
        return False


def _influx_escape(s: str) -> str:
    """Escape a line-protocol tag key/value: per the InfluxDB spec, commas,
    equals signs, and spaces must be backslash-escaped in tag keys and
    values — emitted raw they terminate the tag set early and corrupt the
    WHOLE write batch, not just one line."""
    return (str(s).replace("\\", "\\\\").replace(",", "\\,")
            .replace("=", "\\=").replace(" ", "\\ "))


def _influx_escape_measurement(s: str) -> str:
    """Measurement names escape commas and spaces (but not '=')."""
    return str(s).replace(",", "\\,").replace(" ", "\\ ")


def _prom_escape(s: str) -> str:
    """Escape a Prometheus label VALUE (exposition format): backslash,
    double quote, and newline."""
    return (str(s).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def prom_name(name: str, suffix: str = "") -> str:
    """Instrument name -> Prometheus identifier (the JAX package's one
    mangling rule)."""
    return name.replace(".", "_").replace("-", "_") + suffix


class Metrics:
    """Thread-safe named-instrument registry."""

    def __init__(self, tags: Optional[Dict[str, str]] = None):
        self.tags = dict(tags or {})
        self._counters: Dict[str, Counter] = {}
        self._hists: Dict[str, Histogram] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name))

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._hists.setdefault(name, Histogram(name))

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self._gauges.setdefault(name, Gauge(name))

    def timer(self, name: str) -> Timer:
        return Timer(self.histogram(name))

    # snapshot accessors:
    # stable lists, safe to iterate while other threads register/record

    def counters(self) -> List[Counter]:
        with self._lock:
            return list(self._counters.values())

    def histograms(self) -> List[Histogram]:
        with self._lock:
            return list(self._hists.values())

    def gauges(self) -> List[Gauge]:
        with self._lock:
            return list(self._gauges.values())

    # -- exporters ---------------------------------------------------------

    def prometheus_text(self) -> str:
        tags = ",".join(f'{k}="{_prom_escape(v)}"'
                        for k, v in sorted(self.tags.items()))
        tagstr = "{" + tags + "}" if tags else ""
        mangle = prom_name
        lines: List[str] = []
        for g in list(self._gauges.values()):
            if g.value != g.value:  # never-set (NaN) gauges stay unexported
                continue
            base = mangle(g.name)
            lines.append(f"# TYPE {base} gauge")
            lines.append(f"{base}{tagstr} {g.value}")
        for c in list(self._counters.values()):
            base = mangle(c.name)
            # conventional counter spelling: the `_total` family is the
            # one dashboards should target; the bare-name family is kept
            # as a parallel family
            lines.append(f"# TYPE {base}_total counter")
            lines.append(f"{base}_total{tagstr} {c.value}")
            lines.append(f"# TYPE {base} counter")
            lines.append(f"{base}{tagstr} {c.value}")
        for h in list(self._hists.values()):
            base = mangle(h.name)
            lines.append(f"# TYPE {base} summary")
            if h.count:
                # quantile samples join the summary family with the
                # reserved `quantile` label merged into the shared tags
                for q, est in h.quantiles().items():
                    qtags = ",".join(filter(None, [tags, f'quantile="{q}"']))
                    lines.append(f"{base}{{{qtags}}} {est}")
            lines.append(f"{base}_count{tagstr} {h.count}")
            lines.append(f"{base}_sum{tagstr} {h.sum}")
            if h.count:
                # min/max are separate gauge families: a summary family only
                # admits quantile/_sum/_count samples in the exposition format
                lines.append(f"# TYPE {base}_min gauge")
                lines.append(f"{base}_min{tagstr} {h.min}")
                lines.append(f"# TYPE {base}_max gauge")
                lines.append(f"{base}_max{tagstr} {h.max}")
                # real le-bucketed histogram as a PARALLEL family (the
                # summary family above keeps its name/samples for existing
                # dashboards — same migration discipline as the `_total`
                # counters): cumulative fixed log-spaced buckets, exact
                # over the full stream, so server-side
                # histogram_quantile() works
                lines.append(f"# TYPE {base}_hist histogram")
                cum = 0
                for le, n in zip(Histogram.BUCKET_BOUNDS, h.bucket_counts()):
                    cum += n
                    btags = ",".join(filter(None, [tags, f'le="{le:.9g}"']))
                    lines.append(f"{base}_hist_bucket{{{btags}}} {cum}")
                inf_tags = ",".join(filter(None, [tags, 'le="+Inf"']))
                lines.append(f"{base}_hist_bucket{{{inf_tags}}} {h.count}")
                lines.append(f"{base}_hist_sum{tagstr} {h.sum}")
                lines.append(f"{base}_hist_count{tagstr} {h.count}")
        return "\n".join(lines) + "\n"

    def influx_lines(self, ts_ns: Optional[int] = None) -> str:
        """InfluxDB line protocol, the reference's push format."""
        ts = ts_ns if ts_ns is not None else time.time_ns()
        tags = "".join(f",{_influx_escape(k)}={_influx_escape(v)}"
                       for k, v in sorted(self.tags.items()))
        lines = []
        for g in list(self._gauges.values()):
            if g.value == g.value:  # skip never-set NaN gauges
                lines.append(
                    f"{_influx_escape_measurement(g.name)}{tags} "
                    f"value={g.value} {ts}")
        for c in list(self._counters.values()):
            lines.append(
                f"{_influx_escape_measurement(c.name)}{tags} "
                f"value={c.value}i {ts}")
        for h in list(self._hists.values()):
            if h.count:
                qs = h.quantiles()
                qfields = ",".join(
                    f"p{int(q * 100)}={est}" for q, est in qs.items())
                lines.append(
                    f"{_influx_escape_measurement(h.name)}{tags} "
                    f"count={h.count}i,sum={h.sum},"
                    f"min={h.min},max={h.max},mean={h.mean},{qfields} {ts}"
                )
        return "\n".join(lines) + ("\n" if lines else "")


# -- comms accounting (compress/: the wire bytes of each encoded gradient) ----
COMMS_BYTES_ON_WIRE = "comms.bytes_on_wire"        # counter: serialized bytes sent
COMMS_BYTES_DENSE = "comms.bytes_dense_equiv"      # counter: 4*dim raw-f32 baseline
COMMS_RATIO = "comms.compression_ratio"            # histogram: dense/wire per message
COMMS_RESIDUAL_NORM = "comms.residual_norm"        # histogram: ||EF residual||2 per send


def record_wire(metrics: "Metrics", wire_bytes: int, dense_bytes: int) -> None:
    """Account one encoded gradient message: actual serialized size vs the
    raw dense-f32 bytes the same vector would have cost, plus the per-message
    compression ratio.  Called on the SEND side only, so a dev-mode cluster
    (sender and receiver sharing the global registry) never double-counts."""
    metrics.counter(COMMS_BYTES_ON_WIRE).increment(int(wire_bytes))
    metrics.counter(COMMS_BYTES_DENSE).increment(int(dense_bytes))
    if wire_bytes > 0:
        metrics.histogram(COMMS_RATIO).record(dense_bytes / wire_bytes)


# -- the RPC sync fit (core/master.py fit_sync) --------------------------------
#
# `rounds` counts every barrier attempt, including windows later discarded
# to a failed or stale sibling; the bcast.* family is the master->worker
# weight traffic by wire form (full, the sparse delta of
# DSGD_DELTA_BROADCAST, or header-only).
SYNC_ROUNDS = "master.sync.rounds"             # counter: fan-out barriers run
SYNC_GRAD_BYTES = "master.sync.grad.bytes"     # counter: worker->master reply bytes
SYNC_BCAST_BYTES = "master.sync.bcast.bytes"   # counter: master->worker weight bytes
SYNC_BCAST_FULL = "master.sync.bcast.full"     # counter: full-tensor sends
SYNC_BCAST_DELTA = "master.sync.bcast.delta"   # counter: sparse WeightDelta sends
SYNC_BCAST_CACHED = "master.sync.bcast.cached" # counter: header-only sends (0 bytes)
SYNC_STALE = "master.sync.bcast.stale"         # counter: stale replies -> full fallback
SYNC_STALLED = "master.sync.barrier.stalled"       # soft-deadline overruns, no relief
SYNC_RESPLITS = "master.sync.resplit"            # counter: mid-fit membership resplits
MASTER_EVICTIONS = "master.evictions"          # counter: involuntary unregisters
BREAKER_OPEN = "rpc.breaker.open"                  # breaker trips (rpc/service.py)

# the quorum barrier (DSGD_QUORUM): `stalled` above counts barriers that
# overran the soft deadline with no quorum relief; a quorum-satisfied
# round that closed without every worker's own reply counts `degraded`
QUORUM_DEGRADED = "master.sync.quorum.degraded"    # rounds closed at < full strength
QUORUM_HEDGES = "master.sync.quorum.hedges"        # hedge Gradient/Forward requests issued
QUORUM_HEDGE_WINS = "master.sync.quorum.hedge_wins"  # slices covered by a hedge
QUORUM_LATE = "master.sync.quorum.late"            # late replies discarded

# the pipelined sync levers: replies summed through the fan-in lanes
# (DSGD_FANIN_LANES) in applied windows, each parsed in its arrival
# callback (or at round close where that lagged);
# rounds dispatched from a pre-staged draw (DSGD_STAGE_POOL) and stages
# dropped by a retry or a resplit, counted once a fit; the persistent per-worker streams (DSGD_STREAM, rpc/
# stream.py): frames written, frames past their deadline, late replies
# dropped by seq, teardowns, and windows replayed over unary after one;
# the worker's side of the streams; and the host-local rows (data/
# host_shard.py): resident-slice reloads, the rows they read, and hedges
# served from a scratch read.  With the levers off none of these moves.
FANIN_PARSED = "master.sync.fanin.parsed"      # counter: replies summed by the lanes
STAGE_HITS = "master.sync.stage.hits"          # counter: rounds served pre-staged
STAGE_DISCARDS = "master.sync.stage.discards"  # counter: stages dropped (retry/resplit)
STREAM_OPENED = "master.sync.stream.opened"      # counter: streams opened
STREAM_SENDS = "master.sync.stream.sends"        # counter: request frames written
STREAM_EXPIRED = "master.sync.stream.expired"    # counter: frame deadline misses
STREAM_LATE = "master.sync.stream.late"          # counter: late/dup replies dropped
STREAM_BROKEN = "master.sync.stream.broken"      # counter: stream teardowns
STREAM_FALLBACK = "master.sync.stream.fallback"  # counter: windows replayed unary
SLAVE_STREAM_OPENED = "slave.stream.opened"      # counter: streams accepted
SLAVE_STREAM_CLOSED = "slave.stream.closed"      # counter: streams torn down
SLAVE_STREAM_FRAMES = "slave.stream.frames"      # counter: request frames served
DATA_RELOADS = "slave.data.reloads"              # counter: resident-slice reloads
DATA_RELOAD_ROWS = "slave.data.reload.rows"      # counter: rows read for reloads
HEDGE_SCRATCH = "slave.data.hedge.scratch"       # counter: scratch-served hedges

# -- the aggregation tree (aggtree/; DSGD_AGG_TREE) ----------------------------
# Registered only when DSGD_AGG_TREE stamps a non-trivial plan: the master
# side on the first plan build, the worker side when its Reducer is built
# lazily.  With the knob off none of these exists.
TREE_DEPTH = "master.tree.depth"                 # gauge: longest root-to-leaf edge chain
TREE_EDGES = "master.tree.edges"                 # gauge: worker->worker edges in the plan
TREE_PARTIAL = "master.tree.partial"             # counter: partial subtree sums accepted
TREE_FLAT_FALLBACK = "master.tree.flat_fallback"  # counter: replies that bypassed a dead parent
TREE_REBUILDS = "master.tree.rebuilds"           # counter: mid-fit plan rebuilds
AGG_CHILDREN = "slave.agg.children"              # counter: child updates reduced here
AGG_BYTES_IN = "slave.agg.bytes_in"              # counter: child push bytes received
AGG_BYTES_UP = "slave.agg.bytes_up"              # counter: bytes pushed to the parent
AGG_PARTIAL = "slave.agg.partial"                # counter: reduced rounds missing a child
AGG_FLAT = "slave.agg.flat"                      # counter: dead-parent flat fallbacks (child side)

# -- the sharded master plane (shardedps/; DSGD_MASTER_SHARDS) -----------------
# Registered only when DSGD_MASTER_SHARDS builds a shard plan: the
# coordinator's at lane build, the worker's when its ShardAssembler is
# built lazily.  With the knob off none of these exists.
SHARD_COUNT = "master.shard.count"               # gauge: lanes in the live shard plan
SHARD_ROUNDS = "master.shard.rounds"             # counter: sharded fan-out rounds
SHARD_REBUILDS = "master.shard.rebuilds"         # counter: plan rebuilds after a shard loss
SHARD_FALLBACK_ROUNDS = "master.shard.fallback_rounds"  # counter: flat single-master rounds
SHARD_BCAST_BYTES = "master.shard.bcast.bytes"   # counter: slice broadcast bytes, all lanes
SHARD_GRAD_BYTES = "master.shard.grad.bytes"     # counter: slice fan-in bytes, all lanes
SHARD_ASSEMBLED = "slave.shard.assembled"        # counter: rendezvous rounds computed once
SHARD_ASM_TIMEOUTS = "slave.shard.timeouts"      # counter: rendezvous waits that expired stale

# -- the RPC async fit (core/master.py fit_async, core/worker.py) ---------------
#
# A worker counts its local steps under `slave.async.batch` (k a dispatch)
# and the peer deltas it merged under `slave.async.grad.update`; its
# bounded gossip senders count `slave.async.grad.dropped` and, past an
# open breaker, GOSSIP_SUPPRESSED.  The master records each check's
# smoothed test loss under `master.async.loss` (a counter, truncated as
# the reference does) and `master.async.loss.value` (a histogram), and
# with DSGD_ASYNC_DRAIN its inbox below.
GOSSIP_SUPPRESSED = "slave.async.grad.suppressed"  # sends refused by an open breaker
ASYNC_DRAINS = "master.async.drain.batches"        # inbox drains applied
ASYNC_DRAIN_SIZE = "master.async.drain.size"       # histogram: messages per drain
ASYNC_DRAIN_FALLBACK = "master.async.drain.fallback"  # full inbox -> per-message
TOPOLOGY_RESELECT = "slave.async.topology.reselect"  # edges re-routed past breakers
ASYNC_RESPLITS = "master.async.resplit"            # elastic membership resplits
HEALTH_DRAIN_BACKLOG = "health.drain.backlog"       # gauge: async inbox depth (master)

# -- the cluster telemetry plane (telemetry/aggregate.py; DSGD_TELEMETRY) -------
# The scrape's own accounting on a master or router: a scrape consults the
# per-peer breakers read-only (`skipped`) and never feeds them, so its
# failures count here and nowhere else.
TELEMETRY_SCRAPES = "master.telemetry.scrapes"      # counter: scrape fan-outs run
TELEMETRY_SCRAPE_ERRORS = "master.telemetry.scrape.errors"  # counter: failed worker scrapes
TELEMETRY_SCRAPE_SKIPPED = "master.telemetry.scrape.skipped"  # counter: breaker-suppressed
TELEMETRY_WORKERS = "master.telemetry.workers"      # gauge: snapshots currently held
# a worker's health gauges under DSGD_TELEMETRY (core/worker.py
# record_health): its gradient norm, the gap since its previous dispatch,
# and with DSGD_COMPRESS the error-feedback residual's norm; the master's
# training-health monitor (telemetry/health.py, DSGD_HEALTH_ACTION) sets
# the same two per round, its smoothed loss and its trips.  With both off
# none registers.
HEALTH_GRAD_NORM = "health.grad.norm"               # gauge: ||g||2 of the last round
HEALTH_STALENESS = "health.reply.staleness_s"       # gauge: round latency / dispatch gap
HEALTH_EF_RESIDUAL_NORM = "health.ef.residual.norm"  # gauge: ||EF residual||2 (workers)
HEALTH_LOSS_EWMA = "health.loss.ewma"               # gauge: watchdog's smoothed loss
HEALTH_TRIPPED = "health.tripped"                   # counter: watchdog trips


def record_broadcast(metrics: "Metrics", form: str, n_bytes: int) -> None:
    """Account one master->worker weight send: `form` is 'full' | 'delta' |
    'cached' (delta-hit-rate = (delta + cached) / total sends)."""
    metrics.counter(SYNC_BCAST_BYTES).increment(int(n_bytes))
    metrics.counter(f"master.sync.bcast.{form}").increment()


# -- serving fleet (serving/router.py + serving/push.py) ----------------------
#
# Checkpoint-distribution accounting follows the master.sync.bcast.* /
# comms.* pattern: the PUSHER (the trainer master's distributor, or the
# router re-pushing on canary rollback) counts send-side only, so an
# in-process fleet sharing a registry never double-counts.  `bytes` is the
# actual serialized PushWeightsRequest size; `bytes_full_equiv` is what the
# same update would have cost as one full dense tensor per target -- the
# denominator of the fleet's wire-savings ratio.
SERVE_PUSH_BYTES = "serve.push.bytes"                # counter: wire bytes sent
SERVE_PUSH_FULL_EQUIV = "serve.push.bytes_full_equiv"  # counter: 4*dim/target baseline
SERVE_PUSH_FULL = "serve.push.full"                  # counter: full-tensor pushes
SERVE_PUSH_DELTA = "serve.push.delta"                # counter: sparse delta pushes
SERVE_PUSH_NACK = "serve.push.nack"                  # counter: version-gap nacks seen
SERVE_PUSH_ERRORS = "serve.push.errors"              # counter: failed push RPCs
# replica-side push application (serving/model_store.py apply_push)
SERVE_MODEL_PUSH_FULL = "serve.model.push.full"      # counter: full pushes applied
SERVE_MODEL_PUSH_DELTA = "serve.model.push.delta"    # counter: deltas applied
SERVE_MODEL_PUSH_GAP = "serve.model.push.gap"        # counter: gaps -> file fallback
SERVE_MODEL_VERSION = "serve.model.version"          # gauge: checkpoint step serving NOW
# router data plane (serving/router.py)
ROUTER_RETRIES = "router.predict.retries"            # counter: failovers to another replica
ROUTER_HEDGES = "router.predict.hedges"              # counter: tail hedges issued
ROUTER_HEDGE_WINS = "router.predict.hedge_wins"      # counter: hedge answered first
ROUTER_DRAINED = "router.replica.drained"            # counter: healthy->drained transitions
ROUTER_ELIGIBLE = "router.replica.eligible"          # gauge: replicas in rotation
ROUTER_CANARY_PROMOTED = "router.canary.promoted"    # counter: versions promoted fleet-wide
ROUTER_CANARY_ROLLBACK = "router.canary.rollback"    # counter: versions rolled back
ROUTER_CANARY_LOSS = "router.canary.probe_loss"      # gauge: last probe-set loss
ROUTER_PROBE_REFRESH = "router.canary.probe_refresh"  # counter: probe-set rotations
ROUTER_PROBE_SOURCED = "router.canary.probe_sourced"  # counter: reservoir rotations
ROUTER_PROBE_FILL = "router.canary.probe_fill"        # gauge: reservoir rows held

# serving-plane HA + autoscale (serving/ha.py)
ROUTER_HA_DECIDER = "router.ha.decider"              # gauge: 1 = holds the decider lease
ROUTER_HA_SYNCS = "router.ha.syncs"                  # counter: inbound peer sync exchanges served
ROUTER_HA_SYNC_ERRORS = "router.ha.sync_errors"      # counter: peer syncs that failed
ROUTER_HA_APPLIED = "router.ha.applied"              # counter: peer records adopted locally
ROUTER_HA_DEFERRED = "router.ha.deferred"            # counter: pushes deferred (not decider)
ROUTER_HA_FAILOVERS = "router.ha.failovers"          # counter: lease assumed after a lapse
ROUTER_SCALE_UP = "router.scale.up"                  # counter: replicas spun up
ROUTER_SCALE_DOWN = "router.scale.down"              # counter: replicas drained off
ROUTER_SCALE_REPLICAS = "router.scale.replicas"      # gauge: current fleet size
ROUTER_SCALE_LOAD_MS = "router.scale.load_ms"        # gauge: last load signal read


def record_push(metrics: "Metrics", form: str, wire_bytes: int,
                dense_bytes: int) -> None:
    """Account one PushWeights send: `form` is 'full' | 'delta';
    `dense_bytes` is the full-tensor-per-target baseline the delta saved
    against (the analogue of record_wire's dense equivalent)."""
    metrics.counter(SERVE_PUSH_BYTES).increment(int(wire_bytes))
    metrics.counter(SERVE_PUSH_FULL_EQUIV).increment(int(dense_bytes))
    metrics.counter(f"serve.push.{form}").increment()


# -- the spin-up fast path (compile_cache.py; DSGD_COMPILE_CACHE) ---------------
# The port's compiles are its nvcc builds (ops/_build.py): a kernel library
# found in the configured directory counts a hit, an nvcc run a miss, once
# a kernel a process; warmup.* attribute what the background pass did
# before the first dispatch needed it.  Knobs off, none registers.
COMPILE_CACHE_HITS = "compile.cache.hits"        # counter: kernel libraries found built
COMPILE_CACHE_MISSES = "compile.cache.misses"    # counter: nvcc runs
COMPILE_WARMUP_KERNELS = "compile.warmup.kernels"  # counter: flagship shapes warmed
COMPILE_WARMUP_SECONDS = "compile.warmup.seconds"  # gauge: background warmup wall clock
COMPILE_WARMUP_ERRORS = "compile.warmup.errors"  # counter: thunks that failed (logged)


# -- continual-learning autopilot (autopilot/; DSGD_AUTOPILOT) -------------------
# Registered only while an AutopilotController runs: knobs off, none of
# these exist.
AUTOPILOT_STATE = "autopilot.state"                # gauge: index into controller.STATES
AUTOPILOT_TRANSITIONS = "autopilot.transitions"    # counter: state transitions
AUTOPILOT_DRIFT_TRIPPED = "autopilot.drift.tripped"  # counter: drift detector trips
AUTOPILOT_DRIFT_EWMA = "autopilot.drift.ewma"      # gauge: detector's smoothed probe loss
AUTOPILOT_RETRAINS = "autopilot.retrains"          # counter: retrains launched
AUTOPILOT_RETRAIN_ERRORS = "autopilot.retrain.errors"  # counter: retrains that raised
AUTOPILOT_PROMOTED = "autopilot.promoted"          # counter: retrains promoted via canary
AUTOPILOT_ROLLED_BACK = "autopilot.rolled_back"    # counter: retrains rolled back / timed out


# -- process gauges -------------------------------------------------------------
PROC_RSS_BYTES = "process.rss_bytes"               # gauge: resident set size
PROC_OPEN_FDS = "process.open_fds"                 # gauge: open file descriptors

# -- long-horizon resource plane (telemetry/resources.py) ---------------------
# The ResourceProbe daemon (DSGD_RESOURCE_PROBE_S) samples these every
# tick: the /proc-backed process gauges (absent off-Linux -- a never-set
# gauge is NaN and stays off the wire), the interpreter-level gauges
# (threads, gc), and the internal-pressure gauges read from the live
# structures whose slow fill precedes an hours-horizon death (async
# drain inbox, trace buffer, flight ring, serving admission queue).  The
# compile-cache gauge is the JAX package's name; the port has no compile
# cache and never sets it.  Knobs off, the probe never runs and none of
# these registers.
PROC_RSS = "proc.rss_bytes"                        # gauge: RSS from /proc/self/statm
PROC_FDS = "proc.fds"                              # gauge: /proc/self/fd entries
PROC_THREADS = "proc.threads"                      # gauge: OS threads (status; fallback: threading)
PROC_GC_GEN2 = "proc.gc.gen2"                      # gauge: gen2 collections so far
PROC_PRESSURE_DRAIN_INBOX = "proc.pressure.drain_inbox"      # gauge: async inbox depth
PROC_PRESSURE_TRACE_BUFFER = "proc.pressure.trace_buffer"    # gauge: tracer events buffered
PROC_PRESSURE_FLIGHT_RING = "proc.pressure.flight_ring"      # gauge: flight events held
PROC_PRESSURE_ADMISSION_QUEUE = "proc.pressure.admission_queue"  # gauge: serving rows queued
PROC_PRESSURE_COMPILE_CACHE = "proc.pressure.compile_cache_files"  # gauge: cache dir entries
# leak-slope sentinel (telemetry/slope.py): the trip counter plus the
# per-series slope gauge family (`health.leak.slope.<series>`, set at
# trip time so the exposition carries the offending estimate)
HEALTH_LEAK_SUSPECT = "health.leak.suspect"        # counter: sentinel trips
HEALTH_LEAK_SLOPE = "health.leak.slope"            # gauge family prefix: tripped slope /s
# blackbox timeseries (telemetry/blackbox.py): snapshots appended to the
# on-disk ring this process lifetime (also written INTO each snapshot,
# so a tail knows how much history the ring ever held)
BLACKBOX_SNAPSHOTS = "blackbox.snapshots"          # counter: snapshots appended


def sample_process_gauges(metrics: "Metrics") -> Tuple[float, float]:
    """Set PROC_RSS_BYTES / PROC_OPEN_FDS from /proc/self (Linux; a
    platform without procfs leaves the gauges unset and returns NaN) and
    return (rss_bytes, open_fds) for callers that keep their own series
    — a leak-slope check."""
    rss = fds = float("nan")
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    rss = float(line.split()[1]) * 1024.0  # kB -> bytes
                    break
        fds = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        return rss, fds
    if rss == rss:
        metrics.gauge(PROC_RSS_BYTES).set(rss)
    if fds == fds:
        metrics.gauge(PROC_OPEN_FDS).set(fds)
    return rss, fds


_GLOBAL = Metrics()


def global_metrics() -> Metrics:
    return _GLOBAL


def counter(name: str) -> Counter:
    return _GLOBAL.counter(name)


def histogram(name: str) -> Histogram:
    return _GLOBAL.histogram(name)


def gauge(name: str) -> Gauge:
    return _GLOBAL.gauge(name)


def timer(name: str) -> Timer:
    return _GLOBAL.timer(name)


class PrometheusExporter:
    """Tiny HTTP exporter for the Prometheus text format.

    Replaces the reference's Kamon InfluxDBReporter push loop
    (Main.scala:40-43, application.conf:54-77) with the pull model native to
    the k8s deployments in kube/.

    `render` (default: the registry's own `prometheus_text`) produces the
    exposition body; `refresh`, when given, runs before each render — the
    cluster telemetry endpoint (telemetry/aggregate.ClusterExporter) uses
    it to trigger the master's throttled scrape, so both endpoints share
    ONE routing/header/threading implementation.
    """

    def __init__(self, metrics: Optional[Metrics], port: int,
                 host: str = "0.0.0.0", render=None, refresh=None):
        self.metrics = metrics
        self.render = render or metrics.prometheus_text
        self.refresh = refresh

        outer = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802
                # route properly: the metrics body answers /metrics ONLY
                # (scrapers probing / or /favicon.ico must not get — and
                # cache — a copy of the whole exposition)
                if self.path.split("?", 1)[0] != "/metrics":
                    body = b"not found; metrics are at /metrics\n"
                    self.send_response(404)
                    self.send_header("Content-Type", "text/plain")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                if outer.refresh is not None:
                    try:
                        outer.refresh()
                    except Exception:  # noqa: BLE001 - serve the stale view
                        pass
                body = outer.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = http.server.ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        daemon=True)

    def start(self) -> "PrometheusExporter":
        self._thread.start()
        return self

    def stop(self) -> None:
        # shutdown() handshakes with serve_forever and BLOCKS FOREVER if
        # the serving thread never ran — a constructed-but-never-started
        # exporter (a router torn down before start()) must still close
        # its bound socket without hanging the caller
        if self._thread.is_alive():
            self._server.shutdown()
        self._server.server_close()


class InfluxPusher:
    """Background InfluxDB line-protocol pusher — the reference's
    `record=true` behavior (Kamon InfluxDBReporter: 1 s tick shipping to
    influxdb:8086, Main.scala:40-43 + application.conf:54-78).

    POSTs `Metrics.influx_lines()` to `url` (an InfluxDB write endpoint,
    e.g. ``http://influxdb:8086/write?db=dsgd``) every `interval_s`.
    Push failures never raise into training: they are counted under
    `metrics.push.errors` and logged once per failure streak.
    """

    def __init__(self, metrics: Metrics, url: str, interval_s: float = 1.0,
                 timeout_s: float = 2.0):
        self.metrics = metrics
        self.url = url
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="influx-push")
        self._failing = False

    def push_once(self) -> bool:
        """One push; returns True on success (separated for tests)."""
        import logging
        import urllib.request

        body = self.metrics.influx_lines().encode()
        if not body:
            return True
        try:
            req = urllib.request.Request(
                self.url, data=body, method="POST",
                headers={"Content-Type": "text/plain; charset=utf-8"},
            )
            with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
                ok = 200 <= resp.status < 300
        except Exception as e:  # noqa: BLE001 - shipping must never kill training
            self.metrics.counter("metrics.push.errors").increment()
            if not self._failing:
                logging.getLogger("dsgd.metrics").warning(
                    "influx push to %s failing (%s); will keep retrying "
                    "silently", self.url, e)
                self._failing = True
            return False
        if ok:
            self._failing = False
        else:
            # Non-2xx that urllib did not raise on (e.g. a 3xx from a proxy)
            # is still a dropped push — same accounting as the except path.
            self.metrics.counter("metrics.push.errors").increment()
            if not self._failing:
                logging.getLogger("dsgd.metrics").warning(
                    "influx push to %s returned non-2xx status %s; will keep "
                    "retrying silently", self.url, resp.status)
                self._failing = True
        return ok

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.push_once()

    def start(self) -> "InfluxPusher":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=self.timeout_s + self.interval_s)
        self.push_once()  # final flush, best-effort
