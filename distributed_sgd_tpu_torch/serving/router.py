"""Serving-fleet router: health-aware load balancing, hedged failover,
canary-gated delta checkpoint distribution.

The port's copy of the JAX package's serving/router.py, on the same wire:
a JAX router balances over port replicas and a port router over JAX
ones, and both reach the same canary verdict on the same probe set.  The
router does no tensor work on the card (the JAX router none on its
accelerator): balancing is host bookkeeping, and the canary's probe loss
is computed on the host from the margins the replicas answer.

The router speaks the SAME ``dsgd.Serving`` service as a replica
(rpc/service.py ``_SERVE_METHODS``), so clients — and kube Services —
cannot tell one node from a fleet:

- **Predict** routes to one of N shared-nothing replicas by
  power-of-two-choices: sample two eligible replicas, send to the one
  with the lower ``EWMA latency x (1 + in-flight)`` score.  Eligible =
  last ``ServeHealth`` ok AND per-replica circuit breaker not suppressing
  (reusing rpc/service.py ``RpcPolicy``/``CircuitBreaker`` — the PR-4
  control-plane policy).  A failed call fails over to the next-best
  replica (the client sees ONE answer or one typed error, never a
  dropped request); with ``hedge_ms`` set, a reply slower than the hedge
  deadline additionally races a duplicate on the next-best replica and
  the first success wins — the in-flight tail of a dying replica drains
  onto the rest of the fleet.
- **PushWeights** is the fleet's checkpoint-distribution entry point: the
  trainer's master streams versioned weight updates (full tensor or the
  sparse absolute-value ``WeightDelta`` codec the sync broadcast plane
  uses, rpc/codec.py) to the ROUTER, which fans them out — through its
  canary gate when configured.  A new version lands on the first
  ``ceil(canary_fraction x N)`` replicas only; the router then evaluates
  the held-out probe set against a canary replica and compares the probe
  loss to the promoted baseline (core/loss_check.py ``LossChecker``
  best-loss tracking, the HealthMonitor's ratio-x-best rule).  Pass ->
  the push fans out to the rest and the version is PROMOTED; regression
  -> the canaries are rolled back to the promoted weights, the version
  is rejected (re-pushes NACK), and ``router.canary.rollback`` counts it.
- **ServeHealth** aggregates the fleet (ok = any replica serving).
  **Metrics** answers UNIMPLEMENTED, and the JAX router's fleet telemetry
  endpoint (``telemetry_port``) raises: the cluster telemetry scrape
  waits for ROADMAP.md Queue A [A13] item 8.

Wired into main.py as ``DSGD_ROLE=route``; knobs in config.py
(``DSGD_SERVE_TARGETS`` etc.); in-process fleet harness in
serving/fleet.py.
"""

from __future__ import annotations

import json
import logging
import math
import os
import random
import threading
import time
from typing import List, Optional, Sequence, Tuple

import grpc
import numpy as np
import torch

from distributed_sgd_tpu_torch.core.loss_check import LossChecker
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.rpc import codec
from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import (
    RpcPolicy,
    ServeStub,
    add_serve_servicer,
    new_channel,
    new_server,
)
from distributed_sgd_tpu_torch.serving.server import METRICS_NOT_PORTED
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import measure
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod
from distributed_sgd_tpu_torch.utils.fsio import atomic_write_json

log = logging.getLogger("dsgd.serving")

# gRPC codes that are the CALLER's fault (or backpressure), not the
# replica's: they never feed the replica's circuit breaker, and
# INVALID_ARGUMENT is not even worth a failover (every replica serves the
# same model dimension).
_NOT_PEER_FAILURE = frozenset({
    grpc.StatusCode.INVALID_ARGUMENT,
    grpc.StatusCode.RESOURCE_EXHAUSTED,
})


class _Replica:
    """One backend's routing state: stub + EWMA latency + in-flight count
    + health + the shared per-peer breaker."""

    EWMA_ALPHA = 0.2  # same smoothing family as core/master._LatencyEwma

    def __init__(self, host: str, port: int, policy: RpcPolicy):
        self.host, self.port = host, int(port)
        self.key = (host, int(port))
        self.channel = new_channel(host, int(port))
        self.stub = ServeStub(self.channel)
        self.breaker = policy.breaker(self.key)
        # optimistic prior: an unmeasured replica must be pickable, and a
        # small prior latency lets the first real measurements dominate
        self.ewma_s = 0.010
        self.inflight = 0
        self._lock = threading.Lock()
        # healthy only after a ServeHealth returns ok=True — the router
        # never routes to a replica it has not seen alive
        self.healthy = False
        self.model_step = 0

    @property
    def endpoint(self) -> str:
        return f"{self.host}:{self.port}"

    def score(self) -> float:
        """Power-of-two-choices score: lower is better.  EWMA latency
        weighted by the in-flight count, so a slow replica AND a busy
        replica both lose the coin flip."""
        return self.ewma_s * (1.0 + self.inflight)

    def begin(self) -> None:
        with self._lock:
            self.inflight += 1

    def end(self) -> None:
        with self._lock:
            self.inflight -= 1

    def ok(self, latency_s: float) -> None:
        self.ewma_s += self.EWMA_ALPHA * (latency_s - self.ewma_s)
        self.breaker.record_ok()

    def close(self) -> None:
        self.channel.close()


def load_probe(path: str) -> List[Tuple[np.ndarray, np.ndarray, float]]:
    """Load a canary probe set from an .npz of padded 2-D `indices` /
    `values` plus 1-D `labels`; zero-VALUE cells are padding (the same
    inert-pad convention as serving/bucketing.py) and are stripped per
    row.  Returns the [(indices, values, label)] rows the router wants."""
    with np.load(path) as z:
        idx, val, y = z["indices"], z["values"], z["labels"]
    rows = []
    for i in range(len(y)):
        nz = val[i] != 0
        rows.append((np.asarray(idx[i][nz], np.int32),
                     np.asarray(val[i][nz], np.float32), float(y[i])))
    return rows


def probe_from_dataset(data, n: int = 64) -> List[Tuple[np.ndarray, np.ndarray, float]]:
    """First `n` rows of a Dataset as probe rows (held-out split — the
    canary baseline must not be the training data)."""
    rows = []
    for i in range(min(n, len(data))):
        idx, val = data.indices[i], data.values[i]
        nz = val != 0
        rows.append((np.asarray(idx[nz], np.int32),
                     np.asarray(val[nz], np.float32), float(data.labels[i])))
    return rows


class ServingRouter:
    """N-replica Predict router + canary-gated PushWeights fan-out."""

    # canary regression rule (the HealthMonitor/parity-gate family): the
    # probe loss of a new version regresses when it exceeds
    # max(ratio * best, best + abs_floor) — the absolute floor keeps the
    # relative bound meaningful near zero loss.
    CANARY_ABS_FLOOR = 0.02

    def __init__(
        self,
        replicas: Sequence[Tuple[str, int]],
        port: int = 0,
        host: str = "0.0.0.0",
        model: str = "hinge",
        lam: float = 1e-5,
        canary_fraction: float = 0.0,
        canary_ratio: float = 1.05,
        probe: Optional[Sequence[Tuple[np.ndarray, np.ndarray, float]]] = None,
        hedge_ms: float = 0.0,
        health_s: float = 1.0,
        request_timeout_s: float = 30.0,
        policy: Optional[RpcPolicy] = None,
        metrics=None,
        telemetry_port: Optional[int] = None,
        seed: int = 0,
        state_path: Optional[str] = None,
        probe_path: Optional[str] = None,
        probe_refresh_s: float = 0.0,
        probe_source=None,
        probe_source_refresh_s: float = 0.0,
    ):
        if not replicas:
            raise ValueError("a router needs at least one replica endpoint")
        if probe_refresh_s > 0 and not probe_path:
            raise ValueError(
                "probe_refresh_s needs probe_path: the refresh re-reads "
                "the probe file on its cadence")
        if probe_source_refresh_s > 0 and probe_source is None:
            raise ValueError(
                "probe_source_refresh_s needs probe_source: the cadence "
                "rotates the traffic reservoir into the probe set")
        if probe_source is not None and probe_refresh_s > 0:
            raise ValueError(
                "probe_source and probe_refresh_s are mutually exclusive: "
                "the reservoir REPLACES the operator-rotated probe file — "
                "two refresh feeds would fight over the canary baseline")
        if not 0.0 <= canary_fraction <= 1.0:
            raise ValueError("canary_fraction must be in [0, 1]")
        if telemetry_port is not None:
            raise NotImplementedError(
                "the router's fleet telemetry endpoint (DSGD_TELEMETRY): not ported "
                "yet (ROADMAP.md Queue A [A13] item 8)")
        if metrics is None:
            # fresh per-router registry, NOT the process global: an HA pair
            # runs two routers in one process (tests, fleet drills), each
            # under its own `route:<port>` label.
            metrics = metrics_mod.Metrics()
        self.metrics = metrics
        self._policy = policy or RpcPolicy(seed=seed, metrics=metrics)
        self._replicas = [_Replica(h, p, self._policy) for h, p in replicas]
        self._rng = random.Random(seed)
        self._timeout = float(request_timeout_s)
        self._hedge_s = max(0.0, float(hedge_ms)) / 1000.0
        self.health_s = float(health_s)
        self._stop = threading.Event()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True, name="route-health")

        # -- canary state (all under _push_lock) ---------------------------
        # RLock: the HA coordinator's lease refresh can detect a failover
        # while a PushWeights verdict (which holds this lock) asks
        # is_decider(), and the assume-lease re-pin then re-enters
        self._push_lock = threading.RLock()
        self.canary_fraction = float(canary_fraction)
        self.canary_ratio = float(canary_ratio)
        self._probe = list(probe) if probe else None
        # probe-set refresh (DSGD_SERVE_PROBE_REFRESH_S): with
        # a cadence > 0 the health loop re-reads `probe_path` every
        # refresh period (mtime-gated — an untouched file costs a stat)
        # and rotates the fresh held-out rows in through refresh_probe(),
        # re-anchoring the canary baseline on the PROMOTED version's loss
        # over the new rows.  0 (default): fixed probe set, byte-identical
        # canary behavior.
        self._probe_path = probe_path
        self._probe_refresh_s = max(0.0, float(probe_refresh_s))
        self._probe_mtime: Optional[float] = None
        self._probe_next_check = 0.0
        if probe_path:
            try:
                self._probe_mtime = os.path.getmtime(probe_path)
            except OSError:
                self._probe_mtime = None
        # live probe sourcing (the JAX package's autopilot/probe_source.py;
        # DSGD_AUTOPILOT waits for ROADMAP.md Queue A [A13] item 8): with a
        # reservoir attached, every routed Predict feeds it, and
        # the health loop rotates the sampled rows in through
        # refresh_probe() on its own cadence — each rotation re-probes the
        # PROMOTED version on traffic sampled just now, so the refresh
        # loss series (probe_losses()) is the drift signal the autopilot
        # controller watches.  None (default): the Predict path is
        # untouched and no series accumulates.
        self._probe_source = probe_source
        self._probe_source_refresh_s = max(0.0, float(probe_source_refresh_s))
        self._source_next_check = 0.0
        self._probe_loss_hist: List[float] = []
        self._model_name, self._lam = model, float(lam)
        self._probe_model = None  # built lazily (losses_from_margins only)
        self._promoted_version: Optional[int] = None
        self._w_promoted: Optional[np.ndarray] = None
        self._rejected: set = set()
        # probe-loss baseline across promoted versions: LossChecker's
        # best-loss tracking (core/loss_check.py), leaky=1.0 — each
        # version is judged on its RAW probe loss against the best ever
        self._checker = LossChecker(leaky_loss=1.0)
        # promoted-state persistence (DSGD_SERVE_STATE): a
        # JSON sidecar rewritten atomically on every promote/rollback.  A
        # RESTARTED router restores the promoted version, the probe-loss
        # baseline, and the rejected set — so when the distributor
        # re-streams the already-promoted version it RE-PINS it (ungated
        # fan-out) instead of re-canarying it, and an already-rejected
        # version stays rejected.  None (default): in-memory only.
        self._state_path = state_path
        # serving-plane HA (serving/ha.py, DSGD_SERVE_HA): the sidecar is
        # a VERSIONED record — `seq` numbers every promote/rollback/
        # baseline transition monotonically, so two LIVE routers (and a
        # rejoining one) can totally order their records and the higher
        # seq wins every exchange.  Only the decider lease holder bumps
        # seq (single-writer counter); the mirror's record advances by
        # ADOPTING the decider's over SyncServeState.  _ha is the
        # attached HACoordinator (None = HA off, nothing here runs);
        # _ha_pending caches the weights of a push this router DEFERRED
        # as non-decider, so the peer-synced promotion can pin them.
        self._state_seq = 0
        self._ha = None
        self._ha_pending: Optional[Tuple[int, np.ndarray]] = None
        self._restore_state()

        self._server = new_server(port, host=host)
        add_serve_servicer(self._server, self,
                           node=f"route:{self._server.bound_port}")
        self._node = f"route:{self._server.bound_port}"

    # -- replica selection ---------------------------------------------------

    def _eligible(self, exclude: Sequence["_Replica"] = ()) -> List["_Replica"]:
        return [
            r for r in self._replicas
            if r not in exclude and r.healthy and not r.breaker.suppressed()
        ]

    def _pick(self, exclude: Sequence["_Replica"] = ()) -> Optional["_Replica"]:
        """Power-of-two-choices over the eligible set; falls back to ANY
        non-excluded replica when the eligible set is empty (a request in
        hand beats a perfect rotation — the call itself is the probe)."""
        pool = self._eligible(exclude)
        if not pool:
            pool = [r for r in self._replicas if r not in exclude]
        if not pool:
            return None
        if len(pool) == 1:
            return pool[0]
        a, b = self._rng.sample(pool, 2)
        return a if a.score() <= b.score() else b

    # -- the data plane ------------------------------------------------------

    def Predict(self, request, context):  # noqa: N802 - gRPC method name
        if self._probe_source is not None:
            # feed the probe reservoir from live traffic.  Canary probe
            # evaluations go straight to replica stubs (_probe_loss), not
            # through this handler, so the probe set never samples itself.
            try:
                self._probe_source.observe(
                    np.asarray(request.indices, np.int32),
                    np.asarray(request.values, np.float32))
            except Exception as e:  # noqa: BLE001 - sampling must not drop a request
                log.warning("probe-source observe failed: %s", e)
        tried: List[_Replica] = []
        last: Optional[grpc.RpcError] = None
        with measure.span("route.predict", metrics=self.metrics, root=False):
            for _attempt in range(len(self._replicas)):
                r = self._pick(exclude=tried)
                if r is None:
                    break
                try:
                    return self._call_predict(r, request)
                except grpc.RpcError as e:
                    if e.code() == grpc.StatusCode.INVALID_ARGUMENT:
                        # caller error: every replica would reject it too
                        context.abort(e.code(), e.details())
                    last = e
                    tried.append(r)
                    self.metrics.counter(metrics_mod.ROUTER_RETRIES).increment()
        if last is not None:
            context.abort(last.code() or grpc.StatusCode.UNAVAILABLE,
                          f"all replicas failed; last: {last.details()}")
        context.abort(grpc.StatusCode.UNAVAILABLE,
                      "no serving replica available")

    def _call_predict(self, r: _Replica, request):
        """One routed attempt, hedged past the tail when configured.
        Raises grpc.RpcError on failure (the failover loop owns retries);
        feeds the replica's breaker and latency EWMA."""
        t0 = time.perf_counter()
        r.begin()
        hedge: Optional[Tuple[_Replica, object]] = None
        try:
            fut = r.stub.Predict.future(request, timeout=self._timeout)
            if self._hedge_s > 0:
                try:
                    reply = fut.result(timeout=self._hedge_s)
                    r.ok(time.perf_counter() - t0)
                    return reply
                except grpc.FutureTimeoutError:
                    h = self._pick(exclude=(r,))
                    hfut = None
                    t_hedge = time.perf_counter()
                    if h is not None:
                        h.begin()
                        hedge = (h, hfut)  # end() in finally even if
                        try:               # the future never constructs
                            hfut = h.stub.Predict.future(
                                request, timeout=self._timeout)
                        except Exception:  # noqa: BLE001 - channel closed
                            hfut = None
                    if hfut is not None:
                        self.metrics.counter(
                            metrics_mod.ROUTER_HEDGES).increment()
                        winner, reply = self._race([(r, fut), (h, hfut)])
                        # each attempt's EWMA sees ITS OWN latency: a
                        # winning hedge charged from the primary's start
                        # would inflate the fast replica by hedge_ms and
                        # steer p2c away from it
                        winner.ok(time.perf_counter()
                                  - (t_hedge if winner is h else t0))
                        if winner is h:
                            self.metrics.counter(
                                metrics_mod.ROUTER_HEDGE_WINS).increment()
                        return reply
            reply = fut.result()  # raises the RpcError on failure
            r.ok(time.perf_counter() - t0)
            return reply
        except grpc.RpcError as e:
            if e.code() not in _NOT_PEER_FAILURE:
                r.breaker.record_failure()
            raise
        finally:
            r.end()
            if hedge is not None:
                hedge[0].end()

    @staticmethod
    def _race(pairs):
        """(winner, reply) of the first future to SUCCEED; the loser is
        cancelled.  When every future fails, re-raises the PRIMARY's
        error (pairs[0]) — the failover loop then excludes the primary."""
        ev = threading.Event()
        for _rep, f in pairs:
            f.add_done_callback(lambda _f: ev.set())
        while True:
            done = [(rep, f) for rep, f in pairs if f.done()]
            for rep, f in done:
                if not f.cancelled() and f.exception() is None:
                    for _rep2, f2 in pairs:
                        if f2 is not f:
                            f2.cancel()
                    return rep, f.result()
            if len(done) == len(pairs):
                raise pairs[0][1].exception()
            ev.wait(0.05)
            ev.clear()

    # -- health / draining ---------------------------------------------------

    def _health_pass(self) -> None:
        for r in self._replicas:
            try:
                h = r.stub.ServeHealth(
                    pb.Empty(), timeout=min(self._policy.deadline_s,
                                            max(self.health_s, 0.1)))
                now_ok = bool(h.ok)
                r.model_step = int(h.model_step)
                r.breaker.record_ok()
            except grpc.RpcError:
                now_ok = False
                r.breaker.record_failure()
            if r.healthy and not now_ok:
                # drain: no NEW picks route here; in-flight calls finish
                # (or fail over), so the drain drops zero requests
                self.metrics.counter(metrics_mod.ROUTER_DRAINED).increment()
                flight.record("router.replica.drained", peer=r.endpoint)
                log.warning("replica %s drained (health failed or not ready)",
                            r.endpoint)
            r.healthy = now_ok
        self.metrics.gauge(metrics_mod.ROUTER_ELIGIBLE).set(
            len(self._eligible()))

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_s):
            self._health_pass()
            if self._probe_refresh_s > 0:
                self._maybe_refresh_probe()
            if self._probe_source is not None and self._probe_source_refresh_s > 0:
                self._maybe_refresh_from_source()

    # -- canary probe-set refresh ----------------------------------------------

    def refresh_probe(self, rows) -> None:
        """Rotate a fresh held-out probe set in and re-anchor the canary
        baseline (DSGD_SERVE_PROBE_REFRESH_S).

        The old baseline was measured on the OLD rows — comparing a new
        version's loss on the new rows against it would gate against an
        apples-to-oranges number, so the PROMOTED version is re-evaluated
        on the new rows (through the eligible replicas, exactly the
        canary probe path) and becomes the new baseline via
        `LossChecker.refresh`.  If the promoted version cannot be probed
        right now (no replica answered), the checker goes baseline-less
        and the next canary pass seeds it — a long-running fleet's gate
        tracks live traffic instead of fossilizing on the rows it started
        with.  Rejected versions STAY rejected: rejection was a verdict
        against the fleet state at the time, and un-rejecting on a probe
        rotation would re-open every previously failed version at once."""
        rows = list(rows)
        if not rows:
            raise ValueError("refresh_probe needs a non-empty probe set")
        with self._push_lock:
            self._probe = rows
            loss = None
            if self._promoted_version is not None:
                loss = self._probe_loss(self._eligible() or self._replicas,
                                        self._promoted_version)
            self._checker.refresh(best_loss=loss)
            if loss is not None and np.isfinite(loss):
                self.metrics.gauge(metrics_mod.ROUTER_CANARY_LOSS).set(loss)
            if loss is not None:
                # the refresh-loss series: promoted version vs the rows
                # live traffic produced NOW — the autopilot drift signal
                self._probe_loss_hist.append(float(loss))
            self.metrics.counter(
                metrics_mod.ROUTER_PROBE_REFRESH).increment()
            self._state_transition()
            self._persist_state()
        log.info(
            "canary probe set refreshed (%d rows): baseline re-anchored to "
            "%s", len(rows),
            f"promoted v{self._promoted_version} loss {loss:.6f}"
            if loss is not None else "none (next canary pass seeds it)")

    def _maybe_refresh_probe(self) -> None:
        """Health-loop tick: re-read `probe_path` once per refresh period,
        rotating it in only when the file actually changed (mtime)."""
        now = time.monotonic()
        if now < self._probe_next_check:
            return
        self._probe_next_check = now + self._probe_refresh_s
        try:
            mtime = os.path.getmtime(self._probe_path)
        except OSError:
            return  # rotated away mid-write / not there yet: next period
        if self._probe_mtime is not None and mtime <= self._probe_mtime:
            return
        # record the mtime up front so a persistently bad file is warned
        # about ONCE per rewrite, not re-parsed and re-warned every period
        self._probe_mtime = mtime
        try:
            rows = load_probe(self._probe_path)
            self.refresh_probe(rows)
        except Exception as e:  # noqa: BLE001 - a bad file must not kill health
            log.warning("probe refresh from %s failed: %s",
                        self._probe_path, e)

    def _maybe_refresh_from_source(self) -> None:
        """Health-loop tick: once per source-refresh period, rotate the
        traffic reservoir's current sample in as the probe set.  Unlike
        the file feed there is no mtime to gate on — the reservoir
        evolves with every request — so every period with a ready
        (min-fill reached) reservoir refreshes, and each refresh
        re-probes the promoted version on just-sampled traffic: the
        probe-loss series the autopilot controller reads."""
        now = time.monotonic()
        if now < self._source_next_check:
            return
        self._source_next_check = now + self._probe_source_refresh_s
        if not self._probe_source.ready():
            return
        rows = self._probe_source.rows()
        try:
            self.refresh_probe(rows)
        except Exception as e:  # noqa: BLE001 - a bad refresh must not kill health
            log.warning("probe refresh from traffic reservoir failed: %s", e)
            return
        self.metrics.counter(metrics_mod.ROUTER_PROBE_SOURCED).increment()
        self.metrics.gauge(metrics_mod.ROUTER_PROBE_FILL).set(
            self._probe_source.fill)

    # -- the autopilot's read side ---------------------------------------------

    def probe_losses(self) -> List[float]:
        """The probe-refresh loss series, oldest first: the promoted
        version's loss on each successive probe rotation.  Floats only,
        appended once per refresh — bounded by process lifetime at the
        refresh cadence, read by AutopilotController."""
        with self._push_lock:
            return list(self._probe_loss_hist)

    @property
    def promoted_version(self) -> Optional[int]:
        return self._promoted_version

    # -- checkpoint distribution + canary (PushWeights) ----------------------

    def _canary_count(self) -> int:
        if self.canary_fraction <= 0 or self._probe is None:
            return 0
        return min(len(self._replicas),
                   max(1, math.ceil(self.canary_fraction * len(self._replicas))))

    def _resolve_weights(self, request) -> Optional[np.ndarray]:
        """The pushed version's FULL weight vector, reconstructed on the
        router's own promoted cache (the rollback needs it); None = the
        delta's base is not our promoted version (NACK: the pusher
        resends full, exactly like a replica's version gap)."""
        if request.HasField("weights"):
            return codec.decode_tensor(request.weights)
        if (request.HasField("delta") and self._w_promoted is not None
                and self._promoted_version == request.delta.base_version):
            return codec.apply_weight_delta(self._w_promoted, request.delta)
        return None

    def _fan_out(self, request, replicas: Sequence["_Replica"]) -> int:
        """Concurrent PushWeights to `replicas`; returns how many acked ok.
        Send bytes are accounted per DELIVERED send (the comms.* send-side
        pattern; a transport failure ships nothing and must not pad the
        fleet's wire-savings ratio); a NACK counts
        serve.push.nack (the replica already fell back to a full-file
        reload on its side)."""
        futs = []
        form = "delta" if request.HasField("delta") else "full"
        dense = 4 * (len(self._w_promoted) if self._w_promoted is not None
                     else request.weights.size)
        for r in replicas:
            try:
                futs.append((r, r.stub.PushWeights.future(
                    request, timeout=self._policy.deadline_s)))
            except Exception:  # noqa: BLE001 - channel closed under us
                self.metrics.counter(metrics_mod.SERVE_PUSH_ERRORS).increment()
        acked = 0
        for r, f in futs:
            try:
                reply = f.result()
                metrics_mod.record_push(self.metrics, form,
                                        request.ByteSize(), dense)
                if reply.ok:
                    acked += 1
                else:
                    self.metrics.counter(
                        metrics_mod.SERVE_PUSH_NACK).increment()
            except grpc.RpcError:
                self.metrics.counter(metrics_mod.SERVE_PUSH_ERRORS).increment()
                r.breaker.record_failure()
        return acked

    def _probe_loss(self, canaries: Sequence["_Replica"],
                    version: int) -> Optional[float]:
        """Mean probe-set loss served by a canary replica at `version`;
        None when no canary answered the whole probe (treated as a failed
        canary by the caller).  Host work on the replicas' margins: the
        router holds no tensor on the card."""
        if self._probe_model is None:
            # losses_from_margins is all the router needs: margin -> loss
            # is dimension-free, so n_features=1 and no regularizer
            self._probe_model = make_model(
                self._model_name, self._lam, 1, regularizer="none", device="cpu")
        for r in canaries:
            margins, ys = [], []
            try:
                for idx, val, y in self._probe:
                    reply = r.stub.Predict(
                        pb.PredictRequest(indices=idx, values=val),
                        timeout=self._policy.deadline_s)
                    if reply.model_step != version:
                        raise ValueError(
                            f"canary {r.endpoint} answered from step "
                            f"{reply.model_step}, not {version}")
                    margins.append(reply.margin)
                    ys.append(y)
            except (grpc.RpcError, ValueError) as e:
                log.warning("canary probe against %s failed: %s", r.endpoint, e)
                continue
            losses = self._probe_model.losses_from_margins(
                torch.tensor(margins, dtype=torch.float32),
                torch.tensor(ys, dtype=torch.float32))
            return float(losses.mean())
        return None

    def _regressed(self, loss: float) -> bool:
        if not np.isfinite(loss):
            return True  # NaN/Inf probe margins: a genuinely poisoned model
        best = self._checker.best_loss
        if best == float("inf"):
            return False  # no baseline yet: first version promotes
        return loss > max(self.canary_ratio * best, best + self.CANARY_ABS_FLOOR)

    # -- promoted-state persistence (DSGD_SERVE_STATE) ------------------------

    def _restore_state(self) -> None:
        """Load the promoted-state sidecar (no-op when unset/absent).  The
        promoted WEIGHTS are not persisted — only their version and the
        probe baseline — so the restored router NACKs deltas against the
        unknown base (the pusher resends full, its normal gap path) and
        re-pins the promoted version ungated when it arrives."""
        if not self._state_path or not os.path.exists(self._state_path):
            return
        try:
            with open(self._state_path) as f:
                state = json.load(f)
            # conversions INSIDE the guard: a sidecar that parses as JSON
            # but carries garbage values (hand edit, foreign writer) must
            # also land on the starting-fresh path, not crash startup
            promoted = state.get("promoted_version")
            promoted = None if promoted is None else int(promoted)
            rejected = set(int(v) for v in state.get("rejected", []))
            best = state.get("best_loss")
            best = None if best is None else float(best)
            seq = int(state.get("seq", 0))
        except (OSError, ValueError, TypeError, AttributeError) as e:
            # quarantine, don't delete: the operator can inspect what a
            # crashed/foreign writer left behind, and the rename also
            # stops every subsequent restart from re-parsing (and
            # re-warning about) the same bad bytes
            quarantine = self._state_path + ".corrupt"
            try:
                os.replace(self._state_path, quarantine)
            except OSError:
                quarantine = "<quarantine failed>"
            log.warning("router state %s unreadable (%s); quarantined to "
                        "%s and starting fresh", self._state_path, e,
                        quarantine)
            return
        self._state_seq = seq
        if promoted is not None:
            self._promoted_version = promoted
        self._rejected = rejected
        if best is not None:
            # seed the LossChecker baseline without weights: best_loss is
            # the only field the canary rule reads (leaky=1.0 checker)
            self._checker.best_loss = best
        if self._probe_source is not None and state.get("probe_source"):
            # restore the traffic reservoir: counters + rows + pending
            # lane, so the counter-derived Algorithm-R draw resumes the
            # exact sampling sequence the pre-restart router was on
            try:
                self._probe_source.load_state(state["probe_source"])
            except (KeyError, ValueError, TypeError) as e:
                log.warning("probe-source state in %s unreadable (%s); "
                            "reservoir starts empty", self._state_path, e)
        log.info(
            "router state restored from %s: promoted version %s, "
            "baseline %s, %d rejected", self._state_path,
            self._promoted_version, best, len(self._rejected))

    def _persist_state(self) -> None:
        """Atomically rewrite the sidecar (tmp + replace) after every
        promote/rollback; called under _push_lock."""
        if not self._state_path:
            return
        best = self._checker.best_loss
        state = {
            "seq": self._state_seq,
            "promoted_version": self._promoted_version,
            "best_loss": best if best != float("inf") else None,
            "rejected": sorted(self._rejected),
        }
        if self._probe_source is not None:
            # bounded by construction (capacity + label_delay rows), so
            # the sidecar stays a small JSON file
            state["probe_source"] = self._probe_source.state_dict()
        try:
            atomic_write_json(self._state_path, state)
        except OSError as e:  # persistence must never fail a push
            log.warning("router state write to %s failed: %s",
                        self._state_path, e)

    def _state_transition(self) -> None:
        """Under _push_lock, on every promote/rollback/baseline change:
        advance the versioned record's seq and wake the HA sync loop so
        the peer mirrors the transition NOW, not a sync interval later.
        Only the decider bumps — a mirror's local edits (e.g. its own
        probe refresh) must not outrank the decider's verdicts."""
        if self._ha is None or self._ha.is_decider():
            self._state_seq += 1
        if self._ha is not None:
            self._ha.notify()

    def _promote(self, version: int, w: np.ndarray,
                 loss: Optional[float]) -> None:
        self._promoted_version = int(version)
        self._w_promoted = np.asarray(w, np.float32)
        if loss is not None and np.isfinite(loss):
            self._checker.check(loss, 0.0, self._w_promoted, step=version)
            self.metrics.gauge(metrics_mod.ROUTER_CANARY_LOSS).set(loss)
        self.metrics.counter(metrics_mod.ROUTER_CANARY_PROMOTED).increment()
        self._state_transition()
        self._persist_state()
        log.info("version %d promoted fleet-wide (probe loss %s)",
                 version, f"{loss:.6f}" if loss is not None else "n/a")

    def _repin(self, canaries: Sequence["_Replica"]) -> bool:
        """Re-install the promoted weights on the canary subset (a full
        push — apply_push is authoritative at any version).  Returns
        whether a re-pin was actually sent."""
        if self._w_promoted is None:
            # restored-state router that has not yet re-received the
            # promoted weights: nothing to re-install — the canaries heal
            # when the promoted version is re-streamed (re-pin path / gap
            # fallback); callers must not claim a re-pin happened
            log.warning("cannot re-pin canaries: promoted weights not in "
                        "cache yet (restored state)")
            return False
        req = pb.PushWeightsRequest(version=self._promoted_version)
        req.weights.CopyFrom(codec.encode_tensor(self._w_promoted))
        self._fan_out(req, canaries)
        return True

    def _rollback(self, version: int, canaries: Sequence["_Replica"],
                  loss: float) -> None:
        self._rejected.add(int(version))
        self._state_transition()
        self._persist_state()
        self.metrics.counter(metrics_mod.ROUTER_CANARY_ROLLBACK).increment()
        flight.record("router.canary.rollback", version=int(version),
                      probe_loss=loss, baseline=self._checker.best_loss)
        repinned = self._repin(canaries)
        log.warning(
            "version %d ROLLED BACK (probe loss %.6f vs baseline %.6f): %s",
            version, loss, self._checker.best_loss,
            f"canaries re-pinned to promoted version {self._promoted_version}"
            if repinned else
            f"canaries still serve the rejected weights until promoted "
            f"version {self._promoted_version} is re-streamed (restored "
            f"state has no weight cache)")

    def PushWeights(self, request, context):  # noqa: N802 - gRPC method name
        with self._push_lock:
            version = int(request.version)
            current = self._promoted_version or 0
            if version in self._rejected:
                # a rejected version stays rejected: the trainer's next
                # checkpoint gets a fresh canary instead
                return pb.PushWeightsReply(ok=False, model_step=current)
            w_new = self._resolve_weights(request)
            if w_new is None:
                self.metrics.counter(metrics_mod.SERVE_PUSH_NACK).increment()
                return pb.PushWeightsReply(ok=False, model_step=current)
            if self._ha is not None and not self._ha.is_decider():
                # non-decider LIVE router (DSGD_SERVE_HA): promote/
                # rollback/canary verdicts belong to the lease holder —
                # two routers fronting the same replicas must not both
                # canary the same version.  The promoted version's
                # re-stream just refreshes the weight cache (the
                # post-failover re-pin needs it); anything newer is
                # DEFERRED: cache the weights and NACK, and the verdict
                # arrives over SyncServeState within one sync interval.
                w_new = np.asarray(w_new, np.float32)
                if version == self._promoted_version:
                    self._w_promoted = w_new
                    return pb.PushWeightsReply(ok=True, model_step=version)
                self._ha_pending = (version, w_new)
                self.metrics.counter(
                    metrics_mod.ROUTER_HA_DEFERRED).increment()
                return pb.PushWeightsReply(ok=False, model_step=current)
            # reply `ok` is the ROUTER's accept/reject decision ONLY
            # (promoted vs canary-rejected/version-gap) — NOT fan-out
            # completeness: a down replica is the router's problem (its
            # health loop drains it, and the replica's own version-gap
            # file fallback heals it on rejoin).  Folding partial fan-out
            # failure into ok would make the pusher treat every push
            # during one replica's outage as a NACK — full-form resends
            # of already-promoted versions, re-running the canary probe
            # and forfeiting the delta savings the feature exists for.
            if (self._promoted_version is not None
                    and version == self._promoted_version
                    and self._w_promoted is None):
                # the already-promoted version re-streamed after a router
                # restart (DSGD_SERVE_STATE): RE-PIN it — ungated fan-out
                # + refresh the promoted weight cache.  Re-canarying the
                # version the fleet is already serving would burn a probe
                # pass per restart and could roll back the live baseline
                # on one noisy probe.
                self._fan_out(request, self._replicas)
                self._w_promoted = np.asarray(w_new, np.float32)
                log.info("version %d re-pinned (already promoted before "
                         "restart)", version)
                return pb.PushWeightsReply(ok=True, model_step=version)
            n_canary = self._canary_count()
            gated = n_canary > 0 and self._promoted_version is not None
            if not gated:
                acked = self._fan_out(request, self._replicas)
                loss = (self._probe_loss(self._eligible() or self._replicas,
                                         version)
                        if self._probe is not None else None)
                self._promote(version, w_new, loss)
            else:
                # canaries come from the ELIGIBLE (healthy, breaker-quiet)
                # set first: a statically-indexed canary that happens to be
                # the dead replica would make every probe unevaluable and
                # freeze fleet updates while 2/3 of the fleet is healthy
                pool = self._eligible() or list(self._replicas)
                canaries = pool[:n_canary]
                rest = [r for r in self._replicas if r not in canaries]
                acked = self._fan_out(request, canaries)
                loss = self._probe_loss(canaries, version)
                if loss is None:
                    # the probe could not RUN (canaries unreachable):
                    # re-pin the canaries but do NOT reject the version —
                    # rejection is a verdict, and no verdict was reached;
                    # the pusher's next attempt retries on a fresh set
                    self._repin(canaries)
                    self.metrics.counter(
                        metrics_mod.SERVE_PUSH_ERRORS).increment()
                    log.warning("version %d not promoted: canary probe "
                                "unevaluable (no canary answered); will "
                                "retry on the next push", version)
                    return pb.PushWeightsReply(ok=False, model_step=current)
                if self._regressed(loss):
                    self._rollback(version, canaries, loss)
                    return pb.PushWeightsReply(ok=False, model_step=current)
                acked += self._fan_out(request, rest) if rest else 0
                self._promote(version, w_new, loss)
            if acked < len(self._replicas):
                log.warning("version %d promoted with %d/%d replicas acked "
                            "(the rest heal via gap fallback)",
                            version, acked, len(self._replicas))
            return pb.PushWeightsReply(ok=True, model_step=version)

    # -- serving-plane HA (serving/ha.py, DSGD_SERVE_HA) ---------------------

    def attach_ha(self, coordinator) -> "ServingRouter":
        """Wire an HACoordinator onto a constructed router (the
        coordinator derives its node label from the bound port, so this
        runs post-construction).  The caller start()s the coordinator;
        stop() here tears it down with the router."""
        self._ha = coordinator
        coordinator.attach(self)
        return self

    def export_ha_state(self) -> dict:
        """The versioned promoted-state record the sync loop ships:
        {seq, promoted, best, rejected}."""
        with self._push_lock:
            best = self._checker.best_loss
            return {
                "seq": self._state_seq,
                "promoted": self._promoted_version,
                "best": None if best == float("inf") else best,
                "rejected": sorted(self._rejected),
            }

    def _apply_ha_locked(self, record) -> bool:
        """Adopt a peer's record iff it is STRICTLY newer (higher seq) —
        the no-resurrection rule: a rollback outranks the promote it
        reverted, so a rejoining router replaying a stale promote can
        never resurrect the rolled-back version.  Called under
        _push_lock from the RPC handler and the sync loop."""
        if self._ha is None or int(record.seq) <= self._state_seq:
            return False
        self._state_seq = int(record.seq)
        promoted = (int(record.promoted_version) if record.has_promoted
                    else None)
        if promoted != self._promoted_version:
            self._promoted_version = promoted
            # the record carries no weights: pin the deferred-push cache
            # if it matches, else the cache empties and the promoted
            # version's next re-stream (or the gap fallback) refills it
            self._w_promoted = None
        self._rejected = set(int(v) for v in record.rejected)
        self._checker.best_loss = (float(record.best_loss)
                                   if record.has_best else float("inf"))
        if self._ha_pending is not None:
            pv, pw = self._ha_pending
            if promoted == pv:
                self._w_promoted = pw
                self._ha_pending = None
            elif pv in self._rejected:
                self._ha_pending = None
        self._persist_state()
        self.metrics.counter(metrics_mod.ROUTER_HA_APPLIED).increment()
        log.info("HA record seq %d adopted from peer: promoted=%s, "
                 "%d rejected", self._state_seq, promoted,
                 len(self._rejected))
        return True

    def apply_ha_record(self, record) -> bool:
        with self._push_lock:
            return self._apply_ha_locked(record)

    def SyncServeState(self, request, context):  # noqa: N802 - gRPC method name
        """Peer routers exchange versioned promoted-state records; both
        directions carry the FULL record, so one exchange converges the
        pair no matter which side is stale.  With HA off this router
        adopts nothing (applied=False) but still answers with its local
        record — a misconfigured peer learns our state instead of
        getting a hang."""
        if self._ha is not None and request.node:
            self._ha.observe_peer(str(request.node))
        with self._push_lock:
            applied = (self._apply_ha_locked(request)
                       if self._ha is not None else False)
            reply = pb.SyncServeStateReply(applied=applied,
                                           seq=self._state_seq)
            if self._promoted_version is not None:
                reply.has_promoted = True
                reply.promoted_version = int(self._promoted_version)
            best = self._checker.best_loss
            if best != float("inf"):
                reply.has_best = True
                reply.best_loss = float(best)
            reply.rejected.extend(sorted(self._rejected))
        if self._ha is not None:
            self.metrics.counter(metrics_mod.ROUTER_HA_SYNCS).increment()
        return reply

    def _on_assume_lease(self) -> None:
        """The decider lease lapsed onto this router: re-pin the mirrored
        promoted state fleet-wide so every replica serves the survivor's
        truth, whatever the dead decider was midway through.  The seq is
        NOT bumped — assuming the lease is not a state transition, and a
        rejoining ex-decider whose record is genuinely newer (it finished
        a verdict before dying) must still win the next exchange.

        The network fan-out runs OUTSIDE _push_lock (only the snapshot of
        the promoted record is taken under it): holding the lock through a
        deadline x replicas push would stall every is_decider() read,
        PushWeights, and SyncServeState exactly when the survivor must
        take over."""
        with self._push_lock:
            if self._promoted_version is None:
                return
            if self._w_promoted is None:
                # restored-state router that has not yet re-received the
                # promoted weights: nothing to re-install — the fleet
                # heals when the promoted version is re-streamed
                log.warning("cannot re-pin fleet on lease assumption: "
                            "promoted weights not in cache yet "
                            "(restored state)")
                return
            req = pb.PushWeightsRequest(version=self._promoted_version)
            req.weights.CopyFrom(codec.encode_tensor(self._w_promoted))
            replicas = list(self._replicas)
        self._fan_out(req, replicas)

    # -- fleet membership (autoscale: serving/ha.py ReplicaAutoscaler) -------

    def add_replica(self, host: str, port: int) -> "_Replica":
        """Join a replica to the live fleet (autoscale spin-up / operator
        add).  It is warmed with the cached promoted weights (full push)
        so it serves the fleet's version from its first health pass
        instead of waiting out the next checkpoint."""
        r = _Replica(host, int(port), self._policy)
        with self._push_lock:
            if self._w_promoted is not None:
                req = pb.PushWeightsRequest(version=self._promoted_version)
                req.weights.CopyFrom(codec.encode_tensor(self._w_promoted))
                self._fan_out(req, [r])
            self._replicas.append(r)
        log.info("replica %s joined the fleet (%d total)", r.endpoint,
                 len(self._replicas))
        return r

    def remove_replica(self, endpoint: str) -> bool:
        """Drain a replica out of the fleet (autoscale spin-down): it
        leaves the pick pool immediately, and any call racing the channel
        close fails over exactly like a died replica — zero drops."""
        with self._push_lock:
            victims = [r for r in self._replicas if r.endpoint == endpoint]
            if not victims:
                return False
            if len(self._replicas) - len(victims) < 1:
                raise ValueError("cannot drain the last replica")
            self._replicas = [r for r in self._replicas
                              if r.endpoint != endpoint]
        for r in victims:
            r.close()
        log.info("replica %s drained from the fleet (%d left)", endpoint,
                 len(self._replicas))
        return True

    # -- fleet health + telemetry -------------------------------------------

    def ServeHealth(self, request, context):  # noqa: N802 - gRPC method name
        serving = [r for r in self._replicas if r.healthy]
        step = (self._promoted_version
                if self._promoted_version is not None
                else max((r.model_step for r in serving), default=0))
        return pb.ServeHealthReply(
            ok=bool(serving),
            model_step=int(step),
            queue_depth=sum(r.inflight for r in self._replicas),
        )

    def Metrics(self, request, context):  # noqa: N802 - gRPC method name
        context.abort(grpc.StatusCode.UNIMPLEMENTED, METRICS_NOT_PORTED)

    # -- lifecycle -----------------------------------------------------------

    @property
    def bound_port(self) -> int:
        return self._server.bound_port

    def start(self) -> "ServingRouter":
        self._health_pass()  # route nothing before one synchronous look
        self._health_thread.start()
        self._server.start()
        log.info("routing on :%d over %d replicas (%s); canary=%g hedge=%gms",
                 self.bound_port, len(self._replicas),
                 ", ".join(r.endpoint for r in self._replicas),
                 self.canary_fraction, self._hedge_s * 1e3)
        return self

    def await_termination(self) -> None:
        self._server.wait_for_termination()

    def stop(self, grace: float = 1.0) -> None:
        self._stop.set()
        if self._ha is not None:
            self._ha.stop()
        self._server.stop(grace).wait()
        if self._health_thread.is_alive():
            self._health_thread.join(timeout=self.health_s + 1.0)
        for r in self._replicas:
            r.close()

    def __enter__(self) -> "ServingRouter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
