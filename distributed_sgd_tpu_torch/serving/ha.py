"""Serving-plane HA: dual LIVE routers with a leased decider, peer-synced
promoted state, client failover, and load-adaptive replica autoscale.

The port's copy of the JAX package's serving/ha.py: the same lease rules,
the same ``SyncServeState`` records and the same autoscale controller, so
a JAX router and a port router are HA peers of each other.

The router was the serving plane's one SPOF: a crash took down the whole
Predict path and lost in-flight canary decisions.  This module makes two
(or more) routers LIVE at once while keeping exactly one of them the
*decider* for promote/rollback/canary verdicts:

- **Lease** (``FileLease`` / ``PeerLease``): who decides.  The file
  backend is a wall-clock TTL record on shared disk (atomic_write_json —
  the sidecar discipline); the peer backend needs no shared disk: the
  lowest-ranked endpoint among the peers seen alive within the TTL holds
  the lease, liveness fed by the sync exchanges themselves.  Peers are
  presumed alive at boot, so the low-ranked router decides from the
  start and the other defers — no boot split-brain window.
- **HACoordinator**: the sync loop.  Every ``sync_s`` (and immediately
  after every local transition — ``notify()``), it renews the lease and
  exchanges the router's versioned state record with each peer over the
  ``SyncServeState`` RPC.  Both directions carry the FULL record and the
  monotonically-numbered ``seq`` totally orders transitions, so one
  exchange converges the pair no matter which side is stale and a
  rejoining router can never resurrect a rolled-back version.  When the
  lease lapses, the survivor assumes it (``router.ha.failovers``) and
  re-pins its mirrored promoted state fleet-wide.
- **FailoverServeClient**: the client-side two-target stub — tries the
  last-good router first and fails over to the next on any transport
  error, mirroring how the router already fails over between replicas.
- **ReplicaAutoscaler**: the router's existing EWMA-latency x in-flight
  signal (``router_load_ms``) driven against a p99 SLO
  (``DSGD_SERVE_SLO_MS``): sustained breach spins a replica up through
  the replica boot path, sustained idle drains one — with consecutive-tick hysteresis and a
  post-action cooldown so chaos weather cannot flap the fleet.

Default-off behind ``DSGD_SERVE_HA=peers:<host:port,...>`` and
``DSGD_SERVE_SLO_MS``; with both unset no coordinator exists, no
``SyncServeState`` RPC is ever issued, and the serving wire is
byte-identical to the single-router plane.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import grpc

from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.rpc.service import RpcPolicy, ServeStub, new_channel
from distributed_sgd_tpu_torch.serving.push import parse_targets
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod
from distributed_sgd_tpu_torch.utils.fsio import atomic_write_json

log = logging.getLogger("dsgd.serving")


def _dur(s: str) -> float:
    """'250ms' / '1.5s' / bare seconds -> float seconds (the chaos plan
    grammar's duration tokens, kept local so ha needs no chaos import)."""
    s = str(s).strip()
    if s.endswith("ms"):
        return float(s[:-2]) / 1000.0
    if s.endswith("s"):
        return float(s[:-1])
    return float(s)


def parse_ha_spec(spec: str) -> Dict[str, object]:
    """``DSGD_SERVE_HA`` grammar ->
    ``{peers, node, sync_s, lease_ttl_s, lease_path}``.

    ``peers:<host:port,...>`` names the OTHER routers (required), then
    optional ``;``-separated tokens: ``self=<host:port>`` (this router's
    own advertised endpoint — it must match what the peers list for us,
    since the peer lease ranks endpoints; defaults to
    ``127.0.0.1:<bound port>`` at attach time), ``sync=<dur>`` (state
    sync / lease renew cadence, default 250ms), ``ttl=<dur>`` (lease
    TTL, default 4x sync), ``lease=<path>`` (shared-disk file lease
    instead of the peer lease)."""
    spec = str(spec).strip()
    if not spec.startswith("peers:"):
        raise ValueError(
            f"DSGD_SERVE_HA spec {spec!r} must start with 'peers:' "
            f"(peers:<host:port,...>[;self=...][;sync=...][;ttl=...]"
            f"[;lease=...])")
    head, *extras = spec.split(";")
    peers = parse_targets(head[len("peers:"):])
    out: Dict[str, object] = {
        "peers": [f"{h}:{p}" for h, p in peers],
        "node": None, "sync_s": 0.25, "lease_ttl_s": None,
        "lease_path": None,
    }
    for token in filter(None, (t.strip() for t in extras)):
        if "=" not in token:
            raise ValueError(f"bad DSGD_SERVE_HA token {token!r} "
                             f"(want key=value)")
        key, val = (s.strip() for s in token.split("=", 1))
        if key == "self":
            parse_targets(val)  # endpoint typo fails at construction
            out["node"] = val
        elif key == "sync":
            out["sync_s"] = _dur(val)
        elif key == "ttl":
            out["lease_ttl_s"] = _dur(val)
        elif key == "lease":
            out["lease_path"] = val
        else:
            raise ValueError(f"unknown DSGD_SERVE_HA key {key!r}")
    if float(out["sync_s"]) <= 0:
        raise ValueError("DSGD_SERVE_HA sync cadence must be > 0")
    if out["lease_ttl_s"] is not None and float(out["lease_ttl_s"]) <= 0:
        raise ValueError("DSGD_SERVE_HA lease ttl must be > 0")
    return out


def _rank(endpoint: str) -> Tuple[str, int]:
    """Total order over endpoints for the peer lease (numeric port, so
    'h:9' < 'h:10' the way an operator expects)."""
    host, _, port = endpoint.rpartition(":")
    return (host, int(port))


class FileLease:
    """Shared-disk decider lease: a wall-clock TTL record rewritten
    atomically (the sidecar discipline), last writer wins.  ``acquire``
    renews our own lease, takes an absent/expired one, and defers to a
    live foreign holder."""

    def __init__(self, path: str, node: str, ttl_s: float = 1.0,
                 clock: Callable[[], float] = time.time):
        if ttl_s <= 0:
            raise ValueError("lease ttl_s must be > 0")
        self.path, self.node = str(path), str(node)
        self.ttl_s = float(ttl_s)
        self._clock = clock
        self.term = 0

    def _read(self) -> Optional[Dict]:
        try:
            with open(self.path) as f:
                rec = json.load(f)
            return {"holder": str(rec["holder"]),
                    "expiry": float(rec["expiry"]),
                    "term": int(rec.get("term", 0))}
        except (OSError, ValueError, TypeError, KeyError):
            return None  # absent or torn/corrupt: claimable

    def observe(self, peer: str) -> None:
        """Liveness rides the file, not the sync exchanges."""

    def holder(self) -> Optional[str]:
        rec = self._read()
        if rec is None or rec["expiry"] < self._clock():
            return None
        return rec["holder"]

    def acquire(self) -> bool:
        now = self._clock()
        rec = self._read()
        if rec is not None and rec["holder"] != self.node:
            if rec["expiry"] >= now:
                self.term = rec["term"]
                return False  # live foreign holder: defer
            self.term = rec["term"] + 1  # lapsed: take it over
        try:
            atomic_write_json(self.path, {
                "holder": self.node, "expiry": now + self.ttl_s,
                "term": self.term})
        except OSError as e:
            log.warning("lease write to %s failed: %s", self.path, e)
            return False  # cannot prove the claim: act as non-decider
        # read-back check: two routers racing the same expired record can
        # both atomic_write_json their claim — last writer wins, so only
        # the router the file NAMES after the dust settles may decide
        # (the loser sees the winner's record and defers immediately
        # instead of a full term of silent split-brain)
        rec = self._read()
        if rec is None or rec["holder"] != self.node:
            if rec is not None:
                self.term = rec["term"]
            return False
        return True

    def release(self) -> None:
        rec = self._read()
        if rec is not None and rec["holder"] == self.node:
            try:
                os.remove(self.path)
            except OSError:
                pass


class PeerLease:
    """Disk-free decider lease: the lowest-ranked endpoint among the
    peers seen alive within the TTL holds it.  Liveness is fed by the
    sync exchanges (``observe``); peers are presumed alive at boot so
    the low-ranked router decides from the start and the other defers —
    a dead peer simply lapses one TTL later."""

    def __init__(self, node: str, peers: Sequence[str], ttl_s: float = 1.0,
                 clock: Callable[[], float] = time.monotonic):
        if ttl_s <= 0:
            raise ValueError("lease ttl_s must be > 0")
        self.node = str(node)
        self.peers = [str(p) for p in peers]
        self.ttl_s = float(ttl_s)
        self._clock = clock
        now = clock()
        self._seen: Dict[str, float] = {p: now for p in self.peers}

    def observe(self, peer: str) -> None:
        if peer in self._seen:
            self._seen[peer] = self._clock()

    def _live(self) -> List[str]:
        now = self._clock()
        return [p for p in self.peers if now - self._seen[p] <= self.ttl_s]

    def holder(self) -> str:
        return min([self.node] + self._live(), key=_rank)

    def acquire(self) -> bool:
        return self.holder() == self.node

    def release(self) -> None:
        """Peer leases have nothing to release: rank + liveness decide."""


class HACoordinator:
    """One router's half of the dual-LIVE-router protocol: lease + the
    ``SyncServeState`` exchange loop.  Built from ``DSGD_SERVE_HA`` (or
    directly in tests/benches), attached to a started router via
    ``ServingRouter.attach_ha``, then ``start()``ed."""

    def __init__(self, peers: Sequence[str], node: Optional[str] = None,
                 sync_s: float = 0.25, lease_ttl_s: Optional[float] = None,
                 lease_path: Optional[str] = None, metrics=None,
                 policy: Optional[RpcPolicy] = None):
        if not peers:
            raise ValueError("HA needs at least one peer router endpoint")
        if sync_s <= 0:
            raise ValueError("sync_s must be > 0")
        self.peers = [str(p) for p in peers]
        self.node = node
        self.sync_s = float(sync_s)
        self.lease_ttl_s = float(lease_ttl_s) if lease_ttl_s else 4 * self.sync_s
        self._lease_path = lease_path
        self.metrics = metrics
        self._policy = policy
        self._router = None
        self._lease = None
        self._lock = threading.Lock()
        self._was_decider = False
        self._ever_deferred = False
        self._stubs: Dict[str, ServeStub] = {}
        self._channels: Dict[str, grpc.Channel] = {}
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="route-ha-sync")

    @classmethod
    def from_spec(cls, spec: str, metrics=None,
                  policy: Optional[RpcPolicy] = None) -> "HACoordinator":
        kw = parse_ha_spec(spec)
        return cls(kw["peers"], node=kw["node"], sync_s=kw["sync_s"],
                   lease_ttl_s=kw["lease_ttl_s"],
                   lease_path=kw["lease_path"], metrics=metrics,
                   policy=policy)

    # -- wiring --------------------------------------------------------------

    def attach(self, router) -> None:
        """Bind to a constructed router (``ServingRouter.attach_ha`` calls
        this).  The node label defaults to the router's bound loopback
        endpoint — single-host harnesses need no ``self=`` token."""
        self._router = router
        if self.metrics is None:
            self.metrics = router.metrics
        if self._policy is None:
            self._policy = router._policy
        if self.node is None:
            self.node = f"127.0.0.1:{router.bound_port}"
        if self._lease_path:
            self._lease = FileLease(self._lease_path, self.node,
                                    ttl_s=self.lease_ttl_s)
        else:
            self._lease = PeerLease(self.node, self.peers,
                                    ttl_s=self.lease_ttl_s)
        for p in self.peers:
            host, _, port = p.rpartition(":")
            self._channels[p] = new_channel(host, int(port))
            self._stubs[p] = ServeStub(self._channels[p])
        self._refresh()
        log.info("HA coordinator on %s: peers=%s lease=%s sync=%gs ttl=%gs",
                 self.node, ", ".join(self.peers),
                 self._lease_path or "peer-rank", self.sync_s,
                 self.lease_ttl_s)

    # -- the lease -----------------------------------------------------------

    def is_decider(self) -> bool:
        """Current lease verdict (re-acquired on every read: promote/
        rollback verdicts must see a lapse the moment it happens, not a
        sync tick later)."""
        return self._refresh()

    def _refresh(self) -> bool:
        # lock order: NEVER hold _lock while taking the router's
        # _push_lock — push RPCs hold _push_lock and call is_decider()
        # (-> _lock), so detecting the lapse happens inside the critical
        # section but the assume-lease re-pin runs after releasing it.
        # _was_decider flips under _lock, so exactly one thread sees the
        # False->True edge and runs the callback.
        assumed = False
        with self._lock:
            now = self._lease.acquire()
            if not now:
                self._ever_deferred = True
            if now and not self._was_decider and self._ever_deferred:
                # the lease LAPSED onto us: the previous decider went
                # quiet for a full TTL — assume its duties and re-pin the
                # mirrored promoted state so the fleet serves one truth
                assumed = True
            self._was_decider = now
            self.metrics.gauge(metrics_mod.ROUTER_HA_DECIDER).set(
                1.0 if now else 0.0)
        if assumed:
            self.metrics.counter(
                metrics_mod.ROUTER_HA_FAILOVERS).increment()
            log.warning("HA lease assumed by %s (peer decider lapsed)",
                        self.node)
            if self._router is not None:
                self._router._on_assume_lease()
        return now

    def observe_peer(self, peer: str) -> None:
        self._lease.observe(peer)

    # -- the sync loop -------------------------------------------------------

    def notify(self) -> None:
        """A local transition happened: sync NOW instead of waiting out
        the interval (keeps the split-brain window well under sync_s)."""
        self._wake.set()

    def _record_request(self, snap: Dict) -> "pb.SyncServeStateRequest":
        req = pb.SyncServeStateRequest(
            node=self.node, seq=int(snap["seq"]),
            decider=self._was_decider)
        if snap["promoted"] is not None:
            req.has_promoted = True
            req.promoted_version = int(snap["promoted"])
        if snap["best"] is not None:
            req.has_best = True
            req.best_loss = float(snap["best"])
        req.rejected.extend(int(v) for v in snap["rejected"])
        return req

    def sync_once(self) -> int:
        """One exchange round: renew the lease, push our record to every
        peer, adopt any newer record a reply carries.  Returns how many
        peers answered."""
        self._refresh()
        if self._router is None:
            return 0
        snap = self._router.export_ha_state()
        req = self._record_request(snap)
        answered = 0
        for peer, stub in self._stubs.items():
            try:
                reply = stub.SyncServeState(
                    req, timeout=self._policy.deadline_s)
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.UNIMPLEMENTED:
                    # older binary without the SyncServeState splice: it
                    # cannot mirror state, but its server ANSWERED, so it
                    # is alive for lease purposes — without observe() the
                    # higher-ranked router would wrongly assume decider-
                    # ship from a merely-old peer after one TTL
                    self._lease.observe(peer)
                # either way the sync itself failed (dead/unreachable
                # peer silence is what ages the lease out)
                self.metrics.counter(
                    metrics_mod.ROUTER_HA_SYNC_ERRORS).increment()
                continue
            answered += 1
            self._lease.observe(peer)
            if reply.seq > snap["seq"]:
                # the peer is ahead (we are the rejoining/stale side):
                # adopt its record — this is the no-resurrection path
                self._router.apply_ha_record(reply)
        return answered

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._wake.wait(self.sync_s)
            self._wake.clear()
            if self._stop.is_set():
                break
            try:
                self.sync_once()
            except Exception as e:  # noqa: BLE001 - sync must not die mid-run
                log.warning("HA sync pass failed: %s", e)

    def start(self) -> "HACoordinator":
        if self._router is None:
            raise RuntimeError("attach() the coordinator to a router first")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.sync_s + 1.0)
        if self._lease is not None:
            self._lease.release()
        for ch in self._channels.values():
            ch.close()


class FailoverServeClient:
    """Client-side two-target failover stub: Predict against the
    last-good router first, fail over to the next on any transport error
    — the router->replica failover ladder, one level up.  Kube fronts the same pair with one
    Service; this is the harness/SDK equivalent."""

    def __init__(self, targets: Sequence[Tuple[str, int]],
                 timeout_s: float = 10.0):
        if not targets:
            raise ValueError("failover client needs at least one router")
        self._targets = [(h, int(p)) for h, p in targets]
        self._channels = [new_channel(h, p) for h, p in self._targets]
        self._stubs = [ServeStub(ch) for ch in self._channels]
        self._timeout = float(timeout_s)
        self._primary = 0
        self.failovers = 0

    def _call(self, method: str, request):
        last: Optional[grpc.RpcError] = None
        n = len(self._stubs)
        for k in range(n):
            i = (self._primary + k) % n
            try:
                reply = getattr(self._stubs[i], method)(
                    request, timeout=self._timeout)
            except grpc.RpcError as e:
                if e.code() == grpc.StatusCode.INVALID_ARGUMENT:
                    raise  # caller error: every router would reject it
                last = e
                continue
            if i != self._primary:
                self.failovers += 1
                self._primary = i  # stick with the router that answered
            return reply
        raise last

    def predict(self, indices, values) -> "pb.PredictReply":
        return self._call("Predict",
                          pb.PredictRequest(indices=indices, values=values))

    def health(self) -> "pb.ServeHealthReply":
        return self._call("ServeHealth", pb.Empty())

    def close(self) -> None:
        for ch in self._channels:
            ch.close()


def router_load_ms(router) -> Optional[float]:
    """The autoscale signal: the WORST eligible replica's p2c score
    (EWMA latency x (1 + in-flight)) in milliseconds — the router's own
    balancing currency, so 'the best available choice is already slow
    and busy' is exactly when more capacity helps.  None when no replica
    is eligible (an outage is the health loop's problem, not a scaling
    verdict)."""
    eligible = router._eligible()
    if not eligible:
        return None
    return 1000.0 * max(r.score() for r in eligible)


class ReplicaAutoscaler:
    """Load-adaptive replica count against a p99 SLO
    (``DSGD_SERVE_SLO_MS``).

    Pure controller over three callables — ``signal_ms`` (typically
    ``router_load_ms``), ``scale_up`` / ``scale_down`` (typically
    ``ServingFleet.add_replica`` / ``drain_replica``) — so the decision
    logic unit-tests synchronously.  Hysteresis: only ``up_after``
    CONSECUTIVE ticks over the SLO spin up, only ``down_after``
    consecutive ticks under ``low_water x SLO`` drain, and every action
    starts a ``cooldown_s`` dead window — chaos weather (one slow tick,
    one partition blip) cannot flap the fleet."""

    def __init__(self, signal_ms: Callable[[], Optional[float]],
                 scale_up: Callable[[], object],
                 scale_down: Callable[[], object],
                 count: Callable[[], int],
                 slo_ms: float,
                 min_replicas: int = 1, max_replicas: int = 8,
                 interval_s: float = 1.0, up_after: int = 2,
                 down_after: int = 5, low_water: float = 0.3,
                 cooldown_s: float = 5.0, metrics=None,
                 clock: Callable[[], float] = time.monotonic):
        if slo_ms <= 0:
            raise ValueError("slo_ms must be > 0 (0/unset = autoscale off)")
        if not 1 <= min_replicas <= max_replicas:
            raise ValueError("need 1 <= min_replicas <= max_replicas")
        if not 0.0 < low_water < 1.0:
            raise ValueError("low_water must be a fraction in (0, 1)")
        if up_after < 1 or down_after < 1:
            raise ValueError("up_after/down_after must be >= 1")
        if interval_s <= 0 or cooldown_s < 0:
            raise ValueError("interval_s must be > 0 and cooldown_s >= 0")
        self._signal, self._up, self._down = signal_ms, scale_up, scale_down
        self._count = count
        self.slo_ms = float(slo_ms)
        self.min_replicas, self.max_replicas = int(min_replicas), int(max_replicas)
        self.interval_s = float(interval_s)
        self.up_after, self.down_after = int(up_after), int(down_after)
        self.low_water = float(low_water)
        self.cooldown_s = float(cooldown_s)
        self.metrics = metrics if metrics is not None else metrics_mod.Metrics()
        self._clock = clock
        self._above = self._below = 0
        self._cooldown_until = -float("inf")
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="route-autoscale")

    def step(self) -> Optional[str]:
        """One tick: 'up', 'down', or None.  Safe to drive synchronously
        (tests) or from the interval thread."""
        sig = self._signal()
        if sig is None:
            self._above = self._below = 0
            return None
        self.metrics.gauge(metrics_mod.ROUTER_SCALE_LOAD_MS).set(float(sig))
        self.metrics.gauge(metrics_mod.ROUTER_SCALE_REPLICAS).set(
            self._count())
        if self._clock() < self._cooldown_until:
            return None
        if sig > self.slo_ms:
            self._above += 1
            self._below = 0
            if self._above >= self.up_after and self._count() < self.max_replicas:
                return self._act(self._up, metrics_mod.ROUTER_SCALE_UP, "up")
        elif sig < self.low_water * self.slo_ms:
            self._below += 1
            self._above = 0
            if (self._below >= self.down_after
                    and self._count() > self.min_replicas):
                return self._act(self._down, metrics_mod.ROUTER_SCALE_DOWN,
                                 "down")
        else:
            # inside the band: the streaks reset — hysteresis demands
            # CONSECUTIVE evidence, not eventually-accumulated evidence
            self._above = self._below = 0
        return None

    def _act(self, action, counter_name: str, verdict: str) -> str:
        action()
        self.metrics.counter(counter_name).increment()
        self.metrics.gauge(metrics_mod.ROUTER_SCALE_REPLICAS).set(
            self._count())
        self._above = self._below = 0
        self._cooldown_until = self._clock() + self.cooldown_s
        log.info("autoscale %s -> %d replicas (signal vs SLO %gms)",
                 verdict, self._count(), self.slo_ms)
        return verdict

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 - scaling must not die mid-run
                log.warning("autoscale tick failed: %s", e)

    def start(self) -> "ReplicaAutoscaler":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.interval_s + 1.0)
