"""Deterministic fault injection for RPC edges.

The port's copy of the JAX package's chaos/ (its docs/FAULT_TOLERANCE.md):
the same plan grammar, scenario library, per-edge seeded streams and
draw order, so one plan injects the same faults on the same edges in
either package, and a mixed cluster's edges replay alike.  It imports
grpc, the port's trace and flight recorder, and nothing else.

The repo's fault-tolerance machinery (heartbeat eviction, async stall
watchdog, quorum barriers, retry/breaker policy) needs faults it can be
tested AGAINST, reproducibly.  This package injects them at the client
stub layer: when a plan is installed, `rpc.service.new_channel` wraps
every channel it creates in a `ChaosChannel`, whose multicallables apply
a seeded fault plan to each outgoing RPC — drop (black hole until the
caller's deadline), delay (uniform within a range), duplicate,
error-code injection, and timed partitions of named endpoints — before
the call ever reaches gRPC.  Receivers see exactly what a lossy network
would deliver; senders see exactly the futures/errors gRPC would give
them, so no production code path knows chaos exists.

Plan syntax (DSGD_CHAOS):

    seed=7;drop=0.05;delay=20ms~200ms;dup=0.01;error=0.002;partition=w2:10s@30s

- ``seed=N``       seeds every per-edge RNG stream (decisions replay
                   given the same per-edge call order)
- ``drop=P``       per-call probability the RPC is black-holed: the
                   future never completes until the caller's deadline
                   fires (DEADLINE_EXCEEDED), exactly like a lost packet
- ``delay=A~B``    per-call latency added uniformly in [A, B] before the
                   real send (``delay=50ms`` = fixed)
- ``dup=P``        per-call probability the request is sent TWICE (the
                   duplicate is fire-and-forget) — exercises idempotence
- ``error=P``      per-call probability of an immediate injected
                   UNAVAILABLE (a fast failure, unlike drop's slow one)
- ``partition=NAME:DUR@AT``  (comma-repeatable) every RPC touching the
                   endpoint named NAME (see `name_endpoint`) is dropped
                   during [AT, AT+DUR) measured from `arm()` time
- ``grace=D``      no faults for the first D after install (lets a
                   cluster form before the weather starts; `arm()`
                   resets the clock explicitly instead)
- ``scope=named``  blast radius: faults apply only to edges that touch a
                   NAMED endpoint (see `name_endpoint`; DevCluster names
                   its master/workers) — un-named planes (a serving
                   fleet, a bench load generator) run clear.  Default
                   ``scope=all``.  A ``scenario:NAME`` spec accepts
                   trailing overrides: ``scenario:flaky-rack;scope=named``

Durations accept ``20ms``, ``1.5s``, or bare seconds.  Determinism: each
(origin, target, method) edge draws from its own `random.Random` stream
seeded by (plan seed, edge key), so a fixed plan + fixed per-edge call
order replays the same faults; wall-clock only enters through the
partition/grace windows.

Installed per process (`install`; main.py installs from the DSGD_CHAOS
config field, DevCluster from its `chaos=` parameter), consulted at call
time — so a plan installed before a node builds its channels covers
every stub it ever creates, including rejoin channels.
"""

from __future__ import annotations

import heapq
import re
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import grpc

from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.trace import flight

_DUR_RE = re.compile(r"^(\d+(?:\.\d+)?)(ms|s)?$")


def _parse_duration(tok: str) -> float:
    """'20ms' | '1.5s' | '3' -> seconds."""
    m = _DUR_RE.match(tok.strip())
    if not m:
        raise ValueError(f"bad duration {tok!r} (want e.g. 20ms, 1.5s)")
    v = float(m.group(1))
    return v / 1000.0 if m.group(2) == "ms" else v


@dataclass(frozen=True)
class Partition:
    name: str     # endpoint name (name_endpoint) or "host:port"
    dur_s: float  # window length
    at_s: float   # offset from arm() time


@dataclass(frozen=True)
class FaultPlan:
    seed: int = 0
    drop: float = 0.0
    delay: Optional[Tuple[float, float]] = None
    dup: float = 0.0
    error: float = 0.0
    grace_s: float = 0.0
    partitions: Tuple[Partition, ...] = ()
    scope: str = "all"

    def __post_init__(self):
        for name in ("drop", "dup", "error"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"chaos {name}={p} must be a probability")
        if self.delay is not None and not (0 <= self.delay[0] <= self.delay[1]):
            raise ValueError(f"chaos delay range {self.delay} must be 0 <= lo <= hi")
        if self.scope not in ("all", "named"):
            raise ValueError(
                f"chaos scope={self.scope!r} must be 'all' or 'named'")


# -- named scenario library (ROADMAP 3c; DSGD_CHAOS=scenario:NAME) -----------
# The soak bench's weather, promoted to named seeded plans so a bench run,
# a bug report, and a CI job all mean the SAME faults when they say
# "flaky-rack".  Each value is a full plan-grammar spec (seed included —
# naming a scenario pins its randomness), resolved by parse_plan before
# parsing, so config validation and every install path accept the names.
SCENARIOS: Dict[str, str] = {
    # lossy ToR switch: steady low drop + jittery small delays + the
    # occasional duplicated frame, no partitions — transport noise only
    "flaky-rack": "seed=23;drop=0.03;delay=2ms~20ms;dup=0.02",
    # one slow device in the I/O path: long-tail delays with a grace
    # window so startup traffic clears before the weather starts
    "slow-disk": "seed=31;delay=10ms~150ms;grace=2s",
    # asymmetric partition: two workers black-holed at different,
    # non-overlapping times, riding steady transport noise — the
    # quorum/hedge plane's worst weather.  Windows are sized to be
    # absorbable by a correctly-budgeted deployment (heartbeat budget
    # > 1.5s, quorum slack >= 1, and only one worker dark at a time)
    "asym-partition": "seed=47;drop=0.02;delay=3ms~15ms;dup=0.01;"
                      "partition=w1:1.5s@6s,w2:1.5s@9s",
    # correlated blip then mass rejoin: three workers vanish TOGETHER and
    # return together — the re-registration/resplit thundering herd
    "thundering-rejoin": "seed=59;drop=0.02;delay=1ms~10ms;"
                         "partition=w1:2s@3s,w2:2s@3s,w3:2s@3s",
    # flapping decider router (docs/SERVING.md "HA"): repeated SHORT
    # kills + restarts of the node named `router` under scope=named, each
    # gap just past a typical HA lease TTL — the survivor assumes the
    # decider lease, then the flapping router rejoins (and must adopt the
    # survivor's newer promoted-state record, never resurrect its own),
    # three times in a row, over mild transport jitter
    "router-flap": "seed=71;scope=named;delay=1ms~8ms;"
                   "partition=router:0.8s@2s,router:0.8s@5s,router:0.8s@8s",
}


def resolve_scenario(spec: str) -> str:
    """Expand a ``scenario:NAME`` spec to its plan string; pass anything
    else through untouched.  Tokens after the name override/extend the
    scenario (``scenario:flaky-rack;scope=named``) — the seeded weather
    stays the library's, the caller adjusts only its blast radius."""
    if not spec.startswith("scenario:"):
        return spec
    name, _, extra = spec[len("scenario:"):].partition(";")
    name = name.strip()
    if name not in SCENARIOS:
        raise ValueError(
            f"unknown chaos scenario {name!r}; known: "
            f"{', '.join(sorted(SCENARIOS))}")
    return SCENARIOS[name] + (f";{extra}" if extra else "")


def parse_plan(spec: str) -> FaultPlan:
    """DSGD_CHAOS spec string -> FaultPlan (raises ValueError on typos).
    Accepts ``scenario:NAME`` for the named seeded library above."""
    spec = resolve_scenario(spec)
    kw: Dict[str, object] = {}
    parts: List[Partition] = []
    for token in filter(None, (t.strip() for t in spec.split(";"))):
        if "=" not in token:
            raise ValueError(f"bad chaos token {token!r} (want key=value)")
        key, val = (s.strip() for s in token.split("=", 1))
        if key == "seed":
            kw["seed"] = int(val)
        elif key in ("drop", "dup", "error"):
            kw[key] = float(val)
        elif key == "delay":
            lo, _, hi = val.partition("~")
            a = _parse_duration(lo)
            b = _parse_duration(hi) if hi else a
            kw["delay"] = (a, b)
        elif key == "grace":
            kw["grace_s"] = _parse_duration(val)
        elif key == "scope":
            kw["scope"] = val
        elif key == "partition":
            for p in filter(None, (s.strip() for s in val.split(","))):
                name, _, window = p.rpartition(":")
                at = ""
                dur, _, at = window.partition("@")
                if not name or not at:
                    raise ValueError(
                        f"bad partition {p!r} (want NAME:DUR@AT, e.g. w2:10s@30s)")
                parts.append(Partition(name, _parse_duration(dur),
                                       _parse_duration(at)))
        else:
            raise ValueError(f"unknown chaos key {key!r}")
    return FaultPlan(partitions=tuple(parts), **kw)


class _Scheduler:
    """One shared timer thread (heapq) for delayed sends and black-hole
    deadlines — avoids a thread per injected fault."""

    def __init__(self):
        self._cv = threading.Condition()
        self._heap: list = []
        self._seq = 0
        # the liveness flag (not Thread.is_alive) decides respawn: both
        # the idle-exit and this flag flip under the SAME lock, so a
        # schedule() racing a dying thread always sees the truth
        self._running = False

    def schedule(self, delay_s: float, fn) -> None:
        with self._cv:
            self._seq += 1
            heapq.heappush(self._heap, (time.monotonic() + delay_s, self._seq, fn))
            if not self._running:
                self._running = True
                threading.Thread(
                    target=self._run, daemon=True, name="chaos-timer").start()
            self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap:
                    if not self._cv.wait(timeout=5.0) and not self._heap:
                        self._running = False
                        return  # idle: let the thread die; next schedule respawns
                due, _, fn = self._heap[0]
                now = time.monotonic()
                if due > now:
                    self._cv.wait(timeout=due - now)
                    continue
                heapq.heappop(self._heap)
            try:
                fn()
            except Exception:  # noqa: BLE001 - a fault must not kill the timer
                pass


_SCHEDULER = _Scheduler()


class ChaosRpcError(grpc.RpcError):
    """Injected failure carrying the .code()/.details() surface every
    caller in this repo reads off a grpc.RpcError."""

    def __init__(self, code: grpc.StatusCode, details: str = "chaos-injected"):
        super().__init__()
        self._code = code
        self._details = details

    def code(self) -> grpc.StatusCode:  # noqa: D102 - grpc surface
        return self._code

    def details(self) -> str:  # noqa: D102 - grpc surface
        return self._details

    def __str__(self):
        return f"ChaosRpcError({self._code})"


class _ChaosFuture:
    """grpc.Future-alike for injected/delayed calls.

    Three lifecycles: settled at birth (injected error), black hole
    (settles with DEADLINE_EXCEEDED when the caller's deadline fires, or
    never, if the call carried none — exactly a lost packet under a
    deadline-less fire-and-forget send), and delayed (the real call
    starts after `delay`; from then on this proxies the inner future).
    """

    def __init__(self):
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._inner = None
        self._exception: Optional[Exception] = None
        self._result = None
        self._cancelled = False
        self._callbacks: list = []

    # -- settle paths --------------------------------------------------------

    def _settle(self, result=None, exception=None) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._result, self._exception = result, exception
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 - callback errors stay local
                pass

    def _adopt(self, inner) -> None:
        """A delayed real call started: proxy its completion."""
        with self._lock:
            if self._cancelled:
                inner.cancel()
                return
            self._inner = inner
        inner.add_done_callback(self._from_inner)

    def _from_inner(self, inner) -> None:
        if inner.cancelled():
            self._settle(exception=ChaosRpcError(
                grpc.StatusCode.CANCELLED, "cancelled"))
            with self._lock:
                self._cancelled = True
            return
        exc = inner.exception()
        if exc is not None:
            self._settle(exception=exc)
        else:
            self._settle(result=inner.result())

    # -- grpc.Future surface -------------------------------------------------

    def result(self, timeout=None):
        if not self._done.wait(timeout):
            raise grpc.FutureTimeoutError()
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self, timeout=None):
        if not self._done.wait(timeout):
            raise grpc.FutureTimeoutError()
        return self._exception

    def done(self) -> bool:
        return self._done.is_set()

    def cancelled(self) -> bool:
        return self._cancelled

    def running(self) -> bool:
        return not self._done.is_set()

    def cancel(self) -> bool:
        with self._lock:
            inner = self._inner
            if inner is None and not self._done.is_set():
                self._cancelled = True
        if inner is not None:
            return inner.cancel()
        self._settle(exception=ChaosRpcError(
            grpc.StatusCode.CANCELLED, "cancelled"))
        return True

    def add_done_callback(self, fn) -> None:
        with self._lock:
            if not self._done.is_set():
                self._callbacks.append(fn)
                return
        fn(self)

    def traceback(self, timeout=None):
        return None


class ChaosState:
    """One installed plan: clock, endpoint names, per-edge RNG streams."""

    def __init__(self, plan: FaultPlan, metrics=None, armed: bool = True):
        self.plan = plan
        self._names: Dict[Tuple[str, int], str] = {}
        self._rngs: Dict[Tuple, "_Rng"] = {}
        self._lock = threading.Lock()
        self._metrics = metrics
        self._t0 = time.monotonic() if armed else None

    def arm(self) -> None:
        """Start (or restart) the fault clock — partitions/grace measure
        from here.  A state installed with armed=False injects nothing
        until armed."""
        self._t0 = time.monotonic()

    @property
    def armed(self) -> bool:
        return self._t0 is not None

    def elapsed(self) -> float:
        return 0.0 if self._t0 is None else time.monotonic() - self._t0

    def name_endpoint(self, host: str, port: int, name: str) -> None:
        with self._lock:
            self._names[(host, int(port))] = name

    def _endpoint_names(self, endpoint) -> Tuple[str, ...]:
        if endpoint is None:
            return ()
        with self._lock:
            named = self._names.get(endpoint)
        canonical = f"{endpoint[0]}:{endpoint[1]}"
        return (named, canonical) if named else (canonical,)

    def partitioned(self, *endpoints) -> bool:
        if not self.plan.partitions or self._t0 is None:
            return False
        t = self.elapsed()
        names = set()
        for ep in endpoints:
            names.update(self._endpoint_names(ep))
        return any(
            p.name in names and p.at_s <= t < p.at_s + p.dur_s
            for p in self.plan.partitions
        )

    def active(self) -> bool:
        return self._t0 is not None and self.elapsed() >= self.plan.grace_s

    def in_scope(self, origin, target) -> bool:
        """scope=named confines the weather to edges touching a named
        endpoint (the plane the caller registered via `name_endpoint`);
        every other edge — a serving fleet, a bench load generator
        sharing the process — runs clear."""
        if self.plan.scope == "all":
            return True
        with self._lock:
            return any(ep in self._names
                       for ep in (origin, target) if ep is not None)

    def _canonical(self, endpoint) -> Optional[str]:
        """Stable edge identity: the registered name when one exists
        (DevCluster: master/w0..wN — OS-assigned ports differ every run,
        which would silently break stream determinism), host:port
        otherwise (multi-process deployments pin their ports)."""
        if endpoint is None:
            return None
        with self._lock:
            named = self._names.get(endpoint)
        return named if named else f"{endpoint[0]}:{endpoint[1]}"

    def rng(self, origin, target, method: str):
        """Deterministic per-edge stream: keyed by the canonical
        (origin, target, method) so a fixed plan and per-edge call order
        replay the same drop/delay/dup decisions regardless of sibling
        edges — and regardless of which ephemeral ports the OS hands a
        dev cluster (endpoints resolve through their registered names)."""
        import random

        key = (self._canonical(origin), self._canonical(target), method)
        with self._lock:
            r = self._rngs.get(key)
            if r is None:
                r = random.Random(
                    (self.plan.seed << 32)
                    ^ zlib.crc32(repr(key).encode()))
                self._rngs[key] = r
            return r

    def count(self, kind: str, **edge) -> None:
        """Account one injected fault.  `edge` (method/origin/target) flows
        into the flight recorder and — when the caller sits inside a
        sampled trace span, e.g. a master fan-out window — into the trace
        as an instant event, so an injected delay is visibly ATTRIBUTED in
        the timeline instead of masquerading as a slow worker."""
        if self._metrics is not None:
            self._metrics.counter(f"chaos.injected.{kind}").increment()
        flight.record(f"chaos.{kind}", **edge)
        trace_mod.event(f"chaos.{kind}", **edge)


class _ChaosCallable:
    """Wraps one unary-unary multicallable with the plan's faults."""

    def __init__(self, inner, method: str, target, origin, state: ChaosState):
        self._inner = inner
        self._method = method
        self._target = target
        self._origin = origin
        self._state = state

    def _decide(self):
        """-> (action, param): ('pass'|'drop'|'error'|'delay'|'dup', x).
        One uniform draw per candidate fault keeps the stream deterministic
        even as the plan's probabilities change."""
        st = self._state
        if not st.active() or not st.in_scope(self._origin, self._target):
            return ("pass", None)
        rng = st.rng(self._origin, self._target, self._method)
        # draws happen in a FIXED order so the stream replays
        u_drop = rng.random()
        u_err = rng.random()
        u_dup = rng.random()
        d = (rng.uniform(*st.plan.delay) if st.plan.delay is not None else 0.0)
        edge = {"method": self._method,
                "origin": st._canonical(self._origin),
                "target": st._canonical(self._target)}
        if st.partitioned(self._target, self._origin):
            st.count("partition", **edge)
            return ("drop", None)
        if u_drop < st.plan.drop:
            st.count("drop", **edge)
            return ("drop", None)
        if u_err < st.plan.error:
            st.count("error", **edge)
            return ("error", None)
        if u_dup < st.plan.dup:
            st.count("dup", delay_s=round(d, 6), **edge)
            return ("dup", d)
        if d > 0:
            st.count("delay", delay_s=round(d, 6), **edge)
            return ("delay", d)
        return ("pass", None)

    # -- blocking call -------------------------------------------------------

    def __call__(self, request, timeout=None, **kwargs):
        action, param = self._decide()
        if action == "pass":
            return self._inner(request, timeout=timeout, **kwargs)
        if action == "drop":
            # black hole: the caller's deadline is the only way out
            time.sleep(timeout if timeout is not None else 1.0)
            raise ChaosRpcError(grpc.StatusCode.DEADLINE_EXCEEDED,
                                "chaos drop")
        if action == "error":
            raise ChaosRpcError(grpc.StatusCode.UNAVAILABLE, "chaos error")
        if action == "dup":
            try:  # duplicate is fire-and-forget; the primary is the answer
                self._inner.future(request, timeout=timeout, **kwargs)
            except Exception:  # noqa: BLE001 - best-effort duplicate
                pass
            if param:
                time.sleep(param)
            return self._inner(request, timeout=timeout, **kwargs)
        # delay
        time.sleep(param)
        if timeout is not None:
            remaining = timeout - param
            if remaining <= 0:
                raise ChaosRpcError(grpc.StatusCode.DEADLINE_EXCEEDED,
                                    "chaos delay past deadline")
            timeout = remaining
        return self._inner(request, timeout=timeout, **kwargs)

    # -- future call ---------------------------------------------------------

    def future(self, request, timeout=None, **kwargs):
        action, param = self._decide()
        if action == "pass":
            return self._inner.future(request, timeout=timeout, **kwargs)
        fut = _ChaosFuture()
        if action == "drop":
            if timeout is not None:
                _SCHEDULER.schedule(timeout, lambda: fut._settle(
                    exception=ChaosRpcError(
                        grpc.StatusCode.DEADLINE_EXCEEDED, "chaos drop")))
            # no deadline (fire-and-forget gossip): stays pending forever,
            # like a lost packet — the bounded sender cancels it eventually
            return fut
        if action == "error":
            fut._settle(exception=ChaosRpcError(
                grpc.StatusCode.UNAVAILABLE, "chaos error"))
            return fut
        if action == "dup":
            def start_dup():
                try:
                    self._inner.future(request, timeout=timeout, **kwargs)
                    fut._adopt(self._inner.future(request, timeout=timeout,
                                                  **kwargs))
                except Exception as e:  # noqa: BLE001 - surface to the future
                    fut._settle(exception=e)
            if param:
                _SCHEDULER.schedule(param, start_dup)
            else:
                start_dup()
            return fut
        # delay: schedule the real send without blocking the caller
        def start():
            try:
                inner_timeout = timeout
                if inner_timeout is not None:
                    inner_timeout = max(1e-3, inner_timeout - param)
                fut._adopt(self._inner.future(request, timeout=inner_timeout,
                                              **kwargs))
            except Exception as e:  # noqa: BLE001 - surface to the future
                fut._settle(exception=e)
        _SCHEDULER.schedule(param, start)
        return fut


class _ChaosStreamCallable:
    """Wraps one stream-stream multicallable: the plan applies to every
    OUTGOING message of the request stream, so stream writes see exactly
    the drop/delay/dup/partition weather unary calls do
    (docs/SYNC_PIPELINE.md "Streaming transport").

    Per-message semantics mirror the unary actions on an ordered pipe:

    - drop/partition: the frame is silently not written — the caller's
      per-frame deadline is the only way out, exactly a lost packet
      (later frames still flow: a lost frame is not a dead stream);
    - delay: the writer sleeps before the frame (and, as on a real
      ordered transport, everything queued behind it waits too);
    - dup: the frame is written twice — receivers must drop the second
      reply idempotently (rpc/stream.py does, by seq);
    - error: the request iterator raises, which gRPC surfaces as a
      TERMINATED stream — the client's reader sees the teardown and the
      transport falls back to unary (the failure mode a mid-stream
      connection reset produces).

    Decisions draw from the same deterministic per-(origin, target,
    method) RNG stream as unary calls, one draw set per message.
    """

    def __init__(self, inner, method: str, target, origin, state: ChaosState):
        self._inner = inner
        self._method = method
        self._target = target
        self._origin = origin
        self._state = state
        # reuse the unary decision procedure (same fixed draw order)
        self._decider = _ChaosCallable(None, method, target, origin, state)

    def _wrap(self, request_iterator):
        st = self._state
        edge = {"method": self._method}
        for msg in request_iterator:
            action, param = self._decider._decide()
            if action == "drop":
                continue  # lost frame; the stream itself stays healthy
            if action == "error":
                st.count("stream_teardown",
                         origin=st._canonical(self._origin),
                         target=st._canonical(self._target), **edge)
                raise ChaosRpcError(grpc.StatusCode.UNAVAILABLE,
                                    "chaos stream teardown")
            if action == "dup":
                yield msg
                yield msg
                continue
            if action == "delay":
                time.sleep(param)
            yield msg

    def __call__(self, request_iterator, timeout=None, **kwargs):
        return self._inner(self._wrap(request_iterator), timeout=timeout,
                           **kwargs)


class ChaosChannel:
    """Channel proxy whose multicallables inject the plan."""

    def __init__(self, inner: grpc.Channel, target, origin, state: ChaosState):
        self._inner = inner
        self._target = target
        self._origin = origin
        self._state = state

    def unary_unary(self, path, request_serializer=None,
                    response_deserializer=None, **kwargs):
        call = self._inner.unary_unary(
            path, request_serializer=request_serializer,
            response_deserializer=response_deserializer, **kwargs)
        method = path.rsplit("/", 1)[-1]
        return _ChaosCallable(call, method, self._target, self._origin,
                              self._state)

    def stream_stream(self, path, request_serializer=None,
                      response_deserializer=None, **kwargs):
        call = self._inner.stream_stream(
            path, request_serializer=request_serializer,
            response_deserializer=response_deserializer, **kwargs)
        method = path.rsplit("/", 1)[-1]
        return _ChaosStreamCallable(call, method, self._target, self._origin,
                                    self._state)

    def close(self) -> None:
        self._inner.close()

    def __getattr__(self, item):  # subscribe, unary_stream, ... pass through
        return getattr(self._inner, item)


# -- module-level installation -----------------------------------------------

_STATE: Optional[ChaosState] = None
_STATE_LOCK = threading.Lock()


def install(plan, metrics=None, armed: bool = True) -> ChaosState:
    """Install a plan (FaultPlan or spec string) for this process.  Every
    channel `rpc.service.new_channel` creates from now on is wrapped."""
    global _STATE
    if isinstance(plan, str):
        plan = parse_plan(plan)
    with _STATE_LOCK:
        _STATE = ChaosState(plan, metrics=metrics, armed=armed)
        return _STATE


def uninstall() -> None:
    global _STATE
    with _STATE_LOCK:
        _STATE = None


def state() -> Optional[ChaosState]:
    return _STATE


def wrap_channel(channel: grpc.Channel, target, origin=None):
    """Wrap `channel` if a plan is installed; otherwise return it as-is.
    Called by rpc.service.new_channel — production code never imports this."""
    st = _STATE
    if st is None:
        return channel
    return ChaosChannel(channel, target, origin, st)


def name_endpoint(host: str, port: int, name: str) -> None:
    """Register a human name ('w2', 'master') for an endpoint so partition
    specs can reference it; no-op when no plan is installed."""
    st = _STATE
    if st is not None:
        st.name_endpoint(host, port, name)


def arm() -> None:
    """Start the installed plan's fault clock (see ChaosState.arm)."""
    st = _STATE
    if st is not None:
        st.arm()
