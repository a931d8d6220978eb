"""Hand-written gRPC service bindings.

The port's copy of the JAX package's rpc/service.py: the same services,
method tables and trace hooks, so a JAX master drives torch workers and a
torch master drives JAX workers.  `new_channel` wraps each channel in
the port's fault-injection layer (chaos/, DSGD_CHAOS) when a plan is
installed, and returns the raw channel otherwise.

grpc_tools (the protoc python-grpc plugin) is not available in this image,
so stubs and servicer registration are built from a method table using
grpc's generic API — functionally identical to generated `*_pb2_grpc.py`.
Service surface mirrors the reference IDL (proto.proto:13-49); channel and
server factories mirror core/package.scala:16-21 (plaintext).
"""

from __future__ import annotations

import random
import threading
import time
from concurrent import futures
from typing import Dict, Hashable, Optional

import grpc

from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.trace import flight


class CircuitBreaker:
    """Per-peer circuit breaker with half-open probes (docs/FAULT_TOLERANCE.md).

    CLOSED counts consecutive failures; at `failures` it OPENS and
    `allow()` refuses every call for `reset_s`.  After the cooldown the
    breaker goes HALF-OPEN and grants exactly ONE probe call; the probe's
    outcome decides — success closes the breaker, failure re-opens it for
    another full cooldown.  All transitions are thread-safe; senders that
    fire-and-forget report outcomes from future done-callbacks.
    """

    CLOSED, OPEN, HALF_OPEN = "closed", "open", "half_open"

    def __init__(self, failures: int = 5, reset_s: float = 10.0,
                 metrics=None, name: str = ""):
        self.failures = max(1, int(failures))
        self.reset_s = float(reset_s)
        self._metrics = metrics
        self._name = name
        self._lock = threading.Lock()
        self._state = self.CLOSED
        self._count = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_at = 0.0

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """May a call proceed right now?  In HALF_OPEN only one probe is
        granted at a time; callers that get True MUST report the outcome
        via record_ok/record_failure or the breaker stays probe-locked
        until the next cooldown."""
        with self._lock:
            if self._state == self.CLOSED:
                return True
            now = time.monotonic()
            if self._state == self.OPEN:
                if now - self._opened_at < self.reset_s:
                    return False
                self._state = self.HALF_OPEN
                self._probe_inflight = False
            # HALF_OPEN: one probe slot — but a probe whose outcome never
            # arrived (a black-holed fire-and-forget send) must not lock
            # the breaker forever, so the slot re-opens after reset_s
            if self._probe_inflight and now - self._probe_at < self.reset_s:
                return False
            self._probe_inflight = True
            self._probe_at = now
            return True

    def suppressed(self) -> bool:
        """Would `allow()` refuse a call right now?  READ-ONLY: unlike
        allow() this never transitions OPEN->HALF_OPEN and never consumes
        the half-open probe slot, so the sparse-gossip topology layer can
        route around a tripped peer (parallel/topology.py reselection)
        without stealing the probe that would eventually heal it."""
        with self._lock:
            if self._state == self.CLOSED:
                return False
            now = time.monotonic()
            if self._state == self.OPEN:
                return now - self._opened_at < self.reset_s
            return self._probe_inflight and now - self._probe_at < self.reset_s

    def record_ok(self) -> None:
        with self._lock:
            self._state = self.CLOSED
            self._count = 0
            self._probe_inflight = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == self.HALF_OPEN:
                self._trip()
                return
            self._count += 1
            if self._state == self.CLOSED and self._count >= self.failures:
                self._trip()

    def _trip(self) -> None:
        self._state = self.OPEN
        self._opened_at = time.monotonic()
        self._count = 0
        self._probe_inflight = False
        if self._metrics is not None:
            self._metrics.counter("rpc.breaker.open").increment()
        # post-mortem evidence: breaker trips are exactly the kind of
        # cascade precursor a dead run's flight dump must contain
        flight.record("breaker.open", peer=self._name)


class RpcPolicy:
    """One client-side RPC fault policy for the whole control plane
    (docs/FAULT_TOLERANCE.md): per-call deadline, exponential backoff
    with full jitter, a retry budget, and per-peer circuit breakers with
    half-open probes.  Replaces the scattered hardcoded ``timeout=5.0``
    and fixed-sleep retries across registration, peer introduction,
    heartbeat, StopAsync, and gossip.

    Defaults keep the reference's registration behavior as the baseline:
    a 5 s call deadline (Slave.scala:48) and a 2 s first retry delay
    (Slave.scala:56) — now growing exponentially with full jitter
    (AWS-style: sleep ~ U(0, min(cap, base * mult^attempt))) up to a
    ~30 s cap instead of retrying every 2 s forever.
    """

    def __init__(
        self,
        deadline_s: float = 5.0,            # Slave.scala:48
        initial_backoff_s: float = 2.0,     # Slave.scala:56
        max_backoff_s: float = 30.0,
        multiplier: float = 2.0,
        retries: int = 3,                   # budget for call_with_retry
        breaker_failures: int = 5,
        breaker_reset_s: float = 10.0,
        seed: Optional[int] = None,
        metrics=None,
    ):
        if deadline_s <= 0 or initial_backoff_s <= 0 or max_backoff_s <= 0:
            raise ValueError("RpcPolicy deadlines/backoffs must be > 0")
        if multiplier < 1.0:
            raise ValueError("RpcPolicy multiplier must be >= 1")
        self.deadline_s = float(deadline_s)
        self.initial_backoff_s = float(initial_backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.multiplier = float(multiplier)
        self.retries = max(0, int(retries))
        self.breaker_failures = int(breaker_failures)
        self.breaker_reset_s = float(breaker_reset_s)
        self._metrics = metrics
        self._rng = random.Random(seed)
        self._breakers: Dict[Hashable, CircuitBreaker] = {}
        self._lock = threading.Lock()

    def backoff_cap_s(self, attempt: int) -> float:
        """Deterministic exponential cap for retry `attempt` (0-based)."""
        return min(self.max_backoff_s,
                   self.initial_backoff_s * self.multiplier ** attempt)

    def backoff_s(self, attempt: int) -> float:
        """Full-jitter sleep for retry `attempt`: U(0, cap(attempt))."""
        return self._rng.uniform(0.0, self.backoff_cap_s(attempt))

    def breaker(self, peer: Hashable) -> CircuitBreaker:
        """The per-peer breaker (created on first use)."""
        with self._lock:
            br = self._breakers.get(peer)
            if br is None:
                br = CircuitBreaker(self.breaker_failures,
                                    self.breaker_reset_s,
                                    metrics=self._metrics, name=str(peer))
                self._breakers[peer] = br
            return br

    def call_with_retry(self, call, request, peer: Hashable = None,
                        retries: Optional[int] = None, log=None):
        """Blocking unary call under the full policy: deadline per
        attempt, breaker consult (peer given), jittered backoff between
        attempts, at most `retries` re-attempts.  Raises the last
        grpc.RpcError when the budget is spent or the breaker refuses."""
        budget = self.retries if retries is None else max(0, int(retries))
        br = self.breaker(peer) if peer is not None else None
        last: Optional[Exception] = None
        for attempt in range(budget + 1):
            if br is not None and not br.allow():
                raise last if last is not None else _breaker_open_error(peer)
            try:
                reply = call(request, timeout=self.deadline_s)
                if br is not None:
                    br.record_ok()
                return reply
            except grpc.RpcError as e:
                if br is not None:
                    br.record_failure()
                last = e
                if attempt < budget:
                    delay = self.backoff_s(attempt)
                    if log is not None:
                        log.warning("rpc to %s failed (%s); retry %d/%d in %.1fs",
                                    peer, e.code(), attempt + 1, budget, delay)
                    time.sleep(delay)
        raise last


class BreakerOpenError(grpc.RpcError):
    """Raised client-side when a peer's breaker refuses the call; carries
    the .code()/.details() surface callers read off grpc.RpcError."""

    def __init__(self, peer):
        super().__init__()
        self._peer = peer

    def code(self) -> grpc.StatusCode:  # noqa: D102 - grpc surface
        return grpc.StatusCode.UNAVAILABLE

    def details(self) -> str:  # noqa: D102 - grpc surface
        return f"circuit breaker open for {self._peer}"

    def __str__(self):
        return self.details()


def _breaker_open_error(peer) -> grpc.RpcError:
    return BreakerOpenError(peer)

_MASTER_METHODS = {
    "RegisterSlave": (pb.Node, pb.Ack),
    "UnregisterSlave": (pb.Node, pb.Ack),
    "UpdateGrad": (pb.GradUpdate, pb.Ack),
    # master membership probe for the workers' re-registration watch
    # (docs/ELASTICITY.md): the worker sends its own Node identity and a
    # reachable master that does NOT know the caller answers NOT_FOUND —
    # the signal that survives a fast restart rebinding the same port
    # (plain unreachability would never trip: the new master answers).
    # Reuses the Node/Ack pair, no new proto message; an older master
    # answers UNIMPLEMENTED, which the watch treats as a miss only when
    # explicitly enabled (master_watch_s)
    "Ping": (pb.Node, pb.Ack),
}

_WORKER_METHODS = {
    "RegisterSlave": (pb.Node, pb.Ack),
    "UnregisterSlave": (pb.Node, pb.Ack),
    "Ping": (pb.Empty, pb.Ack),
    "Forward": (pb.ForwardRequest, pb.ForwardReply),
    "Gradient": (pb.GradientRequest, pb.GradUpdate),
    "StartAsync": (pb.StartAsyncRequest, pb.Ack),
    "StopAsync": (pb.Empty, pb.Ack),
    "UpdateGrad": (pb.GradUpdate, pb.Ack),
    # cluster telemetry scrape (telemetry/, docs/OBSERVABILITY.md): the
    # master pulls this node's full instrument registry; an older binary
    # without the method answers UNIMPLEMENTED, which the scraper treats
    # as a degraded-but-non-fatal miss
    "Metrics": (pb.Empty, pb.MetricsSnapshot),
    # aggregation-tree child push (DSGD_AGG_TREE, docs/AGGREGATION.md):
    # a tree child delivers its encoded subtree sum to its elected
    # parent; an older binary answers UNIMPLEMENTED, the push fails, and
    # the child replies direct-to-master tagged agg_flat (flat fallback)
    "AggregateGrad": (pb.AggGrad, pb.Ack),
}

# Bidirectional streaming surface (DSGD_STREAM, docs/SYNC_PIPELINE.md):
# registered with stream_stream handlers/multicallables instead of the
# unary tables above.  FitStream is in _OPTIONAL_METHODS — an older worker
# binary registers no handler, callers get UNIMPLEMENTED, and the master's
# stream client falls back to the unary Gradient for that worker
# (rpc/stream.py), so mixed fleets keep working across the skew.
_WORKER_STREAM_METHODS = {
    "FitStream": (pb.Frame, pb.Frame),
}

# The inference front end (serving/): no reference counterpart — the
# reference's only inference surface is the in-fit Forward above.  The
# router (serving/router.py) speaks the SAME service, so a client cannot
# tell one replica from a fleet.
_SERVE_METHODS = {
    "Predict": (pb.PredictRequest, pb.PredictReply),
    "ServeHealth": (pb.Empty, pb.ServeHealthReply),
    "Metrics": (pb.Empty, pb.MetricsSnapshot),
    # delta checkpoint distribution (docs/SERVING.md "serving fleet"): the
    # trainer's master — or the router fanning a push out — streams
    # versioned weight updates; an older replica answers UNIMPLEMENTED and
    # keeps hot-reloading from the checkpoint files instead
    "PushWeights": (pb.PushWeightsRequest, pb.PushWeightsReply),
    # serving-plane HA peer sync (DSGD_SERVE_HA, docs/SERVING.md "HA"):
    # dual LIVE routers exchange their versioned promoted-state records;
    # an older binary (or a plain replica) answers UNIMPLEMENTED and the
    # coordinator counts a missed sync instead of failing the router
    "SyncServeState": (pb.SyncServeStateRequest, pb.SyncServeStateReply),
}

# Methods a servicer may legitimately lack (older binaries, partial test
# stubs): absent -> no handler -> UNIMPLEMENTED to callers.  Everything
# else is required and fails server construction when missing.
_OPTIONAL_METHODS = frozenset(
    {"Metrics", "PushWeights", "FitStream", "AggregateGrad",
     "SyncServeState"})


def _traced_handler(fn, method: str, node: Optional[str]):
    """Server-side trace hook (docs/OBSERVABILITY.md): when the inbound
    call carries a TraceContext in its invocation metadata (the client
    side only injects for sampled traces), run the method body inside a
    server span that is a child of the caller's span — installed as the
    thread's current context, so worker-side measure.span()s become
    grandchildren automatically.  With tracing off (or an untraced call)
    this is one global read + one metadata scan, no allocation."""

    def handler(request, context):
        t = trace_mod._TRACER
        if t is None:
            return fn(request, context)
        ctx = trace_mod.extract(context.invocation_metadata())
        if ctx is None:
            return fn(request, context)
        with t.child_span(method, ctx, node=node):
            return fn(request, context)

    return handler


def _add_servicer(server, servicer, service_name: str, methods: dict,
                  node: Optional[str] = None,
                  stream_methods: Optional[dict] = None) -> None:
    handlers = {}
    for name, (req, resp) in methods.items():
        if name in _OPTIONAL_METHODS and not hasattr(servicer, name):
            # version-skew tolerance for the OPTIONAL surface only: a
            # servicer that predates it registers no handler and callers
            # get the standard UNIMPLEMENTED.  Required methods keep the
            # loud build-time AttributeError below — a typo'd core
            # handler must not become a mid-fit UNIMPLEMENTED the
            # retry/eviction machinery misreads as a dead peer.
            continue
        fn = _traced_handler(getattr(servicer, name), name, node)
        handlers[name] = grpc.unary_unary_rpc_method_handler(
            fn, request_deserializer=req.FromString, response_serializer=resp.SerializeToString
        )
    for name, (req, resp) in (stream_methods or {}).items():
        if name in _OPTIONAL_METHODS and not hasattr(servicer, name):
            continue  # same skew rule as above: absent -> UNIMPLEMENTED
        # bidi streams skip the per-call trace hook: the handler runs once
        # per STREAM, not per frame, so a per-call server span would pin
        # one span open for the whole fit (per-round attribution stays on
        # the master's sync.window root spans)
        handlers[name] = grpc.stream_stream_rpc_method_handler(
            getattr(servicer, name),
            request_deserializer=req.FromString,
            response_serializer=resp.SerializeToString,
        )
    server.add_generic_rpc_handlers(
        (grpc.method_handlers_generic_handler(service_name, handlers),)
    )


def add_master_servicer(server, servicer, node: Optional[str] = None) -> None:
    _add_servicer(server, servicer, "dsgd.Master", _MASTER_METHODS, node=node)


def add_worker_servicer(server, servicer, node: Optional[str] = None) -> None:
    _add_servicer(server, servicer, "dsgd.Worker", _WORKER_METHODS, node=node,
                  stream_methods=_WORKER_STREAM_METHODS)


def add_serve_servicer(server, servicer, node: Optional[str] = None) -> None:
    _add_servicer(server, servicer, "dsgd.Serving", _SERVE_METHODS, node=node)


class _TracingCallable:
    """Client-side trace hook around one unary-unary multicallable.

    When the calling thread is inside a sampled trace (a master fan-out
    window, a serving request, ...), each RPC through this callable gets
    its own client span — hedges and retries included, each a sibling
    child of the SAME parent span — and the context rides the gRPC
    invocation metadata (trace.METADATA_KEY), leaving the proto wire
    byte-identical.  Outside a trace (or with tracing off) the call
    passes straight through: one module-global read, zero allocation
    (tests/test_trace.py asserts the fast path never constructs a Span).
    """

    __slots__ = ("_inner", "_method", "_peer")

    def __init__(self, inner, method: str, peer: Optional[str]):
        self._inner = inner
        self._method = method
        self._peer = peer

    def _span(self, tracer, ctx):
        return tracer.child_span(f"rpc.{self._method}", ctx, peer=self._peer)

    @staticmethod
    def _inject(kwargs, span):
        md = tuple(kwargs.get("metadata") or ()) + trace_mod.inject(span.ctx)
        kwargs["metadata"] = md
        return kwargs

    @staticmethod
    def _end_from_future(span, fut) -> None:
        try:
            if fut.cancelled():
                span.end(error="cancelled")
                return
            exc = fut.exception()
        except Exception as e:  # noqa: BLE001 - unreadable future = failed
            span.end(error=repr(e))
            return
        span.end(error=str(exc) if exc is not None else None)

    def __call__(self, request, timeout=None, **kwargs):
        t = trace_mod._TRACER
        ctx = trace_mod.current() if t is not None else None
        if ctx is None:
            return self._inner(request, timeout=timeout, **kwargs)
        span = self._span(t, ctx)
        try:
            reply = self._inner(request, timeout=timeout,
                                **self._inject(kwargs, span))
            span.end()
            return reply
        except Exception as e:
            span.end(error=repr(e))
            raise

    def future(self, request, timeout=None, **kwargs):
        t = trace_mod._TRACER
        ctx = trace_mod.current() if t is not None else None
        if ctx is None:
            return self._inner.future(request, timeout=timeout, **kwargs)
        span = self._span(t, ctx)
        try:
            fut = self._inner.future(request, timeout=timeout,
                                     **self._inject(kwargs, span))
        except Exception as e:  # ValueError: channel closed under us
            span.end(error=repr(e))
            raise
        fut.add_done_callback(lambda f: self._end_from_future(span, f))
        return fut


class _Stub:
    def __init__(self, channel, service_name: str, methods: dict,
                 stream_methods: Optional[dict] = None):
        # channel factories stamp their endpoint on the channel
        # (new_channel below) so client spans can name their peer
        target = getattr(channel, "dsgd_target", None)
        peer = f"{target[0]}:{target[1]}" if target else None
        self.dsgd_peer = peer
        for name, (req, resp) in methods.items():
            setattr(
                self,
                name,
                _TracingCallable(
                    channel.unary_unary(
                        f"/{service_name}/{name}",
                        request_serializer=req.SerializeToString,
                        response_deserializer=resp.FromString,
                    ),
                    name,
                    peer,
                ),
            )
        for name, (req, resp) in (stream_methods or {}).items():
            # bidi multicallable, untraced (one call per STREAM — per-frame
            # spans would cost per-round allocation on the hot path; the
            # master's sync.window root spans keep round attribution)
            setattr(
                self,
                name,
                channel.stream_stream(
                    f"/{service_name}/{name}",
                    request_serializer=req.SerializeToString,
                    response_deserializer=resp.FromString,
                ),
            )


class MasterStub(_Stub):
    def __init__(self, channel):
        super().__init__(channel, "dsgd.Master", _MASTER_METHODS)


class WorkerStub(_Stub):
    def __init__(self, channel):
        super().__init__(channel, "dsgd.Worker", _WORKER_METHODS,
                         stream_methods=_WORKER_STREAM_METHODS)


class ServeStub(_Stub):
    def __init__(self, channel):
        super().__init__(channel, "dsgd.Serving", _SERVE_METHODS)


class GossipSender:
    """Bounded fire-and-forget sender for async delta gossip.

    The reference gossips with no delivery guarantee (fire-and-forget gRPC,
    Slave.scala:103-105); a naive `.future(msg)` translation accumulates
    unbounded in-flight RPCs against a slow or wedged peer.  This keeps at
    most `max_inflight` outstanding UpdateGrad calls per peer: completed
    futures are pruned on every send, and when the window is still full the
    OLDEST in-flight call is cancelled — and counted under
    `slave.async.grad.dropped` once it settles as actually-cancelled (a
    call already executing server-side may still be delivered despite the
    cancel) — the same drop-oldest-under-overload policy as the in-process
    engine's bounded inbox (parallel/hogwild.py).  Every call made is
    counted under `slave.async.grad.sent` (the port's counter; the JAX
    sender counts only drops).

    With a `breaker` (CircuitBreaker), sends to a partitioned peer are
    SUPPRESSED while the breaker is open — one half-open probe per
    cooldown instead of 64 in-flight cancels — counted under
    `slave.async.grad.suppressed`; every real send's outcome feeds the
    breaker from its done-callback (a cancel from the drop-oldest window
    is NOT a peer failure and reports nothing).  `deadline_s` bounds each
    send so a black-holed peer's futures FAIL (DEADLINE_EXCEEDED) instead
    of hanging forever — without it nothing would ever reach the breaker
    on a silent partition, because the only exit for a hung future is our
    own drop-oldest cancel, which deliberately reports nothing.
    """

    def __init__(self, call, metrics=None, max_inflight: int = 64,
                 breaker: Optional[CircuitBreaker] = None,
                 deadline_s: Optional[float] = None):
        self._call = call  # e.g. stub.UpdateGrad
        self._metrics = metrics
        self.max_inflight = max(1, int(max_inflight))
        self.breaker = breaker
        self.deadline_s = deadline_s
        self._inflight: list = []
        # close() may run on a gRPC servicer thread (peer unregistered)
        # while the async loop still holds a snapshot of this sender: the
        # lock + closed flag stop a late send() from re-populating the
        # window with a future nobody would ever cancel
        self._lock = threading.Lock()
        self._closed = False

    def _report_to_breaker(self, fut) -> None:
        if fut.cancelled():
            return  # our own drop-oldest window, not the peer's fault
        try:
            failed = fut.exception() is not None
        except Exception:  # noqa: BLE001 - treat an unreadable future as failed
            failed = True
        (self.breaker.record_failure if failed else self.breaker.record_ok)()

    def send(self, msg) -> None:
        with self._lock:
            if self._closed:
                return
            if self.breaker is not None and not self.breaker.allow():
                if self._metrics is not None:
                    self._metrics.counter(
                        "slave.async.grad.suppressed").increment()
                return
            self._inflight = [f for f in self._inflight if not f.done()]
            while len(self._inflight) >= self.max_inflight:
                old = self._inflight.pop(0)
                old.cancel()  # best-effort; the delta is lost, as the wire allows
                if self._metrics is not None:
                    # grpc cancel is best-effort: a call already executing
                    # server-side is still delivered, so count the drop only
                    # once the future settles as actually-cancelled —
                    # otherwise slave.async.grad.dropped overstates delta loss
                    metrics = self._metrics
                    old.add_done_callback(
                        lambda f: f.cancelled()
                        and metrics.counter("slave.async.grad.dropped").increment()
                    )
            try:
                if self.deadline_s is not None:
                    fut = self._call.future(msg, timeout=self.deadline_s)
                else:
                    fut = self._call.future(msg)
            except ValueError:  # channel closed under us
                return
            self._inflight.append(fut)
            if self._metrics is not None:
                self._metrics.counter("slave.async.grad.sent").increment()
            if self.breaker is not None:
                fut.add_done_callback(self._report_to_breaker)

    @property
    def inflight(self) -> int:
        with self._lock:
            return sum(1 for f in self._inflight if not f.done())

    def close(self) -> None:
        with self._lock:
            self._closed = True
            for f in self._inflight:
                f.cancel()
            self._inflight.clear()


def new_server(port: int, host: str = "0.0.0.0", max_workers: int = 16) -> grpc.Server:
    """Plaintext server factory (core/package.scala:16-17). Port 0 picks a
    free port; the bound port is stored on `server.bound_port`."""
    server = grpc.server(
        futures.ThreadPoolExecutor(max_workers=max_workers),
        options=[("grpc.max_receive_message_length", 64 * 1024 * 1024),
                 ("grpc.max_send_message_length", 64 * 1024 * 1024)],
    )
    server.bound_port = server.add_insecure_port(f"{host}:{port}")
    return server


def new_channel(host: str, port: int, origin=None) -> grpc.Channel:
    """Plaintext channel factory (core/package.scala:19-21).

    `origin` (the caller's own (host, port), optional) labels the edge
    for the fault-injection layer: when a chaos plan is installed
    (chaos/, DSGD_CHAOS) the channel is wrapped so every RPC through it
    passes the plan's drop/delay/dup/partition decisions -- a no-op
    returning the raw channel otherwise."""
    channel = grpc.insecure_channel(
        f"{host}:{port}",
        options=[("grpc.max_receive_message_length", 64 * 1024 * 1024),
                 ("grpc.max_send_message_length", 64 * 1024 * 1024)],
    )
    # endpoint label for client trace spans (read back through the chaos
    # proxy's __getattr__ when a plan wraps the channel)
    channel.dsgd_target = (host, int(port))
    from distributed_sgd_tpu_torch import chaos

    return chaos.wrap_channel(channel, target=(host, int(port)), origin=origin)
