"""Distributed tracing: per-round span timelines across master / worker /
serving processes (docs/OBSERVABILITY.md).

The port's own copy of the JAX package's trace/__init__.py: the same span
and event names, the same gRPC metadata key and the same file format, so
one round that crosses a JAX node and a torch node merges into one trace.
The tracer is a process global of each package: in one process holding
both, each package has its own.

The repo's metrics (utils/metrics.py) reproduce the reference's AGGREGATE
observability surface; after the quorum/chaos layers the interesting
failures are CAUSAL — a stalled barrier, a hedge that lost to a late
reply, a chaos-injected delay masquerading as a slow kernel.  This module
is the Dapper-style answer: spans with a `TraceContext` propagated across
process boundaries via gRPC invocation metadata (rpc/service.py — the
proto wire stays byte-identical), exported as Chrome/Perfetto
trace-event JSON, one file per process, collated by
``python -m distributed_sgd_tpu_torch.trace.merge``.

Design rules:

- **Default-off, zero-cost off.**  With no tracer configured every public
  entry point returns the shared ``NOOP_SPAN`` singleton after one module
  global read — no Span object is ever allocated
  (the JAX package's tests/test_trace.py asserts this by making
  Span.__init__ raise; tests/test_torch_trace.py holds the port to it).
- **Head sampling per trace_id** (``DSGD_TRACE_SAMPLE``): the keep/drop
  decision is a pure function of the trace_id, so a sampled round is
  traced end-to-end on every node it touches — the master decides once
  per round and only sampled rounds ever put metadata on the wire, so
  workers need no local decision at all.
- **One trace per causal unit**: a sync fan-out window (one per
  step_version), an eval fan-out, a serving batch, an async gossip
  dispatch, a checkpoint save.  Chaos injections and quorum events attach
  as instant events inside the owning trace, so an injected fault is
  visibly attributed in the timeline.

Chrome trace-event mapping: spans are ``"ph": "X"`` complete events
(``ts`` wall-clock microseconds, ``dur`` from a perf_counter pair),
events are ``"ph": "i"`` instants; every record carries
``args.trace_id`` so the merge tool can collate and filter.  Node
identity (master / w0 / serve:PORT) maps onto the ``pid`` lane with a
``process_name`` metadata record, so a single-process DevCluster still
renders one lane per node in Perfetto.
"""

from __future__ import annotations

import atexit
import json
import os
import threading
import time
import zlib
from typing import Dict, List, NamedTuple, Optional, Tuple

# gRPC invocation-metadata key carrying "trace_id-span_id" (lowercase
# ASCII per the gRPC metadata rules); absence = untraced call
METADATA_KEY = "dsgd-trace"

# -- span/event name constants (consistency-tested with the metrics
# constants, tests/test_torch_provision.py).  The JAX package's
# "kernel.scatter" (its DSGD_SCATTER formulation) has no counterpart: the
# port has one formulation and reads no DSGD_SCATTER --------------------
SPAN_SYNC_WINDOW = "sync.window"        # master: one fan-out round
SPAN_EVAL_FORWARD = "eval.forward"      # master: one predict fan-out
EVENT_QUORUM_DEGRADED = "quorum.degraded"  # round closed < full strength
EVENT_QUORUM_HEDGE = "quorum.hedge"        # hedge request issued
EVENT_QUORUM_HEDGE_WIN = "quorum.hedge_win"  # slice covered by a hedge
EVENT_QUORUM_LATE = "quorum.late"          # late reply discarded
EVENT_BARRIER_STALLED = "barrier.stalled"  # soft deadline overrun, no relief
EVENT_BCAST_STALE = "bcast.stale"          # stale replica -> full fallback
EVENT_EF_ROLLBACK = "ef.rollback"          # worker rolled back an EF drain
EVENT_TOPOLOGY_RESELECT = "topology.reselect"  # gossip edge re-routed past a breaker
EVENT_HEALTH_TRIPPED = "health.tripped"        # training-health watchdog trip
EVENT_AUTOPILOT_TRANSITION = "autopilot.transition"  # flywheel state change
EVENT_LEAK_SUSPECT = "leak.suspect"            # resource-slope sentinel trip


class TraceContext(NamedTuple):
    """Propagated identity of one span: (trace_id, span_id, parent_id)."""

    trace_id: str
    span_id: str
    parent_id: str = ""


class _NoopSpan:
    """Shared do-nothing span for every sampled-off / tracing-off path.
    A singleton: the fast path allocates NOTHING (asserted by test)."""

    __slots__ = ()
    ctx = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def event(self, name: str, **args) -> None:
        pass

    def set(self, **args) -> None:
        pass

    def end(self, error: Optional[str] = None) -> None:
        pass


NOOP_SPAN = _NoopSpan()

_local = threading.local()


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def current() -> Optional[TraceContext]:
    """The calling thread's active TraceContext (None outside any span)."""
    st = getattr(_local, "stack", None)
    return st[-1][0] if st else None


def current_node() -> Optional[str]:
    """The node label of the calling thread's active span, if any."""
    st = getattr(_local, "stack", None)
    return st[-1][1] if st else None


class Span:
    """One timed operation.  Created ONLY by a live Tracer for a sampled
    trace; `end()` is idempotent and may run on any thread (client RPC
    spans end from gRPC future callbacks).  Entering as a context manager
    additionally installs the span as the thread's current context."""

    __slots__ = ("_tracer", "name", "ctx", "node", "args",
                 "_t0_wall_ns", "_t0_pc", "_ended", "_entered")

    def __init__(self, tracer: "Tracer", name: str, ctx: TraceContext,
                 node: str, args: Optional[dict]):
        self._tracer = tracer
        self.name = name
        self.ctx = ctx
        self.node = node
        self.args = dict(args) if args else {}
        self._t0_wall_ns = time.time_ns()
        self._t0_pc = time.perf_counter()
        self._ended = False
        self._entered = False

    def set(self, **args) -> None:
        self.args.update(args)

    def event(self, name: str, **args) -> None:
        """Attach an instant event inside this span's trace."""
        self._tracer._emit_instant(name, self.ctx, self.node, args)

    def end(self, error: Optional[str] = None) -> None:
        if self._ended:
            return
        self._ended = True
        if error is not None:
            self.args["error"] = error
        dur_us = (time.perf_counter() - self._t0_pc) * 1e6
        self._tracer._emit_span(self, dur_us)

    def __enter__(self) -> "Span":
        _stack().append((self.ctx, self.node))
        self._entered = True
        return self

    def __exit__(self, etype, evalue, tb):
        if self._entered:
            _stack().pop()
            self._entered = False
        self.end(error=repr(evalue) if evalue is not None else None)
        return False


class Tracer:
    """Per-process span collector writing one Chrome trace-event file."""

    MAX_EVENTS = 200_000  # hard buffer cap; beyond it spans are counted, dropped

    def __init__(self, dir: Optional[str] = None, sample: float = 1.0,
                 service: Optional[str] = None):
        self.dir = dir
        self.sample = float(sample)
        self.service = service or f"proc-{os.getpid()}"
        self._events: List[dict] = []
        self._lock = threading.Lock()
        self._dropped = 0
        self._pids: Dict[str, int] = {}
        self._ids = threading.local()
        self.path = None
        if dir:
            os.makedirs(dir, exist_ok=True)
            self.path = os.path.join(
                dir, f"trace-{self.service}-{os.getpid()}.json")

    # -- ids / sampling ------------------------------------------------------

    def _new_id(self) -> str:
        # cheap per-thread counter mixed with entropy once per thread: ids
        # must be unique, not unguessable
        st = self._ids
        base = getattr(st, "base", None)
        if base is None:
            base = st.base = os.urandom(6).hex()
            st.n = 0
        st.n += 1
        return f"{base}{st.n:x}"

    def sampled(self, trace_id: str) -> bool:
        """Deterministic head sampling: a pure function of the trace_id, so
        every process keeps or drops the same rounds."""
        if self.sample >= 1.0:
            return True
        if self.sample <= 0.0:
            return False
        return zlib.crc32(trace_id.encode()) / 2**32 < self.sample

    # -- span construction ---------------------------------------------------

    def root_span(self, name: str, node: Optional[str] = None, **args):
        """Start a NEW trace (fresh trace_id, head-sampled)."""
        trace_id = self._new_id()
        if not self.sampled(trace_id):
            return NOOP_SPAN
        ctx = TraceContext(trace_id, self._new_id(), "")
        return Span(self, name, ctx, node or self.service, args)

    def child_span(self, name: str, parent: TraceContext,
                   node: Optional[str] = None, **args):
        ctx = TraceContext(parent.trace_id, self._new_id(), parent.span_id)
        return Span(self, name, ctx, node or current_node() or self.service,
                    args)

    def span(self, name: str, node: Optional[str] = None, root: bool = True,
             **args):
        """Child of the thread's current context; with no context, a new
        sampled root when ``root=True`` (a designated causal unit) or
        NOOP_SPAN when ``root=False`` (a helper span: rooting here would
        emit orphan one-span fragment traces on every unsampled or
        untraced call — the sampling decision belongs to the unit that
        owns the round)."""
        parent = current()
        if parent is None:
            if not root:
                return NOOP_SPAN
            return self.root_span(name, node=node, **args)
        return self.child_span(name, parent, node=node, **args)

    # -- emit ----------------------------------------------------------------

    def _pid_for(self, node: str) -> int:
        with self._lock:
            pid = self._pids.get(node)
            if pid is None:
                pid = 1 + zlib.crc32(node.encode()) % 1_000_000
                self._pids[node] = pid
                self._events.append({
                    "ph": "M", "name": "process_name", "pid": pid, "tid": 0,
                    "args": {"name": node},
                })
        return pid

    def _append(self, record: dict) -> None:
        with self._lock:
            if len(self._events) >= self.MAX_EVENTS:
                self._dropped += 1
                return
            self._events.append(record)

    def _emit_span(self, span: Span, dur_us: float) -> None:
        args = span.args
        args["trace_id"] = span.ctx.trace_id
        args["span_id"] = span.ctx.span_id
        if span.ctx.parent_id:
            args["parent_id"] = span.ctx.parent_id
        self._append({
            "ph": "X", "name": span.name, "cat": "dsgd",
            "ts": span._t0_wall_ns / 1000.0, "dur": dur_us,
            "pid": self._pid_for(span.node), "tid": threading.get_native_id(),
            "args": args,
        })

    def _emit_instant(self, name: str, ctx: TraceContext, node: str,
                      args: dict) -> None:
        args = dict(args)
        args["trace_id"] = ctx.trace_id
        args["span_id"] = ctx.span_id
        self._append({
            "ph": "i", "name": name, "cat": "dsgd", "s": "t",
            "ts": time.time_ns() / 1000.0,
            "pid": self._pid_for(node), "tid": threading.get_native_id(),
            "args": args,
        })

    # -- export --------------------------------------------------------------

    def events(self) -> List[dict]:
        with self._lock:
            return list(self._events)

    def buffered(self) -> int:
        """Events currently held (lock-free: len() of a list is GIL-atomic).
        The resource probe's trace-buffer pressure gauge — a buffer that
        only ever grows until flush is exactly the kind of slow fill the
        long-horizon plane exists to see."""
        return len(self._events)

    def flush(self) -> Optional[str]:
        """Write the full buffer as one Chrome trace-event JSON file
        (atomic replace; repeat flushes rewrite the same path)."""
        if self.path is None:
            return None
        with self._lock:
            snapshot = list(self._events)
            dropped = self._dropped
        payload = {"traceEvents": snapshot, "displayTimeUnit": "ms",
                   "otherData": {"service": self.service,
                                 "pid": os.getpid(),
                                 "dropped_events": dropped}}
        tmp = f"{self.path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self.path)
        return self.path


# -- module-level configuration (the zero-cost gate) --------------------------
#
# _TRACER is None when tracing is off; every hot-path helper checks that
# one global before doing anything else.  main.py configures from
# DSGD_TRACE / DSGD_TRACE_DIR / DSGD_TRACE_SAMPLE; tests call configure()
# directly.

_TRACER: Optional[Tracer] = None
_ATEXIT_REGISTERED = False


def configure(enabled: bool = False, dir: Optional[str] = None,
              sample: float = 1.0, service: Optional[str] = None
              ) -> Optional[Tracer]:
    """Install (or remove, enabled=False) the process tracer."""
    global _TRACER, _ATEXIT_REGISTERED
    if not enabled:
        _TRACER = None
        return None
    _TRACER = Tracer(dir=dir, sample=sample, service=service)
    if not _ATEXIT_REGISTERED:
        _ATEXIT_REGISTERED = True
        atexit.register(flush)
    return _TRACER


def active() -> Optional[Tracer]:
    return _TRACER


def span(name: str, node: Optional[str] = None, root: bool = True, **args):
    """Child span of the current context (or, with ``root=True``, a new
    sampled root); NOOP_SPAN when tracing is off, and also when
    ``root=False`` with no active context."""
    t = _TRACER
    if t is None:
        return NOOP_SPAN
    return t.span(name, node=node, root=root, **args)


def root_span(name: str, node: Optional[str] = None, **args):
    """Always a NEW trace (one per causal unit); NOOP_SPAN when off."""
    t = _TRACER
    if t is None:
        return NOOP_SPAN
    return t.root_span(name, node=node, **args)


def event(name: str, **args) -> None:
    """Instant event inside the current trace; dropped when tracing is off
    or no trace is active (event volume stays tied to sampled traces)."""
    t = _TRACER
    if t is None:
        return
    ctx = current()
    if ctx is None:
        return
    t._emit_instant(name, ctx, current_node() or t.service, args)


def event_in(ctx: Optional[TraceContext], name: str,
             node: Optional[str] = None, **args) -> None:
    """Instant event inside an EXPLICIT context — for callbacks that run
    after the owning thread moved on (e.g. a late quorum reply settling
    on a gRPC thread).  Capture `current()` where the context is live and
    pass it here; no-op when off or ctx is None."""
    t = _TRACER
    if t is None or ctx is None:
        return
    t._emit_instant(name, ctx, node or t.service, args)


def flush() -> Optional[str]:
    t = _TRACER
    return t.flush() if t is not None else None


# -- cross-process propagation ------------------------------------------------


def inject(ctx: TraceContext) -> Tuple[Tuple[str, str], ...]:
    """TraceContext -> gRPC invocation-metadata pairs."""
    return ((METADATA_KEY, f"{ctx.trace_id}-{ctx.span_id}"),)


def extract(metadata) -> Optional[TraceContext]:
    """gRPC invocation metadata -> the SENDER's TraceContext (used as the
    parent of the server-side span), or None when untraced."""
    if not metadata:
        return None
    for key, value in metadata:
        if key == METADATA_KEY:
            trace_id, sep, span_id = value.rpartition("-")
            if not sep or not trace_id or not span_id:
                # malformed header: leave the call untraced rather than
                # fabricate a parentless context (it would render as a
                # spurious second root in the merged timeline)
                return None
            return TraceContext(trace_id, span_id, "")
    return None
