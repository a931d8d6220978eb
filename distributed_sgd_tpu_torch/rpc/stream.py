"""Persistent per-worker gradient streams (DSGD_STREAM) and the shared
deadline wheel: the port of the JAX package's rpc/stream.py.

``FitStreamClient`` replaces the master's one unary ``Gradient`` call per
worker per window with ONE bidirectional ``FitStream`` RPC per (master,
worker) pair for the life of a fit: each window's ``GradientRequest``
rides a framed envelope (``pb.Frame``, stamped with a per-stream monotone
``seq``) down the open stream, the worker answers on the same stream, and
a reader thread matches replies to in-flight sends by ``seq``, exposing
each send as a grpc.Future-alike, so the master's barriers consume stream
replies exactly as they consume unary ones.

Fault contract:

- A frame with NO reply by its deadline settles DEADLINE_EXCEEDED, as a
  unary call does, and its late reply, if one lands, is dropped by seq
  (counted).  The stream stays open: a lost frame is not a dead peer.
- A stream that TEARS DOWN (a worker crash, UNIMPLEMENTED from a worker
  without the method) settles every in-flight send, but each of those
  futures re-issues its request over the unary ``Gradient`` with the
  deadline it has left: the window completes without burning a retry.
  The breaker feed (``on_break``) is the caller's: core/master.py trips
  the per-peer CircuitBreaker and stops reopening while it suppresses.
- UNIMPLEMENTED marks the client permanently ``unsupported``: every later
  send for that worker goes straight to unary.

The frame deadlines sit on one shared ``Wheel`` thread, not on a timer or
a thread per frame: a frame costs one heap push.  The master's heartbeat
(core/master.py ``_heartbeat_loop``) schedules its probes on a wheel of
its own.  Under a chaos plan (chaos/, DSGD_CHAOS) each outgoing frame
passes the plan's decisions; a duplicated frame's second reply finds its
seq retired and is dropped, counted ``master.sync.stream.late`` as a
late reply is.
"""

from __future__ import annotations

import heapq
import queue
import threading
import time
from typing import Dict, Optional

import grpc

from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod


class StreamRpcError(grpc.RpcError):
    """Stream-transport failure carrying the .code()/.details() surface
    the barrier classification reads off every grpc.RpcError."""

    def __init__(self, code: grpc.StatusCode, details: str):
        super().__init__()
        self._code = code
        self._details = details

    def code(self) -> grpc.StatusCode:  # noqa: D102 - grpc surface
        return self._code

    def details(self) -> str:  # noqa: D102 - grpc surface
        return self._details

    def __str__(self):
        return f"StreamRpcError({self._code}: {self._details})"


class Wheel:
    """Items fire on the wheel's thread, so they must not block: flip an
    event, push to a deque.  An item is a callable (fired as ``item()``)
    or an object with ``_expire()``.  The thread dies after 5 s with
    nothing to watch, and the next watch starts it again."""

    def __init__(self, name: str = "deadline-wheel"):
        self._name = name
        self._cv = threading.Condition()
        self._heap: list = []
        self._seq = 0
        self._running = False

    def watch(self, deadline: float, item) -> None:
        with self._cv:
            self._seq += 1
            head = self._heap[0][0] if self._heap else None
            heapq.heappush(self._heap, (deadline, self._seq, item))
            if not self._running:
                self._running = True
                threading.Thread(target=self._run, daemon=True, name=self._name).start()
                self._cv.notify()
            elif head is None or deadline < head:
                # the sleeping thread's wait already covers a later deadline
                self._cv.notify()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._heap:
                    if not self._cv.wait(timeout=5.0) and not self._heap:
                        self._running = False
                        return
                due, _, item = self._heap[0]
                now = time.monotonic()
                if due > now:
                    self._cv.wait(timeout=due - now)
                    continue
                heapq.heappop(self._heap)
            try:
                if callable(item):
                    item()
                else:
                    item._expire()
            except Exception:  # noqa: BLE001 - one item must not kill the wheel
                pass


_WHEEL = Wheel(name="fitstream-wheel")


class _StreamFuture:
    """grpc.Future-alike for one in-flight stream frame, with a built-in
    unary fallback arm.

    Settles exactly once with the matched reply (``pb.GradUpdate``), a
    DEADLINE_EXCEEDED expiry from the wheel, the stream's terminal error,
    or CANCELLED.  ``stream_dead`` discriminates a torn-down stream from
    a per-frame deadline (the worker is slow/wedged — unary semantics say
    that IS the failure, and no fallback fires).  When the STREAM dies
    under an in-flight frame (teardown / UNIMPLEMENTED skew) and the
    caller supplied a unary escape hatch (``send(..., unary_call=,
    request=)``), the future transparently re-issues the SAME request
    over the classic unary Gradient with the deadline budget the stream
    attempt left unspent — the window completes without burning a retry,
    and only a unary failure ever reaches the eviction machinery."""

    __slots__ = ("_client", "seq", "_done", "_lock", "_result", "_exception",
                 "_cancelled", "_callbacks", "stream_dead", "_deadline",
                 "_unary", "_request", "_inner")

    def __init__(self, client: "FitStreamClient", seq: int,
                 deadline: float = 0.0, unary_call=None, request=None):
        self._client = client
        self.seq = seq
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._result = None
        self._exception: Optional[Exception] = None
        self._cancelled = False
        self._callbacks: list = []
        self.stream_dead = False
        self._deadline = deadline
        self._unary = unary_call
        self._request = request
        self._inner = None  # the unary fallback future, once issued

    def _settle(self, result=None, exception=None,
                stream_dead: bool = False) -> None:
        with self._lock:
            if self._done.is_set():
                return
            self._result, self._exception = result, exception
            self.stream_dead = stream_dead
            self._done.set()
            callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            try:
                cb(self)
            except Exception:  # noqa: BLE001 - callback errors stay local
                pass

    def _stream_died(self, err: Exception) -> None:
        """Teardown path: replay over unary when an escape hatch and
        deadline budget remain, else settle with the stream's error."""
        if self._done.is_set():
            return
        remaining = self._deadline - time.monotonic()
        if self._unary is None or self._cancelled or remaining <= 0.01:
            self._settle(exception=err, stream_dead=True)
            return
        client = self._client
        if client._metrics is not None:
            client._metrics.counter(metrics_mod.STREAM_FALLBACK).increment()
        try:
            inner = self._unary.future(self._request, timeout=remaining)
        except Exception as e:  # noqa: BLE001 - channel closed under us
            self._settle(exception=e, stream_dead=True)
            return
        with self._lock:
            if self._cancelled or self._done.is_set():
                inner.cancel()
                return
            self._inner = inner
        inner.add_done_callback(self._from_inner)

    def _from_inner(self, inner) -> None:
        try:
            self._settle(result=inner.result(), stream_dead=True)
        except Exception as e:  # noqa: BLE001 - grpc.RpcError expected
            self._settle(exception=e, stream_dead=True)

    def _expire(self) -> None:
        """Wheel callback: no reply by the frame's deadline.  The seq is
        retired so a late reply is dropped (counted), like a unary reply
        arriving after DEADLINE_EXCEEDED."""
        if self._done.is_set():
            return
        self._client._retire(self.seq, expired=True)
        self._settle(exception=StreamRpcError(
            grpc.StatusCode.DEADLINE_EXCEEDED, "stream frame deadline"))

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
        if self._done.is_set():
            return False
        self._client._retire(self.seq)
        with self._lock:
            self._cancelled = True
            inner = self._inner
        if inner is not None:
            inner.cancel()
        self._settle(exception=StreamRpcError(
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


_CLOSE = object()  # request-iterator sentinel: half-close the stream


class FitStreamClient:
    """One persistent FitStream RPC against one worker.

    ``send(frame, timeout_s)`` stamps the next ``seq`` on the frame,
    queues it for the stream's request iterator (serialization happens on
    gRPC's sender thread, OFF the master's dispatch path — with the
    weight arm pre-staged by the encode-ahead thread, dispatch is one
    queue put per worker), registers a pending future, and arms the
    shared deadline wheel.  The reader thread resolves futures by the
    reply frame's ``seq``.

    Thread-safe; ``broken``/``unsupported`` are sticky — a broken client
    is never reused (the owner opens a fresh one when the breaker
    allows), an unsupported one is never replaced (version skew does not
    heal mid-process)."""

    def __init__(self, stream_callable, peer: str,
                 metrics=None, log=None, on_break=None):
        self._peer = peer
        self._metrics = metrics
        self._log = log
        self._on_break = on_break
        self._lock = threading.Lock()
        self._sendq: "queue.SimpleQueue" = queue.SimpleQueue()
        self._pending: Dict[int, _StreamFuture] = {}
        self._seq = 0
        self.broken = False
        self.unsupported = False
        self._closed = False
        if metrics is not None:
            metrics.counter(metrics_mod.STREAM_OPENED).increment()
        self._call = stream_callable(self._req_iter())
        self._reader = threading.Thread(
            target=self._read_loop, daemon=True, name=f"fitstream-{peer}")
        self._reader.start()

    def _req_iter(self):
        while True:
            item = self._sendq.get()
            if item is _CLOSE:
                return
            yield item

    @property
    def usable(self) -> bool:
        # lock-free read of three monotone False->True flags: the worst
        # race admits one extra send() attempt, which re-checks under the
        # lock and returns None — dispatch fast paths stay allocation-
        # and lock-free
        return not (self._closed or self.broken or self.unsupported)

    def send(self, frame: pb.Frame, timeout_s: float,
             unary_call=None, request=None) -> Optional[_StreamFuture]:
        """Queue one request frame; returns its future, or None when the
        stream cannot carry it (broken/unsupported/closed) — the caller
        goes unary.  `unary_call`/`request` arm the future's transparent
        unary fallback for the teardown case (see _StreamFuture)."""
        deadline = time.monotonic() + float(timeout_s)
        with self._lock:
            if self._closed or self.broken or self.unsupported:
                return None
            self._seq += 1
            frame.seq = self._seq
            # envelope-level session attribution mirrors the payload's
            # authoritative token (rpc/proto/dsgd.proto Frame)
            frame.fit_token = frame.request.fit_token
            fut = _StreamFuture(self, self._seq, deadline=deadline,
                                unary_call=unary_call, request=request)
            self._pending[self._seq] = fut
        self._sendq.put(frame)
        if self._metrics is not None:
            self._metrics.counter(metrics_mod.STREAM_SENDS).increment()
        _WHEEL.watch(deadline, fut)
        return fut

    def _retire(self, seq: int, expired: bool = False) -> None:
        with self._lock:
            had = self._pending.pop(seq, None)
        if expired and had is not None and self._metrics is not None:
            self._metrics.counter(metrics_mod.STREAM_EXPIRED).increment()

    def _read_loop(self) -> None:
        err: Optional[Exception] = None
        try:
            for frame in self._call:
                with self._lock:
                    fut = self._pending.pop(frame.seq, None)
                if fut is None:
                    # a reply past its deadline (its seq was retired) or a
                    # duplicate: dropped idempotently, like quorum's late
                    # unary replies
                    if self._metrics is not None:
                        self._metrics.counter(
                            metrics_mod.STREAM_LATE).increment()
                    continue
                fut._settle(result=frame.update)
        except grpc.RpcError as e:
            err = e
        except Exception as e:  # noqa: BLE001 - classify below
            err = e
        if err is None:
            # server completed the stream (worker shut down cleanly or the
            # servicer loop exited): same terminal handling as an error
            err = StreamRpcError(grpc.StatusCode.UNAVAILABLE,
                                 "stream closed by peer")
        self._tear_down(err)

    def _tear_down(self, err: Exception) -> None:
        code = err.code() if isinstance(err, grpc.RpcError) else None
        with self._lock:
            locally_closed = self._closed
            self.broken = True
            if code == grpc.StatusCode.UNIMPLEMENTED:
                # version skew: the worker binary predates FitStream — go
                # (and stay) unary for this peer, no breaker pressure (an
                # old binary is not a sick one)
                self.unsupported = True
            pending, self._pending = self._pending, {}
        if locally_closed:
            # our own close() (fit end / unregister): abandoned futures —
            # e.g. quorum stragglers nobody will read — settle dead, they
            # must NOT replay over unary after the fit moved on
            for fut in pending.values():
                fut._settle(exception=err, stream_dead=True)
            return  # not a peer failure
        for fut in pending.values():
            fut._stream_died(err)
        if self._metrics is not None:
            self._metrics.counter(metrics_mod.STREAM_BROKEN).increment()
        if self._log is not None:
            self._log.warning(
                "FitStream to %s tore down (%s)%s", self._peer,
                code or err,
                " — unary from now on (version skew)" if self.unsupported
                else "; in-flight windows fall back to unary")
        if self._on_break is not None and not self.unsupported:
            try:
                self._on_break()
            except Exception:  # noqa: BLE001 - breaker feed must not recurse
                pass

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
        self._sendq.put(_CLOSE)
        try:
            self._call.cancel()
        except Exception:  # noqa: BLE001 - already dead is fine
            pass
