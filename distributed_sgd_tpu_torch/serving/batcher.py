"""Dynamic micro-batching with a bounded admission queue.

The port's copy of the JAX package's serving/batcher.py.

Clipper-style adaptive batching (PAPERS.md: Crankshaw et al., NSDI'17):
single-row requests arriving concurrently are coalesced into one device
batch.  A flush happens when either `max_batch` rows are waiting or
`max_delay_ms` has elapsed since the OLDEST queued row — so an isolated
request pays at most the deadline, while a burst fills whole batches and
amortizes the forward pass.

Admission control is part of the latency contract: the queue holds at most
`queue_depth` rows, and `submit()` raises `QueueFull` instead of queueing
unboundedly — the gRPC layer maps that to RESOURCE_EXHAUSTED so callers
shed load at the edge.  This mirrors the bounded-inbox /
drop-under-overload policy the async training plane already uses
(parallel/hogwild.py, rpc/service.py GossipSender) — except serving drops
NEW work (the caller retries), training drops OLD deltas (the stream
supersedes them).

Instruments: `serve.batch.size`, `serve.queue.depth`
histograms, `serve.rejected` counter.  `serve.predict.duration` is recorded
per-request by the gRPC servicer (server.py), where queueing time is
visible.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from collections import deque
from typing import Callable, List, Optional, Sequence

import numpy as np

from distributed_sgd_tpu_torch.telemetry import resources
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import measure
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.serving")


class QueueFull(Exception):
    """Admission queue at capacity; caller should shed or retry later."""


class PendingRequest:
    """One enqueued row and its eventual result (a minimal future)."""

    __slots__ = ("indices", "values", "enqueued_at", "_event", "_result",
                 "_error")

    def __init__(self, indices: np.ndarray, values: np.ndarray):
        self.indices = indices
        self.values = values
        self.enqueued_at = time.monotonic()
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def set_result(self, result) -> None:
        self._result = result
        self._event.set()

    def set_error(self, error: BaseException) -> None:
        self._error = error
        self._event.set()

    def wait(self, timeout: Optional[float] = None):
        """Block until the batch containing this row ran; returns the result
        or re-raises the batch's error.  TimeoutError if the batcher did not
        answer within `timeout` seconds."""
        if not self._event.wait(timeout):
            raise TimeoutError("prediction not ready within timeout")
        if self._error is not None:
            raise self._error
        return self._result


class MicroBatcher:
    """Coalesce single-row requests into batches for `run_batch`.

    run_batch(rows) -> sequence of per-row results, one per input row, in
    order.  It runs on the single batcher thread, so implementations need
    no internal locking; an exception fails every row of that batch (each
    waiter re-raises it) and the batcher keeps serving.
    """

    def __init__(
        self,
        run_batch: Callable[[List[PendingRequest]], Sequence],
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        queue_depth: int = 256,
        metrics=None,
    ):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if queue_depth < 1:
            raise ValueError("queue_depth must be >= 1")
        self._run_batch = run_batch
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_ms) / 1000.0
        self.queue_depth = int(queue_depth)
        self._metrics = metrics
        self._queue: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._stopping = False
        self._pressure_token: Optional[int] = None
        self._thread = threading.Thread(
            target=self._loop, daemon=True, name="serve-batcher")

    # -- producer side -------------------------------------------------------

    def submit(self, indices: np.ndarray, values: np.ndarray) -> PendingRequest:
        """Enqueue one row; returns its PendingRequest, or raises QueueFull."""
        pending = PendingRequest(
            np.asarray(indices, dtype=np.int32).ravel(),
            np.asarray(values, dtype=np.float32).ravel(),
        )
        with self._cond:
            if self._stopping:
                raise RuntimeError("batcher is stopped")
            if len(self._queue) >= self.queue_depth:
                if self._metrics is not None:
                    self._metrics.counter("serve.rejected").increment()
                raise QueueFull(
                    f"admission queue full ({self.queue_depth} rows waiting)")
            self._queue.append(pending)
            depth = len(self._queue)
            self._cond.notify()
        if self._metrics is not None:
            self._metrics.histogram("serve.queue.depth").record(depth)
        return pending

    @property
    def depth(self) -> int:
        with self._lock:
            return len(self._queue)

    # -- consumer side -------------------------------------------------------

    def _collect(self) -> List[PendingRequest]:
        """Block until rows exist, then wait out the coalescing window."""
        with self._cond:
            while not self._queue and not self._stopping:
                self._cond.wait()
            if not self._queue:  # stopping with an empty queue
                return []
            # deadline counts from the oldest queued row's ENQUEUE time (not
            # from when this thread got around to collecting): a row that
            # queued while the previous flush was still running has already
            # spent its coalescing window and flushes without further delay
            deadline = self._queue[0].enqueued_at + self.max_delay_s
            while len(self._queue) < self.max_batch and not self._stopping:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            n = min(len(self._queue), self.max_batch)
            return [self._queue.popleft() for _ in range(n)]

    def _loop(self) -> None:
        # the batcher thread is serving's only executor: an uncaught
        # exception here (collect-path bug, not a batch failure) would
        # wedge every future Predict — leave post-mortem evidence first
        try:
            self._loop_impl()
        except Exception as e:  # noqa: BLE001 - record, dump, then surface
            flight.record("serve.batcher.crash", error=repr(e))
            flight.dump("exception")
            log.exception("serving batcher loop crashed")
            raise

    def _loop_impl(self) -> None:
        while True:
            batch = self._collect()
            if not batch:
                with self._lock:
                    if self._stopping and not self._queue:
                        return
                continue
            if self._metrics is not None:
                self._metrics.histogram("serve.batch.size").record(len(batch))
            try:
                # one local trace per flushed batch (head-sampled): the
                # device-execute half of a Predict's wall clock
                with measure.span("serve.batch.execute",
                                  metrics=self._metrics, rows=len(batch)):
                    results = self._run_batch(batch)
                for pending, result in zip(batch, results):
                    pending.set_result(result)
            except Exception as e:  # noqa: BLE001 - one bad batch must not kill serving
                log.warning("predict batch of %d failed: %s", len(batch), e)
                if self._metrics is not None:
                    self._metrics.counter("serve.batch.errors").increment()
                for pending in batch:
                    pending.set_error(e)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "MicroBatcher":
        self._thread.start()
        # long-horizon resource plane (telemetry/resources.py):
        # a RUNNING batcher publishes its admission-queue depth as a
        # pressure source — rows stuck queued are the serving-plane slow
        # fill.  Registration is a dict insert; with the probe off nobody
        # ever calls the closure.  Weakref, so a leaked batcher reference
        # can never pin the queue alive through the registry.  `depth` is a
        # property: the JAX batcher's `b.depth()` calls the int it returns,
        # raises, and so drops its source on the probe's first tick.
        ref = weakref.ref(self)
        self._pressure_token = resources.register_pressure(
            metrics_mod.PROC_PRESSURE_ADMISSION_QUEUE,
            lambda: (b.depth if (b := ref()) is not None else None))
        return self

    def stop(self, timeout: float = 5.0) -> None:
        """Drain the queue (already-admitted rows still get answers), then
        stop the batcher thread.  Late `submit()`s raise RuntimeError."""
        if self._pressure_token is not None:
            resources.unregister_pressure(
                metrics_mod.PROC_PRESSURE_ADMISSION_QUEUE,
                self._pressure_token)
            self._pressure_token = None
        with self._cond:
            self._stopping = True
            self._cond.notify_all()
        self._thread.join(timeout=timeout)
