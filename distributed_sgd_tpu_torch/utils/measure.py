"""Wall-clock measurement spans.

The port's own copy of the JAX package's utils/measure.py (after the
reference's ``Measure`` helpers, utils/Measure.scala:11-35): `duration`
returns (result, seconds), `duration_log` logs a named span, and `span`
is a context manager that records the elapsed seconds in the histogram
``span.<name>`` and, when tracing is on (trace/), opens a trace span: a
child of the thread's current trace context, or a new sampled root.  For
work on the card the caller synchronises inside the span (the trainer
does at the end of each epoch, the RPC worker when it copies its reply
to the host).

Histogram-name cardinality is bounded as in the JAX package: span names
outside `SPAN_NAME_ALLOWLIST` warn once each, and once
`MAX_DISTINCT_SPAN_NAMES` distinct names have been recorded, further
unknown names aggregate under ``span.other``.

`ProfileWindow` is the RPC worker's windowed profiler capture
(DSGD_PROFILE_DIR on the worker role): ``torch.profiler`` over its first
dispatches, written as a Chrome trace.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Callable, Tuple, TypeVar

from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.utils.metrics import global_metrics

T = TypeVar("T")

log = logging.getLogger("dsgd.measure")

# the JAX package's known span names, spelled as its dashboards spell them
SPAN_NAME_ALLOWLIST = frozenset({
    "slave.grad.compute",
    "slave.grad.encode",
    "slave.agg.reduce",
    "slave.async.gossip",
    "serve.predict.decode",
    "serve.predict.queue",
    "serve.batch.execute",
    "route.predict",
    "ckpt.save",
    "ckpt.restore",
    "trainer.epoch",
})
MAX_DISTINCT_SPAN_NAMES = 64
SPAN_OVERFLOW_NAME = "other"

_seen_names: set = set()
_warned_names: set = set()
_names_lock = threading.Lock()


def _bounded_name(name: str) -> str:
    """Cardinality guard for the ``span.<name>`` histogram family."""
    if name in _seen_names:  # a set read needs no lock; a racing first add takes it below
        return name
    with _names_lock:
        if name in _seen_names:
            return name
        if name not in SPAN_NAME_ALLOWLIST and name not in _warned_names:
            if len(_warned_names) < 2 * MAX_DISTINCT_SPAN_NAMES:
                _warned_names.add(name)
                log.warning(
                    "span name %r is not in SPAN_NAME_ALLOWLIST "
                    "(utils/measure.py); dashboards will not know it, and "
                    "unknown names beyond %d aggregate under 'span.%s'",
                    name, MAX_DISTINCT_SPAN_NAMES, SPAN_OVERFLOW_NAME)
        if (name not in SPAN_NAME_ALLOWLIST
                and len(_seen_names) >= MAX_DISTINCT_SPAN_NAMES):
            return SPAN_OVERFLOW_NAME
        _seen_names.add(name)
        return name


class ProfileWindow:
    """Windowed ``torch.profiler`` capture of the RPC worker's first
    `steps` dispatches (DSGD_PROFILE_DIR; the JAX package's
    ``ProfileWindow`` on ``jax.profiler``): `tick()` is called at the
    START of each dispatch; the capture opens on the first tick and closes
    on the first tick PAST the window, so all `steps` dispatch bodies land
    inside it.  `close()` finishes a still-open capture at shutdown.  The
    trace goes to ``<dir>/<name>.trace.json``.  Thread-safe; never raises —
    profiling must not break the work it observes."""

    def __init__(self, profile_dir, steps: int, logger=None, name: str = "worker",
                 cuda: bool = False):
        self.dir = profile_dir
        self.left = max(1, int(steps)) if profile_dir else 0
        self.started = False
        self.stopped = False
        self.path = os.path.join(profile_dir, f"{name}.trace.json") if profile_dir else None
        self._cuda = bool(cuda)
        self._prof = None
        self._lock = threading.Lock()
        self._log = logger or log

    def tick(self) -> None:
        if self.stopped or (self.left <= 0 and not self.started):
            return
        with self._lock:
            if self.stopped:
                return
            try:
                if not self.started:
                    import torch

                    acts = [torch.profiler.ProfilerActivity.CPU]
                    if self._cuda:
                        acts.append(torch.profiler.ProfilerActivity.CUDA)
                    self._prof = torch.profiler.profile(activities=acts)
                    self._prof.start()
                    self.started = True
                    self._log.info("profiling the first %d dispatches -> %s",
                                   self.left, self.path)
                elif self.left <= 0:
                    # first dispatch past the window: the previous `steps`
                    # bodies are complete — close the capture
                    self._finish()
                    return
                self.left -= 1
            except Exception as e:  # noqa: BLE001 - profiling is best-effort
                self.left = 0
                self.stopped = True
                self._log.warning("torch.profiler capture failed: %s", e)

    def _finish(self) -> None:
        self.stopped = True
        self._prof.stop()
        os.makedirs(self.dir, exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        self._log.info("profiler trace written to %s", self.path)

    def close(self) -> None:
        with self._lock:
            if self.started and not self.stopped:
                try:
                    self._finish()
                except Exception as e:  # noqa: BLE001
                    self._log.warning("torch.profiler stop failed: %s", e)


def duration(fn: Callable[[], T]) -> Tuple[T, float]:
    """Run `fn`, return (result, elapsed seconds). Measure.scala:11-16."""
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def duration_log(name: str, fn: Callable[[], T], logger=None) -> T:
    """Run `fn` and log '<name> (Xs)'. Measure.scala:18-24."""
    out, secs = duration(fn)
    (logger or log).info("%s (%.3fs)", name, secs)
    return out


@contextlib.contextmanager
def span(name: str, logger=None, metrics=None, root: bool = True, **trace_args):
    """Record the seconds the block takes in the histogram ``span.<name>``
    of `metrics` (the process's registry when None), and log them at
    debug level; recorded whether the block returns or raises.  When
    tracing is on, the block is also a trace span (child of the thread's
    current context, or a new sampled root) with `trace_args` as its
    attributes; ``root=False`` keeps a helper span a no-op outside a
    trace instead of rooting an orphan one.  Yields the trace span
    (``trace.NOOP_SPAN`` when tracing is off)."""
    t0 = time.perf_counter()
    tspan = trace_mod.span(name, root=root, **trace_args)  # NOOP_SPAN when off
    try:
        with tspan:
            yield tspan
    finally:
        secs = time.perf_counter() - t0
        (logger or log).debug("%s (%.3fs)", name, secs)
        (metrics or global_metrics()).histogram(f"span.{_bounded_name(name)}").record(secs)
