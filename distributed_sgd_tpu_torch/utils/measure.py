"""Wall-clock measurement spans.

The port's own copy of the JAX package's utils/measure.py (after the
reference's ``Measure`` helpers, utils/Measure.scala:11-35): `duration`
returns (result, seconds), `duration_log` logs a named span, and `span`
is a context manager that records the elapsed seconds in the histogram
``span.<name>``.  For work on the card the caller synchronises inside the
span (the trainer does at the end of each epoch).

Histogram-name cardinality is bounded as in the JAX package: span names
outside `SPAN_NAME_ALLOWLIST` warn once each, and once
`MAX_DISTINCT_SPAN_NAMES` distinct names have been recorded, further
unknown names aggregate under ``span.other``.

Not ported yet: the JAX span's other half, a distributed-trace span
opened beside the histogram when tracing is on, waits for the port of
``trace/`` (ROADMAP.md Queue A 13); and ``ProfileWindow``, the windowed
profiler capture of the RPC worker and the serving engine, waits for
those slices (Queue A 8 and 12).
"""

from __future__ import annotations

import contextlib
import logging
import threading
import time
from typing import Callable, Tuple, TypeVar

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
def span(name: str, logger=None, metrics=None):
    """Record the seconds the block takes in the histogram ``span.<name>``
    of `metrics` (the process's registry when None), and log them at
    debug level; recorded whether the block returns or raises."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        secs = time.perf_counter() - t0
        (logger or log).debug("%s (%.3fs)", name, secs)
        (metrics or global_metrics()).histogram(f"span.{_bounded_name(name)}").record(secs)
