"""A thread-safe registry of named counters and histograms.

The instrument names are the JAX package's (distributed_sgd_tpu/utils/
metrics.py), after the reference's Kamon metrics: the async engines count
``slave.async.batch`` (local steps), ``slave.async.grad.update`` (peer
deltas merged), ``slave.async.grad.dropped`` (inbox overflows) and
``master.async.loss``, and record ``master.async.loss.value`` and
``slave.async.round.seconds``.  The Prometheus and InfluxDB exporters are
not ported yet (ROADMAP.md Queue A 6).
"""

from __future__ import annotations

import threading
from typing import Dict


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


class Histogram:
    """Streaming count and sum of the recorded values."""

    __slots__ = ("name", "count", "sum", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.sum = 0.0
        self._lock = threading.Lock()

    def record(self, v: float) -> None:
        with self._lock:
            self.count += 1
            self.sum += float(v)


class Metrics:
    """Named instruments, each made at its first use."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self._counters.setdefault(name, Counter(name))

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self._hists.setdefault(name, Histogram(name))


_GLOBAL = Metrics()


def global_metrics() -> Metrics:
    """The process's registry, which the engines use unless given one."""
    return _GLOBAL
