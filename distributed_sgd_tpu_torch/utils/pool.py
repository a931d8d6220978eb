"""Fixed worker pool + awaitable futures — the reference Pool equivalent.

The port's copy of the JAX package's utils/pool.py.  The reference ships a single shared 8-thread executor registered with
kamon-executors (utils/Pool.scala:11-16) and an `AwaitableFuture.await`
blocking helper (Pool.scala:18-20).  This module provides both, with the
executor instrumented through utils/metrics.py (same observability role as
kamon-executors): counters `pool.submitted` / `pool.completed` and a
`pool.active` gauge.

Available to any host-side fan-out.
"""

from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Iterable, List, Optional, TypeVar

from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

T = TypeVar("T")

DEFAULT_WORKERS = 8  # Pool.scala:12 newFixedExecutor default


class FixedPool:
    """Fixed-size instrumented thread pool (Pool.scala:11-16 parity)."""

    def __init__(
        self,
        n_workers: int = DEFAULT_WORKERS,
        name: str = "pool",
        metrics: Optional[metrics_mod.Metrics] = None,
    ):
        self.name = name
        self.metrics = metrics or metrics_mod.global_metrics()
        self._ex = ThreadPoolExecutor(max_workers=n_workers, thread_name_prefix=name)
        self._active = 0
        self._lock = threading.Lock()

    def submit(self, fn: Callable[..., T], *args, **kwargs) -> "Future[T]":
        self.metrics.counter(f"{self.name}.submitted").increment()
        with self._lock:
            self._active += 1

        def wrapped():
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self._active -= 1
                self.metrics.counter(f"{self.name}.completed").increment()

        return self._ex.submit(wrapped)

    def map(self, fn: Callable[..., T], items: Iterable) -> List[T]:
        """Submit one task per item and await all (Future.sequence + await)."""
        return [await_result(f) for f in [self.submit(fn, it) for it in items]]

    @property
    def active(self) -> int:
        with self._lock:
            return self._active

    def shutdown(self, wait: bool = True) -> None:
        self._ex.shutdown(wait=wait)

    def __enter__(self) -> "FixedPool":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()


def await_result(future: "Future[T]", timeout: Optional[float] = None) -> T:
    """Blocking await, the reference's `AwaitableFuture.await`
    (Pool.scala:18-20; there with an infinite timeout)."""
    return future.result(timeout=timeout)


_global_pool: Optional[FixedPool] = None
_global_lock = threading.Lock()


def global_pool() -> FixedPool:
    """Process-wide shared pool, like the reference's single implicit
    executor threaded through every component."""
    global _global_pool
    with _global_lock:
        if _global_pool is None:
            _global_pool = FixedPool()
        return _global_pool
