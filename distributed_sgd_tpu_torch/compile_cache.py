"""Shared kernel-build directory + warm-up: the elastic spin-up fast path.

The port of the JAX package's compile_cache.py.  A joining worker, a
restarted master or a fresh serve replica should not pay its kernels'
compiles under its first request.  In the JAX package those compiles are
XLA's; in the port they are the ``nvcc`` builds of ``csrc/*.cu``
(ops/_build.py), a few seconds each on the GPU host.

``DSGD_COMPILE_CACHE=<dir>`` turns them into a hit:

- **shared build directory** -- ``configure(dir)`` makes ops/_build.py
  build and load every kernel library under `dir` instead of the
  package's ``_build/``.  A library is named by a hash of its source, of
  the headers it includes and of the flags, and written atomically, so
  processes (and checkouts of the same sources) share the directory
  safely.  A library found there counts ``compile.cache.hits``, an
  ``nvcc`` run ``compile.cache.misses`` (utils/metrics.py), once a
  kernel a process;
- **warm-up** -- ``warmup_async(name, thunks)`` runs a role's flagship
  thunks on ONE background daemon thread while the node registers or
  loads (worker ``WorkerNode.warmup_thunks``: the Gradient body and the
  K-step window; the mesh engine's ``BoundSync.warmup_thunks``; the
  serving buckets' ``PredictEngine.warmup_thunks``).  Each runs the real
  kernel once on inert inputs (zero weights, the zero sentinel row), so
  its library is built or loaded and its first launch is paid before the
  first real request.

Knobs-off contract: with ``DSGD_COMPILE_CACHE`` unset nothing here runs:
``configure`` is never called, the libraries stay in ``_build/``, no
warm-up thread starts and no instrument registers.

A thunk that raises is counted under ``compile.warmup.errors`` and
logged; the real dispatch then builds and launches the kernel itself, and
raises as it would have without the warm-up.  A dispatch racing its
warm-up is safe: ops/_build.py loads each library once under a lock, and
both launch the same kernel on inputs of their own.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, Optional, Sequence, Tuple

log = logging.getLogger("dsgd.compile_cache")

# one warmup thunk: (label, zero-arg callable that builds and launches)
WarmupThunk = Tuple[str, Callable[[], object]]

_configured_dir: Optional[str] = None
_metrics = None
_counted: set = set()
_lock = threading.Lock()


def configured_dir() -> Optional[str]:
    """The active cache directory, or None when the knob is off."""
    return _configured_dir


def enabled() -> bool:
    return _configured_dir is not None


def configure(cache_dir: str, metrics=None) -> None:
    """Build and load the kernel libraries under `cache_dir` from now on,
    counting hits and misses into `metrics` (the process registry when
    None).  Runs before the first kernel of the process (main.py calls it
    right after the config loads); idempotent."""
    global _configured_dir, _metrics
    from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

    _configured_dir = str(cache_dir)
    _metrics = metrics or metrics_mod.global_metrics()
    log.info("persistent compile cache on: %s", cache_dir)


def record_build(name: str, hit: bool) -> None:
    """ops/_build.py's report: kernel `name`'s library was found in the
    directory (`hit`) or built by nvcc.  Counted once a kernel a process,
    and only with the cache configured."""
    if _configured_dir is None:
        return
    with _lock:
        if name in _counted:
            return
        _counted.add(name)
    from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

    _metrics.counter(metrics_mod.COMPILE_CACHE_HITS if hit
                     else metrics_mod.COMPILE_CACHE_MISSES).increment()


def run_warmup(name: str, thunks: Sequence[WarmupThunk],
               metrics=None) -> int:
    """Run `thunks` synchronously; returns how many ran cleanly.

    One failed thunk never kills the rest (or the caller): warm-up is an
    optimization, and the dispatch path builds lazily exactly as it would
    have without it -- the failure is logged and counted."""
    from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

    if metrics is None:
        metrics = metrics_mod.global_metrics()
    t0 = time.perf_counter()
    done = 0
    for label, thunk in thunks:
        t1 = time.perf_counter()
        try:
            thunk()
        except Exception as e:  # noqa: BLE001 - see docstring
            metrics.counter(metrics_mod.COMPILE_WARMUP_ERRORS).increment()
            log.warning("warmup %s/%s failed: %s", name, label, e)
            continue
        done += 1
        metrics.counter(metrics_mod.COMPILE_WARMUP_KERNELS).increment()
        log.info("warmed %s/%s in %.3fs", name, label,
                 time.perf_counter() - t1)
    metrics.gauge(metrics_mod.COMPILE_WARMUP_SECONDS).set(
        time.perf_counter() - t0)
    return done


def warmup_async(name: str, thunks: Sequence[WarmupThunk],
                 metrics=None) -> Optional[threading.Thread]:
    """Start the warm-up pass for one role on a background daemon thread
    (None when there is nothing to warm).  The caller keeps spinning up
    -- registration, data load, serving bind -- meanwhile; join() the
    returned thread to run the warm-up synchronously."""
    thunks = list(thunks)
    if not thunks:
        return None
    t = threading.Thread(
        target=run_warmup, args=(name, thunks, metrics),
        daemon=True, name=f"warmup-{name}")
    t.start()
    return t


def cache_file_count() -> int:
    """Number of entries in the configured cache dir (0 when off/empty);
    a rerun on a warm directory leaves it where it was."""
    if _configured_dir is None or not os.path.isdir(_configured_dir):
        return 0
    return len(os.listdir(_configured_dir))
