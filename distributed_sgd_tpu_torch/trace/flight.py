"""Flight recorder: a bounded ring of recent structured events per
process, dumped to JSON post-mortem (docs/OBSERVABILITY.md).

The port's own copy of the JAX package's trace/flight.py, with the same
dump format: its ``resources`` entry is the resource probe's sample
(telemetry/resources.py).

Tracing (trace/__init__.py) answers "show me round N end to end" — but it
is sampled and default-off, and the runs that die are rarely the runs
someone thought to trace.  The flight recorder is the always-on black
box: every notable control-plane event (quorum degradation, hedges,
breaker trips, chaos injections, evictions, EF rollbacks) is appended to
a bounded ``deque`` — a single GIL-atomic append, no locks on the record
path — and the most recent ``capacity`` events are written to a JSON file
when something goes wrong:

- ``SIGUSR2`` (install_signal_handler; `kill -USR2 <pid>` on a live run),
- worker eviction (core/master.py unregister_worker(evicted=True)),
- below-quorum degradation of a sync window (core/master.py fit_sync),
- an uncaught exception in an engine loop (worker async loop, serving
  batcher, main.py role runner).

Events carry BOTH a monotonic timestamp (ordering across events survives
wall-clock jumps) and a wall timestamp (correlation with logs).  Dumps
overwrite per-(service, pid, reason) paths, so a repeating fault leaves a
bounded number of files.  ``DSGD_FLIGHT_RECORDER`` sets the capacity
(default 512; 0 disables recording entirely).
"""

from __future__ import annotations

import json
import logging
import os
import signal
import threading
import time
from collections import deque
from typing import List, Optional

log = logging.getLogger("dsgd.flight")

DEFAULT_CAPACITY = 512
# where un-configured recorders dump: DSGD_TRACE_DIR when the environment
# names one (so subprocess children — test workers, bench fits — inherit
# the redirect without running any configure() of their own), else next to
# the process, the classic black-box location.  Also overridable
# process-wide (the JAX package's tests/conftest.py does both) so harnesses keep evidence
# out of their CWD.
DEFAULT_DIR = os.environ.get("DSGD_TRACE_DIR") or "."


class FlightRecorder:
    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 service: Optional[str] = None, dir: Optional[str] = None):
        self.capacity = max(0, int(capacity))
        self.service = service or f"proc-{os.getpid()}"
        self.dir = dir or DEFAULT_DIR
        # deque.append with maxlen is a single GIL-atomic operation: the
        # record path takes no lock (the lock below only serializes dumps)
        self._buf: deque = deque(maxlen=self.capacity or 1)
        self._dump_lock = threading.Lock()
        self._last_dump: dict = {}  # reason -> monotonic time, for throttling

    def record(self, kind: str, **fields) -> None:
        if self.capacity <= 0:
            return
        fields["t_mono"] = time.monotonic()
        fields["t_wall"] = time.time()
        fields["kind"] = kind
        self._buf.append(fields)

    def snapshot(self) -> List[dict]:
        return list(self._buf)

    def ring_len(self) -> int:
        """Events currently held (lock-free; len() of a deque is
        GIL-atomic).  The resource probe's flight-ring pressure gauge."""
        return len(self._buf)

    def dump(self, reason: str,
             min_interval_s: float = 0.0) -> Optional[str]:
        """Write the ring's current contents; returns the path (None when
        disabled or throttled).  `min_interval_s` rate-limits repeated
        dumps of the SAME reason — a caller in a hot loop (e.g. every
        below-quorum window of a long partition) keeps fresh evidence at
        a bounded I/O cost.  Never raises — a post-mortem writer that
        throws would mask the original failure."""
        if self.capacity <= 0:
            return None
        if min_interval_s > 0.0:
            with self._dump_lock:
                last = self._last_dump.get(reason, -float("inf"))
                if time.monotonic() - last < min_interval_s:
                    return None
                self._last_dump[reason] = time.monotonic()
        path = os.path.join(
            self.dir, f"flight-{self.service}-{os.getpid()}-{reason}.json")
        payload = {
            "service": self.service,
            "pid": os.getpid(),
            "reason": reason,
            "dumped_at_mono": time.monotonic(),
            "dumped_at_wall": time.time(),
            "capacity": self.capacity,
            "resources": self._resources(),
            "events": self.snapshot(),
        }
        try:
            with self._dump_lock:
                os.makedirs(self.dir, exist_ok=True)
                tmp = f"{path}.tmp"
                with open(tmp, "w") as f:
                    json.dump(payload, f, default=str)
                os.replace(tmp, path)
        except Exception as e:  # noqa: BLE001 - never mask the original failure
            log.warning("flight-recorder dump (%s) failed: %s", reason, e)
            return None
        log.warning("flight recorder dumped %d event(s) -> %s",
                    len(payload["events"]), path)
        return path

    @staticmethod
    def _resources() -> Optional[dict]:
        """Resource snapshot for the dump payload: every quorum/eviction/
        crash dump carries RSS/fd/thread context.  Lazy import (dump is
        the cold path; record must stay import-free) and guarded — a
        sampling failure must not break a post-mortem."""
        try:
            from distributed_sgd_tpu_torch.telemetry import resources

            return resources.sample_resources()
        except Exception:  # noqa: BLE001 - never mask the original failure
            return None


_RECORDER: Optional[FlightRecorder] = None
_LOCK = threading.Lock()


def get() -> FlightRecorder:
    """The process recorder (default-on at DEFAULT_CAPACITY: a dead run
    leaves evidence even when nobody configured anything)."""
    global _RECORDER
    r = _RECORDER
    if r is None:
        with _LOCK:
            r = _RECORDER
            if r is None:
                r = _RECORDER = FlightRecorder()
    return r


def configure(capacity: int = DEFAULT_CAPACITY, service: Optional[str] = None,
              dir: Optional[str] = None) -> FlightRecorder:
    """Replace the process recorder (DSGD_FLIGHT_RECORDER wiring; 0
    disables recording)."""
    global _RECORDER
    with _LOCK:
        _RECORDER = FlightRecorder(capacity=capacity, service=service, dir=dir)
        return _RECORDER


def record(kind: str, **fields) -> None:
    get().record(kind, **fields)


def dump(reason: str, min_interval_s: float = 0.0) -> Optional[str]:
    return get().dump(reason, min_interval_s=min_interval_s)


def install_signal_handler(signum: int = signal.SIGUSR2) -> bool:
    """SIGUSR2 -> dump('sigusr2').  Returns False (and stays silent) when
    handlers cannot be installed here (non-main thread, platforms without
    the signal).

    The handler defers the dump to a short-lived thread: CPython runs
    signal handlers on the main thread between bytecodes, so dumping
    inline would deadlock on the non-reentrant ``_dump_lock`` (or the
    logging lock) whenever the signal lands while the main thread itself
    is inside ``dump()`` — e.g. the below-quorum dump of a long chaos
    partition."""

    def _handler(_signum, _frame):
        threading.Thread(target=dump, args=("sigusr2",),
                         name="flight-sigusr2-dump", daemon=True).start()

    try:
        signal.signal(signum, _handler)
        return True
    except (ValueError, AttributeError, OSError):
        return False
