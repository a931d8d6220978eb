"""Per-process resource probe: the long-horizon half of the telemetry
plane.

The port's copy of the JAX package's telemetry/resources.py: the same
gauges, pressure registry, sentinel feed and blackbox snapshot, the
compile cache's directory entries (DSGD_COMPILE_CACHE) included.

The aggregate metrics say how fast a run is going and the health monitor
says whether the MATH is dying — but nothing watched whether the PROCESS
is dying: RSS creeping a few MB a minute, file descriptors leaking one
per reconnect, the drain inbox or trace buffer slowly filling.  A fleet
serving millions of users dies from slopes, not spikes, and before this
module no process even sampled its own RSS on a cadence.

:class:`ResourceProbe` is a dependency-free daemon thread
(``DSGD_RESOURCE_PROBE_S`` sets the cadence; unset, nothing here ever
runs) that each tick:

- reads ``/proc/self/{statm,fd,status}`` into the ``proc.rss_bytes`` /
  ``proc.fds`` / ``proc.threads`` gauges (graceful no-op off-Linux: the
  gauges stay never-set NaN and off the wire — the probe must not crash
  a macOS dev box), plus ``proc.gc.gen2`` and a ``threading`` fallback
  for the thread count, which are platform-independent;
- samples the INTERNAL pressure gauges from the live structures whose
  slow fill precedes an hours-horizon death: the tracer's event buffer,
  the flight-recorder ring, and any structure registered through
  :func:`register_pressure` (the master's async drain inbox, the serving
  batcher's admission queue);
- feeds the :class:`~distributed_sgd_tpu_torch.telemetry.slope.LeakSentinel`
  (when attached) the rss/fd/thread series, and appends one snapshot to
  the :class:`~distributed_sgd_tpu_torch.telemetry.blackbox.Blackbox`
  (when attached) so a crashed process leaves its last minutes on disk.

All gauges land on the process registry, which DSGD_RECORD's exporters
ship with everything else.

Pressure sources hold only a weakref-compatible callable: a source that
raises or returns ``None`` is dropped from that tick (and a source whose
owner died unregisters itself by returning ``None``), so a forgotten
registration can never wedge the probe.
"""

from __future__ import annotations

import gc
import logging
import os
import threading
import time
from typing import Callable, Dict, Optional

from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.resources")

try:  # one syscall at import; off-Linux (or restricted) fall back to 4K
    _PAGE = os.sysconf("SC_PAGE_SIZE")
except (ValueError, OSError, AttributeError):  # pragma: no cover
    _PAGE = 4096


# -- pressure-source registry --------------------------------------------------
#
# name -> {token -> fn}: multiple structures may publish under one name
# (a fleet runs several batchers in-process); their depths SUM — "rows
# queued in this process" is the pressure signal, not any one queue.

_PRESSURE: Dict[str, Dict[int, Callable[[], Optional[float]]]] = {}
_PRESSURE_LOCK = threading.Lock()
_NEXT_TOKEN = [0]


def register_pressure(name: str, fn: Callable[[], Optional[float]]) -> int:
    """Register a depth callable under an instrument name; returns the
    token for :func:`unregister_pressure`.  Registration is always cheap
    and thread-free — the callable is only ever invoked by a running
    probe, so knobs-off runs pay nothing."""
    with _PRESSURE_LOCK:
        _NEXT_TOKEN[0] += 1
        token = _NEXT_TOKEN[0]
        _PRESSURE.setdefault(name, {})[token] = fn
        return token


def unregister_pressure(name: str, token: int) -> None:
    with _PRESSURE_LOCK:
        srcs = _PRESSURE.get(name)
        if srcs is not None:
            srcs.pop(token, None)
            if not srcs:
                _PRESSURE.pop(name, None)


def _sample_pressures() -> Dict[str, float]:
    """Sum every live registered source per name; a source that raises or
    returns None (dead owner) is dropped from this tick and removed."""
    with _PRESSURE_LOCK:
        items = [(name, dict(srcs)) for name, srcs in _PRESSURE.items()]
    out: Dict[str, float] = {}
    for name, srcs in items:
        total = None
        for token, fn in srcs.items():
            try:
                v = fn()
            except Exception:  # noqa: BLE001 - a broken source must not kill the probe
                v = None
            if v is None:
                unregister_pressure(name, token)
                continue
            total = (total or 0.0) + float(v)
        if total is not None:
            out[name] = total
    return out


# -- raw sampling --------------------------------------------------------------


def sample_resources() -> Dict[str, float]:
    """One dependency-free sample of the process: /proc-backed values
    (absent from the dict off-Linux), interpreter-level values, and the
    internal-pressure sums.  Shared by the probe tick, the flight-dump
    ``resources`` section (trace/flight.py), and the soak bench — one
    sampler, three consumers, no spelling drift."""
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/statm") as f:
            # field 2 of statm is resident pages
            out[metrics_mod.PROC_RSS] = float(f.read().split()[1]) * _PAGE
    except (OSError, IndexError, ValueError):
        pass
    try:
        out[metrics_mod.PROC_FDS] = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        pass
    threads = None
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("Threads:"):
                    threads = float(line.split()[1])
                    break
    except (OSError, IndexError, ValueError):
        pass
    if threads is None:  # off-Linux: the Python-level count still moves
        threads = float(threading.active_count())
    out[metrics_mod.PROC_THREADS] = threads
    try:
        out[metrics_mod.PROC_GC_GEN2] = float(gc.get_stats()[2]["collections"])
    except (IndexError, KeyError, AttributeError):  # pragma: no cover
        pass

    # internal pressure: structures the probe can reach without hooks...
    from distributed_sgd_tpu_torch import trace as trace_mod

    tracer = trace_mod.active()
    if tracer is not None:
        out[metrics_mod.PROC_PRESSURE_TRACE_BUFFER] = float(tracer.buffered())
    from distributed_sgd_tpu_torch.trace import flight

    out[metrics_mod.PROC_PRESSURE_FLIGHT_RING] = float(flight.get().ring_len())
    from distributed_sgd_tpu_torch import compile_cache

    if compile_cache.enabled():
        try:
            out[metrics_mod.PROC_PRESSURE_COMPILE_CACHE] = float(
                compile_cache.cache_file_count())
        except OSError:  # pragma: no cover - dir vanished mid-listdir
            pass
    # ...and the registered ones (drain inbox, admission queues)
    out.update(_sample_pressures())
    return out


class ResourceProbe:
    """Daemon sampling loop: gauges + sentinel feed + blackbox append.

    ``plant`` is the planted-leak test hook: a callable merged into every
    sample (its keys override), so a test can drive a synthetic growing
    series through the EXACT production path — gauges, sentinel,
    blackbox — without waiting hours for a real leak.
    """

    # sentinel watch list: sample key -> short series name
    WATCHED = {
        metrics_mod.PROC_RSS: "rss",
        metrics_mod.PROC_FDS: "fds",
        metrics_mod.PROC_THREADS: "threads",
    }

    def __init__(self, metrics: Optional[metrics_mod.Metrics] = None,
                 interval_s: float = 10.0, sentinel=None, blackbox=None,
                 plant: Optional[Callable[[], Dict[str, float]]] = None):
        if interval_s <= 0:
            raise ValueError("interval_s must be > 0 (unset = no probe)")
        self.metrics = metrics or metrics_mod.global_metrics()
        self.interval_s = float(interval_s)
        self.sentinel = sentinel
        self.blackbox = blackbox
        self.plant = plant
        self.ticks = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="resource-probe")

    def tick(self) -> Dict[str, float]:
        """One sample -> gauges -> sentinel -> blackbox; public so tests
        (and the soak bench) can drive the probe deterministically."""
        sample = sample_resources()
        if self.plant is not None:
            try:
                sample.update(self.plant())
            except Exception:  # noqa: BLE001 - a test hook must not kill the loop
                pass
        for name, value in sample.items():
            self.metrics.gauge(name).set(value)
        now = time.monotonic()
        if self.sentinel is not None:
            for key, series in self.WATCHED.items():
                if key in sample:
                    self.sentinel.observe(series, now, sample[key])
            # planted series beyond the watch list reach the sentinel too
            for key in sample.keys() - self.WATCHED.keys():
                if key.startswith("plant."):
                    self.sentinel.observe(key, now, sample[key])
        if self.blackbox is not None:
            self.blackbox.append(self._snapshot(sample))
        self.ticks += 1
        return sample

    def _snapshot(self, sample: Dict[str, float]) -> Dict:
        """Blackbox record: resources + every counter (the round cursor —
        master.sync.rounds — rides along) + the set gauges."""
        counters = {c.name: c.value for c in self.metrics.counters()}
        gauges = {g.name: g.value for g in self.metrics.gauges()
                  if g.value == g.value}
        return {
            "resources": sample,
            "counters": counters,
            "gauges": gauges,
            "round": counters.get(metrics_mod.SYNC_ROUNDS, 0),
        }

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.tick()
            except Exception as e:  # noqa: BLE001 - the probe must outlive any one tick
                log.warning("resource probe tick failed: %s", e)

    def start(self) -> "ResourceProbe":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=self.interval_s + 1.0)
        if self.blackbox is not None:
            self.blackbox.close()


# -- module-level wiring (main.py; the zero-cost gate) -------------------------

_PROBE: Optional[ResourceProbe] = None
_PROBE_LOCK = threading.Lock()


def configure(interval_s: float, metrics: Optional[metrics_mod.Metrics] = None,
              sentinel=None, blackbox=None) -> Optional[ResourceProbe]:
    """Install (interval_s > 0) or remove (<= 0) the process probe."""
    global _PROBE
    with _PROBE_LOCK:
        if _PROBE is not None:
            _PROBE.stop()
            _PROBE = None
        if interval_s <= 0:
            return None
        _PROBE = ResourceProbe(metrics=metrics, interval_s=interval_s,
                               sentinel=sentinel, blackbox=blackbox).start()
        return _PROBE


def active() -> Optional[ResourceProbe]:
    return _PROBE
