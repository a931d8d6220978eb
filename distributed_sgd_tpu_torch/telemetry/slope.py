"""Leak-slope sentinel: robust trend detection over the resource series.

The port's copy of the JAX package's telemetry/slope.py: the same
estimator, guards, thresholds and latch.

A leak is a SLOPE, and an hours-horizon slope is invisible to threshold
alerts: RSS that grows 2 MB/minute is fine for an hour and fatal
overnight, while a single GC spike that a naive least-squares fit would
chase is noise.  :class:`LeakSentinel` therefore runs a Theil–Sen
estimator — the median of all pairwise slopes, breakdown point ~29%,
immune to the isolated spikes that /proc sampling produces — over a
bounded per-series window, and only judges a series once two guards
pass:

- **minimum horizon** (``min_horizon_s``): a slope extrapolated from
  seconds of data is an extrapolation, not a measurement;
- **minimum samples** (``min_samples``): the median of a handful of
  pairs is itself noise.

The threshold is RELATIVE by default — slope/hour compared against the
series' own median level, so one rule covers RSS in bytes and fds in
single digits — with optional per-series ABSOLUTE units/s overrides
(``thresholds``), which the soak bench uses to pin its calibrated bars.

A trip LATCHES per series: "rss" tripping once must not re-dump the
flight recorder every tick, but must also never silence a later,
independent "fds" leak.  The trip is the health monitor's pattern:
counter + slope gauge + trace event + flight record + flight dump, then,
when a :class:`~distributed_sgd_tpu_torch.telemetry.health.HealthMonitor`
is attached (``attach_health``; the CLI attaches the rpc sync fit's under
DSGD_HEALTH_ACTION), its ``trip_external``, so the fit's snapshot and halt
cover a leak as they cover a diverging loss.
"""

from __future__ import annotations

import logging
import statistics
import threading
from collections import deque
from typing import Deque, Dict, Optional, Tuple

from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.slope")


def theil_sen(ts, vs) -> float:
    """Median of all pairwise slopes (Theil–Sen).  O(n^2) pairs, but the
    sentinel windows are bounded (default 64 samples -> <= 2016 pairs
    per judged series per tick, microseconds of work).  NaN when fewer
    than two distinct timestamps."""
    slopes = []
    n = len(ts)
    for i in range(n):
        for j in range(i + 1, n):
            dt = ts[j] - ts[i]
            if dt > 0:
                slopes.append((vs[j] - vs[i]) / dt)
    if not slopes:
        return float("nan")
    return statistics.median(slopes)


class LeakSentinel:
    """Per-series windowed Theil–Sen watch with latched trips.

    ``thresholds`` maps series name -> absolute slope bar in units/s;
    series not listed fall back to the relative rule:
    ``slope * 3600 > rel_slope_per_hour * max(|median level|, rel_floor)``.
    """

    def __init__(self, metrics: Optional[metrics_mod.Metrics] = None,
                 window: int = 64, min_samples: int = 12,
                 min_horizon_s: float = 30.0,
                 rel_slope_per_hour: float = 0.10, rel_floor: float = 1.0,
                 thresholds: Optional[Dict[str, float]] = None):
        if window < 2:
            raise ValueError("window must be >= 2")
        if min_samples < 2:
            raise ValueError("min_samples must be >= 2")
        self.metrics = metrics or metrics_mod.global_metrics()
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.min_horizon_s = float(min_horizon_s)
        self.rel_slope_per_hour = float(rel_slope_per_hour)
        self.rel_floor = float(rel_floor)
        self.thresholds = dict(thresholds or {})
        self.tripped_series: set = set()
        self._series: Dict[str, Deque[Tuple[float, float]]] = {}
        self._lock = threading.Lock()
        self._monitor = None

    def attach_health(self, monitor) -> None:
        """Route later trips through a HealthMonitor's DSGD_HEALTH_ACTION
        (telemetry/health.py) besides the local latch."""
        self._monitor = monitor

    # -- accessors ---------------------------------------------------------

    def slope(self, series: str) -> float:
        """Current Theil–Sen slope estimate in units/s (NaN if the window
        is still below the sample/horizon guards)."""
        with self._lock:
            win = self._series.get(series)
            if win is None or len(win) < self.min_samples:
                return float("nan")
            ts = [t for t, _ in win]
            vs = [v for _, v in win]
        if ts[-1] - ts[0] < self.min_horizon_s:
            return float("nan")
        return theil_sen(ts, vs)

    def tripped(self, series: Optional[str] = None) -> bool:
        if series is None:
            return bool(self.tripped_series)
        return series in self.tripped_series

    # -- the watch ---------------------------------------------------------

    def observe(self, series: str, t_s: float, value: float) -> bool:
        """Feed one sample; returns True when THIS observation trips the
        (previously untripped) series."""
        with self._lock:
            win = self._series.get(series)
            if win is None:
                win = self._series[series] = deque(maxlen=self.window)
            win.append((float(t_s), float(value)))
            if series in self.tripped_series:
                return False
            if len(win) < self.min_samples:
                return False
            ts = [t for t, _ in win]
            vs = [v for _, v in win]
        horizon = ts[-1] - ts[0]
        if horizon < self.min_horizon_s:
            return False
        slope = theil_sen(ts, vs)
        if slope != slope or slope <= 0:  # NaN or shrinking: no leak
            return False
        bar = self.thresholds.get(series)
        if bar is not None:
            leaking = slope > bar
        else:
            level = abs(statistics.median(vs))
            leaking = (slope * 3600.0
                       > self.rel_slope_per_hour * max(level, self.rel_floor))
        if not leaking:
            return False
        self._trip(series, slope, horizon, vs[-1])
        return True

    def _trip(self, series: str, slope: float, horizon: float,
              level: float) -> None:
        with self._lock:
            if series in self.tripped_series:  # lost the race: already latched
                return
            self.tripped_series.add(series)
        self.metrics.counter(metrics_mod.HEALTH_LEAK_SUSPECT).increment()
        # the slope gauge family carries the offending estimate onto the
        # /metrics page (health.leak.slope.<series>)
        self.metrics.gauge(
            f"{metrics_mod.HEALTH_LEAK_SLOPE}.{series}").set(slope)
        log.error("leak suspect: series=%s slope=%.6g/s over %.1fs "
                  "(level %.6g)", series, slope, horizon, level)
        from distributed_sgd_tpu_torch import trace as trace_mod

        trace_mod.event(trace_mod.EVENT_LEAK_SUSPECT, series=series,
                        slope_per_s=slope, horizon_s=horizon, level=level)
        from distributed_sgd_tpu_torch.trace import flight

        flight.record("leak.suspect", series=series, slope_per_s=slope,
                      horizon_s=horizon, level=level)
        flight.dump("leak")
        if self._monitor is not None:
            try:
                self._monitor.trip_external(
                    f"leak:{series}", slope_per_s=slope, horizon_s=horizon)
            except Exception:  # noqa: BLE001 - the sentinel must not die on a monitor bug
                log.exception("leak sentinel: health-monitor routing failed")
