"""Training-health monitor (DSGD_HEALTH_ACTION).

The port of the JAX package's telemetry/health.py.  The aggregate metrics
say how fast a run goes; this module says whether it is DYING.  A
:class:`HealthMonitor` rides one ``fit_sync`` (core/master.py) and
watches the two kinds of signal that come before a flat loss curve:

- **per round** (``observe_round``): the fan-in gradient's norm and the
  round's staleness, set as gauges that the cluster telemetry re-exports.
  A non-finite norm is the NaN/Inf sentinel: it trips at once, before the
  poisoned update can be applied;
- **the loss trend** (``observe_loss``, once an epoch): an EWMA of the raw
  loss.  The watchdog trips when the EWMA exceeds ``divergence_ratio``
  times its best for ``patience`` checks in a row (after ``warmup``
  observations: the first epochs move fast by right), or at once on a
  non-finite loss.

A trip leaves evidence -- a flight-recorder event and dump
(``flight-*-health.json``) and a trace event when a trace is on -- and
latches: one dump a fit.  What follows is ``action``:

- ``warn``: log loudly and keep training;
- ``snapshot``: also write a resumable fit-state snapshot, keep training;
- ``halt``: snapshot, then stop the fit.

The monitor writes no snapshot itself (it cannot see the fit loop's cursor
or generator): ``fit_sync`` reads ``action``/``tripped`` and writes it at
the exact loop state the trip interrupted.  It launches no kernel: it
reads what the fit already computed.
"""

from __future__ import annotations

import logging
import math
from typing import Optional

from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.health")

ACTIONS = ("warn", "snapshot", "halt")


class HealthMonitor:
    def __init__(
        self,
        metrics: Optional[metrics_mod.Metrics] = None,
        action: str = "warn",
        alpha: float = 0.3,
        divergence_ratio: float = 2.0,
        warmup: int = 3,
        patience: int = 2,
    ):
        if action not in ACTIONS:
            raise ValueError(f"health action {action!r} must be one of {ACTIONS}")
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if divergence_ratio <= 1.0:
            raise ValueError("divergence_ratio must be > 1")
        self.metrics = metrics or metrics_mod.global_metrics()
        self.action = action
        self.alpha = float(alpha)
        self.divergence_ratio = float(divergence_ratio)
        self.warmup = max(0, int(warmup))
        self.patience = max(1, int(patience))
        self._ewma: Optional[float] = None
        self._best = math.inf
        self._checks = 0
        self._over = 0
        self.tripped = False
        self.trip_reason: Optional[str] = None

    def observe_round(self, grad_norm: float, staleness_s: Optional[float] = None) -> bool:
        """Set one fan-in round's gauges; True for EVERY non-finite round
        (the caller must not apply it).  The trip (dump, counter, action)
        latches once a fit, the verdict does not: a run that keeps making
        NaN rounds under 'warn' keeps dropping them."""
        self.metrics.gauge(metrics_mod.HEALTH_GRAD_NORM).set(grad_norm)
        if staleness_s is not None:
            self.metrics.gauge(metrics_mod.HEALTH_STALENESS).set(staleness_s)
        if not math.isfinite(grad_norm):
            self._trip("non_finite_grad", grad_norm=str(grad_norm))
            return True
        return False

    def observe_loss(self, loss: float) -> bool:
        """Record one loss evaluation; True when the watchdog trips
        (divergence or a non-finite loss)."""
        if not math.isfinite(loss):
            return self._trip("non_finite_loss", loss=str(loss))
        ewma = loss if self._ewma is None else self.alpha * loss + (1 - self.alpha) * self._ewma
        self._ewma = ewma
        self._checks += 1
        self.metrics.gauge(metrics_mod.HEALTH_LOSS_EWMA).set(ewma)
        if self._checks <= self.warmup:
            self._best = min(self._best, ewma)
            return False
        if ewma > self.divergence_ratio * self._best:
            self._over += 1
            if self._over >= self.patience:
                return self._trip("loss_divergence", ewma=round(ewma, 6),
                                  best=round(self._best, 6), ratio=self.divergence_ratio)
        else:
            self._over = 0
            self._best = min(self._best, ewma)
        return False

    def trip_external(self, reason: str, **info) -> bool:
        """Trip on an outside verdict (the leak sentinel, telemetry/
        slope.py), through the same latched evidence and action as a loss
        divergence, so fit_sync's snapshot and halt cover leaks too."""
        return self._trip(reason, **info)

    def _trip(self, reason: str, **info) -> bool:
        if self.tripped:
            return False  # latched: one dump and one action a fit
        self.tripped = True
        self.trip_reason = reason
        self.metrics.counter(metrics_mod.HEALTH_TRIPPED).increment()
        log.error("training-health watchdog tripped: %s %s (action=%s)",
                  reason, info, self.action)
        # evidence first, policy second: the dump is what a post-mortem
        # reads, even when the action is only 'warn'
        trace_mod.event(trace_mod.EVENT_HEALTH_TRIPPED, reason=reason, **info)
        flight.record("health.tripped", reason=reason, action=self.action, **info)
        flight.dump("health")
        return True
