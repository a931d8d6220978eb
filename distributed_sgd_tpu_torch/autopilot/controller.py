"""The autopilot controller.

The port's copy of the JAX package's autopilot/controller.py (its
docs/CONTINUAL.md): the same states, rules, instruments, trace and
flight events, so the same probe-loss series drives the same
transitions.  It computes on the host only.

A state machine that closes the train/serve loop with zero operator
actions:

    SERVING -> DRIFT_DETECTED -> RETRAINING -> CANARY
                                                 |-> PROMOTED    -> SERVING
                                                 '-> ROLLED_BACK -> SERVING

It watches the router's probe-loss series — each probe-source refresh
re-probes the promoted version against freshly sampled live traffic
(serving/router.py), so that series IS "how well does the model serving
right now fit the traffic arriving right now".  :class:`DriftDetector`
applies the HealthMonitor rule shape (telemetry/health.py) to it: an
EWMA over the series, tripped when it exceeds
``max(ratio * baseline, baseline + abs_floor)`` for ``patience``
consecutive observations after ``warmup``.  Two deliberate differences
from the training watchdog: the baseline is RE-ANCHORABLE (``rebase()``
after every promotion — the new model's loss on the new distribution is
the new normal), and the absolute floor keeps sub-resolution wiggle at
tiny losses — quorum-timing noise, reservoir churn — from ever clearing
the ratio bar (the false-positive gate in tests/test_autopilot.py).

On a trip the controller runs the ``retrain`` callback (a warm-start
``fit_sync`` from the latest FitState over the current stream window —
the spin-up fast path is what makes this cheap), then WAITS: the new
checkpoint flows through the existing ``CheckpointDistributor`` ->
router canary -> promote/rollback machinery, and the controller only
observes the verdict through the router's own counters.  It never
bypasses the canary gate — a retrain that regressed on the live probe
set rolls back exactly like an operator push would, and the controller
cools down instead of hot-looping on a distribution it cannot fit.

One cycle may take SEVERAL retrains: a trip that fires while the sliding
window still straddles the shift warm-starts a model that only
half-recovers, and the post-promotion rebase would happily call that the
new normal.  The settling rule (``recovery_band``, :meth:`_residual`)
holds the pre-trip healthy baseline across the cycle and keeps
retraining — each round on newer, purer traffic — until the EWMA is back
inside the band (bounded by ``max_retrains``).

Every transition gets a metrics counter, a trace instant event, and a
flight record; rollbacks and retrain failures also dump the flight ring
(evidence first, policy second — the HealthMonitor discipline).
"""

from __future__ import annotations

import logging
import math
import threading
import time
from typing import Callable, Optional

from distributed_sgd_tpu_torch import trace as trace_mod
from distributed_sgd_tpu_torch.trace import flight
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.autopilot")

STATES = ("SERVING", "DRIFT_DETECTED", "RETRAINING", "CANARY",
          "PROMOTED", "ROLLED_BACK")


class DriftDetector:
    def __init__(
        self,
        alpha: float = 0.3,
        ratio: float = 1.5,
        patience: int = 2,
        warmup: int = 4,
        abs_floor: float = 0.1,
        metrics: Optional[metrics_mod.Metrics] = None,
    ):
        if not 0.0 < alpha <= 1.0:
            raise ValueError("alpha must be in (0, 1]")
        if ratio <= 1.0:
            raise ValueError("ratio must be > 1")
        if abs_floor < 0.0:
            raise ValueError("abs_floor must be >= 0")
        self.alpha = float(alpha)
        self.ratio = float(ratio)
        self.patience = max(1, int(patience))
        self.warmup = max(0, int(warmup))
        self.abs_floor = float(abs_floor)
        self.metrics = metrics
        self._ewma: Optional[float] = None
        self._baseline = math.inf
        self._checks = 0
        self._over = 0

    def observe(self, loss: float) -> bool:
        """Feed one probe-loss observation; True when drift trips.  A
        non-finite probe loss trips immediately — a model that NaNs on
        live traffic is the most drifted a model can be."""
        if not math.isfinite(loss):
            return True
        ewma = (loss if self._ewma is None
                else self.alpha * loss + (1 - self.alpha) * self._ewma)
        self._ewma = ewma
        self._checks += 1
        if self.metrics is not None:
            self.metrics.gauge(metrics_mod.AUTOPILOT_DRIFT_EWMA).set(ewma)
        if self._checks <= self.warmup:
            self._baseline = min(self._baseline, ewma)
            return False
        bar = max(self.ratio * self._baseline, self._baseline + self.abs_floor)
        if ewma > bar:
            self._over += 1
            return self._over >= self.patience
        self._over = 0
        self._baseline = min(self._baseline, ewma)
        return False

    def rebase(self) -> None:
        """Re-anchor after a promotion (or rollback cooldown): the next
        observations define the new normal."""
        self._ewma = None
        self._baseline = math.inf
        self._checks = 0
        self._over = 0


class AutopilotController:
    """One daemon thread driving the flywheel against an in-process
    :class:`~distributed_sgd_tpu_torch.serving.router.ServingRouter`.

    ``retrain`` is the training half, supplied by the integrator (a
    warm-start ``fit_sync`` over the current stream window that writes a
    checkpoint into the distributor's directory); the controller owns
    WHEN it runs and what happens to its verdict, never HOW it trains.
    """

    def __init__(
        self,
        router,
        retrain: Callable[[], object],
        detector: Optional[DriftDetector] = None,
        poll_s: float = 0.5,
        cooldown_s: float = 2.0,
        canary_timeout_s: float = 120.0,
        max_retrains: int = 0,
        recovery_band: float = 1.35,
        metrics: Optional[metrics_mod.Metrics] = None,
    ):
        if poll_s <= 0:
            raise ValueError("poll_s must be > 0")
        if recovery_band and recovery_band <= 1.0:
            raise ValueError("recovery_band must be > 1 (or 0 to disable)")
        self.router = router
        self.retrain = retrain
        self.metrics = metrics or metrics_mod.global_metrics()
        self.detector = detector or DriftDetector(metrics=self.metrics)
        if self.detector.metrics is None:
            self.detector.metrics = self.metrics
        self.poll_s = float(poll_s)
        self.cooldown_s = max(0.0, float(cooldown_s))
        self.canary_timeout_s = float(canary_timeout_s)
        self.max_retrains = max(0, int(max_retrains))  # 0 = unbounded
        self.recovery_band = float(recovery_band)  # 0 disables settling
        self.state = "SERVING"
        self.retrains = 0
        self._consumed = 0  # probe-loss entries already fed to the detector
        # the pre-trip healthy baseline, held across a retrain cycle until
        # the post-promotion EWMA settles back inside recovery_band of it
        self._settle_baseline: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.metrics.gauge(metrics_mod.AUTOPILOT_STATE).set(
            STATES.index(self.state))

    # -- transitions --------------------------------------------------------

    def _to(self, state: str, **info) -> None:
        prev, self.state = self.state, state
        self.metrics.gauge(metrics_mod.AUTOPILOT_STATE).set(
            STATES.index(state))
        self.metrics.counter(metrics_mod.AUTOPILOT_TRANSITIONS).increment()
        log.info("autopilot: %s -> %s %s", prev, state, info or "")
        trace_mod.event(trace_mod.EVENT_AUTOPILOT_TRANSITION,
                        frm=prev, to=state, **info)
        flight.record("autopilot.transition", frm=prev, to=state, **info)

    # -- the loop -----------------------------------------------------------

    def start(self) -> "AutopilotController":
        self._thread = threading.Thread(
            target=self._loop, name="autopilot-controller", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)

    def __enter__(self) -> "AutopilotController":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    def _drifted(self) -> bool:
        """Feed any new probe-loss observations; True when drift trips."""
        series = self.router.probe_losses()
        tripped = False
        for loss in series[self._consumed:]:
            self._consumed += 1
            if self.detector.observe(loss):
                tripped = True
        return tripped

    def _rebase(self) -> None:
        # losses measured before/at the verdict describe the old model:
        # skip them, or the fresh baseline would anchor on stale pain
        self.detector.rebase()
        self._consumed = len(self.router.probe_losses())

    def _residual(self) -> bool:
        """The rebase after a promotion deliberately makes the retrained
        model's loss the new normal — which would also normalize a retrain
        that only HALF-recovered (trained on a window still contaminated
        with pre-shift rows).  So across a cycle the controller holds the
        pre-trip healthy baseline: once the post-rebase EWMA has re-warmed,
        either it is back inside recovery_band of that baseline (cycle
        closed) or the residual drift earns another retrain — by which
        time the window has slid onto purer post-shift traffic."""
        if not self.recovery_band or self._settle_baseline is None:
            return False
        d = self.detector
        if d._ewma is None or d._checks <= d.warmup:
            return False
        if d._ewma <= self.recovery_band * self._settle_baseline:
            self._settle_baseline = None  # recovered: cycle closed
            return False
        return True

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            self._step()

    def _step(self) -> None:
        """One poll: feed new observations, decide, run the flywheel.
        Factored out of the thread loop so the state machine is testable
        synchronously (tests/test_autopilot.py drives it directly)."""
        if self.state != "SERVING":
            return  # mid-cycle: the flywheel owns the state until SERVING
        tripped = self._drifted()
        residual = not tripped and self._residual()
        if not (tripped or residual):
            return
        if self.max_retrains and self.retrains >= self.max_retrains:
            return  # budget spent: observe-only from here on
        if (tripped and self.recovery_band
                and self._settle_baseline is None
                and math.isfinite(self.detector._baseline)):
            self._settle_baseline = self.detector._baseline
        self._to("DRIFT_DETECTED", ewma=round(self.detector._ewma or 0, 6),
                 baseline=round(self.detector._baseline, 6),
                 **({"reason": "residual"} if residual else {}))
        self.metrics.counter(
            metrics_mod.AUTOPILOT_DRIFT_TRIPPED).increment()
        self._run_flywheel()

    def _run_flywheel(self) -> None:
        mm = metrics_mod
        promoted0 = self.router.metrics.counter(
            mm.ROUTER_CANARY_PROMOTED).value
        rolled0 = self.router.metrics.counter(
            mm.ROUTER_CANARY_ROLLBACK).value
        self._to("RETRAINING", retrain=self.retrains + 1)
        self.metrics.counter(mm.AUTOPILOT_RETRAINS).increment()
        try:
            self.retrain()
            self.retrains += 1
        except Exception as e:  # noqa: BLE001 - the loop must survive a bad fit
            self.metrics.counter(mm.AUTOPILOT_RETRAIN_ERRORS).increment()
            log.exception("autopilot retrain failed")
            flight.record("autopilot.retrain_failed", error=repr(e))
            flight.dump("autopilot")
            self._to("SERVING", reason="retrain_failed")
            self._cooldown()
            return

        # the verdict belongs to the canary gate: wait for the router's
        # own counters to move (promotion or rollback), never pre-judge
        self._to("CANARY")
        deadline = time.monotonic() + self.canary_timeout_s
        verdict = None
        while time.monotonic() < deadline and not self._stop.is_set():
            if self.router.metrics.counter(
                    mm.ROUTER_CANARY_PROMOTED).value > promoted0:
                verdict = "PROMOTED"
                break
            if self.router.metrics.counter(
                    mm.ROUTER_CANARY_ROLLBACK).value > rolled0:
                verdict = "ROLLED_BACK"
                break
            time.sleep(min(0.05, self.poll_s))

        if verdict == "PROMOTED":
            self._to("PROMOTED", version=self.router.promoted_version)
            self.metrics.counter(mm.AUTOPILOT_PROMOTED).increment()
        elif verdict == "ROLLED_BACK":
            self._to("ROLLED_BACK")
            self.metrics.counter(mm.AUTOPILOT_ROLLED_BACK).increment()
            flight.record("autopilot.rolled_back",
                          retrain=self.retrains)
            flight.dump("autopilot")
        else:
            # canary never concluded (distributor stalled, no eligible
            # canaries): treat like a rollback — evidence + cooldown
            self._to("ROLLED_BACK", reason="canary_timeout")
            self.metrics.counter(mm.AUTOPILOT_ROLLED_BACK).increment()
            flight.record("autopilot.canary_timeout",
                          timeout_s=self.canary_timeout_s)
            flight.dump("autopilot")
        self._to("SERVING")
        self._rebase()
        self._cooldown()

    def _cooldown(self) -> None:
        self._stop.wait(self.cooldown_s)
        # observations that arrived during the cooldown describe the
        # transition window, not steady state
        self._consumed = len(self.router.probe_losses())
