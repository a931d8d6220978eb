"""One-process flywheel assembly.

The port's copy of the JAX package's autopilot/flywheel.py (its
docs/CONTINUAL.md) over the port's DevCluster, ServingFleet,
CheckpointDistributor and Checkpointer, every node on `device` (the card
unless the caller passes ``device="cpu"``): the fits launch
``worker_grads`` there and the replicas serve from there.

:class:`Flywheel` wires the whole continual-learning loop into a single
process, the way ``bench_serve`` wires the serving SLO loop: a loopback
DevCluster TRAINS on a window of a :class:`~distributed_sgd_tpu_torch.autopilot
.stream.DriftingStream`, a ServingFleet SERVES the checkpoints behind
its router, the router reservoir-samples its own Predict traffic into
the canary probe set, and an :class:`~distributed_sgd_tpu_torch.autopilot
.controller.AutopilotController` watches the resulting probe-loss
series and drives retrain -> canary -> promote with zero operator
actions.

Two integrators share it:

- ``DSGD_ROLE=dev DSGD_AUTOPILOT=1`` (main.py) runs :meth:`run` — one
  complete shift -> detect -> retrain -> promote cycle as an
  env-driven demo;
- a caller that paces its own traffic (chip_smoke.py's phase 17, the
  tests) drives :meth:`pump` itself.

The retrain half is the part worth reading: :meth:`retrain` slides the
training window to the NEWEST ``window_rows`` rows the traffic pump
has served (``window_split``), re-pins ``master.test`` to an eval set
drawn at the window's trailing edge (continual eval: "converged" means
converged on the current distribution), warm-starts from the latest
checkpoint (the spin-up fast path), and checkpoints every epoch so the
CheckpointDistributor streams each round into the fleet's canary gate.
The controller — not this class — decides WHEN it runs and reads the
verdict from the router's own promote/rollback counters.
"""

from __future__ import annotations

import logging
import tempfile
import threading
import time
from typing import List, Optional, Tuple

import numpy as np

from distributed_sgd_tpu_torch.autopilot.controller import (
    AutopilotController,
    DriftDetector,
)
from distributed_sgd_tpu_torch.autopilot.probe_source import ProbeReservoir
from distributed_sgd_tpu_torch.autopilot.stream import (
    DriftingStream,
    continual_criterion,
    window_split,
)
from distributed_sgd_tpu_torch.core.early_stopping import no_improvement
from distributed_sgd_tpu_torch.data.rcv1 import dim_sparsity
from distributed_sgd_tpu_torch.models.linear import make_model
from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.autopilot")


class Flywheel:
    def __init__(
        self,
        stream: DriftingStream,
        horizon_rows: int,
        window_rows: int,
        model: str = "hinge",
        lam: float = 1e-5,
        n_workers: int = 2,
        n_replicas: int = 2,
        max_epochs: int = 4,
        batch_size: int = 16,
        learning_rate: float = 0.5,
        patience: int = 2,
        conv_delta: float = 1e-4,
        eval_rows: int = 256,
        grad_timeout_s: float = 10.0,
        grad_retries: int = 2,
        probe_capacity: int = 64,
        label_delay: int = 0,
        source_refresh_s: float = 0.5,
        canary_fraction: float = 0.5,
        health_s: float = 0.25,
        detector: Optional[DriftDetector] = None,
        poll_s: float = 0.5,
        cooldown_s: float = 2.0,
        canary_timeout_s: float = 60.0,
        max_retrains: int = 0,
        recovery_band: float = 1.35,
        seed: int = 0,
        ckpt_dir: Optional[str] = None,
        metrics: Optional[metrics_mod.Metrics] = None,
        telemetry_port: Optional[int] = None,
        chaos: Optional[str] = None,
        device: DeviceLike = None,
    ):
        """`device` runs the cluster's nodes and the fleet's replicas (the
        card when None; no CUDA and no device raises)."""
        device = resolve_device(device)
        if window_rows < 1 or horizon_rows < window_rows:
            raise ValueError("need horizon_rows >= window_rows >= 1")
        self.stream = stream
        self.horizon_rows = int(horizon_rows)
        self.window_rows = int(window_rows)
        self.max_epochs = int(max_epochs)
        self.batch_size = int(batch_size)
        self.learning_rate = float(learning_rate)
        self.patience = int(patience)
        self.conv_delta = float(conv_delta)
        self.eval_rows = int(eval_rows)
        # gradient-plane resilience: a chaos drop black-holes an RPC for
        # its full timeout, so a weathered fit needs a short deadline +
        # retries instead of the clear-sky defaults
        self.grad_timeout_s = float(grad_timeout_s)
        self.grad_retries = int(grad_retries)
        self.seed = int(seed)
        self.metrics = metrics or metrics_mod.global_metrics()
        # the pump serves rows [window_rows, horizon_rows): train on the
        # past, serve the future.  Every probe row is therefore
        # out-of-sample, so the detector's baseline anchors on the true
        # fresh-traffic loss instead of the (near-zero) training-row
        # loss — the contrast a concept shift has to clear.
        self.serve_from = self.window_rows
        self.served = 0  # rows sent (stream-time = serve_from + served)
        self._retrain_lock = threading.Lock()

        # the resident corpus covers the whole traffic horizon up front;
        # window_split decides which slice of it each fit trains on (the
        # sliding-window view — rows outside the window never dispatch)
        from distributed_sgd_tpu_torch.checkpoint import Checkpointer
        from distributed_sgd_tpu_torch.core.cluster import DevCluster
        from distributed_sgd_tpu_torch.serving.fleet import ServingFleet
        from distributed_sgd_tpu_torch.serving.push import CheckpointDistributor

        corpus = stream.rows(0, self.horizon_rows)
        mdl = make_model(model, lam, stream.n_features,
                         dim_sparsity=dim_sparsity(corpus), device=device)
        # chaos (a plan spec or scenario:NAME) lands on the TRAINING
        # plane only — the drift detector must not confuse transport
        # weather with concept shift (the bench's false-positive gate)
        self.cluster = DevCluster(
            mdl, corpus, stream.eval_set(self.eval_rows, at=self.window_rows),
            n_workers=n_workers, seed=seed, chaos=chaos)
        self.ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="dsgd-flywheel-")
        self.ckpt = Checkpointer(self.ckpt_dir)

        # live probe sourcing: ground truth joins through the stream's
        # oracle (labels as the CURRENT concept holds them, label_delay
        # requests late); recency-bounded so the sample turns over with
        # the traffic instead of averaging over all history
        self.reservoir = ProbeReservoir(
            stream.oracle_labeler(start=self.serve_from),
            capacity=probe_capacity, seed=seed,
            label_delay=label_delay, recency=2 * probe_capacity,
            min_fill=max(1, probe_capacity // 2))
        self.fleet = ServingFleet(
            self.ckpt_dir, n_replicas=n_replicas,
            model=model, lam=lam,
            ckpt_poll_s=60.0,  # push-driven: the distributor is the feed
            canary_fraction=canary_fraction, health_s=health_s,
            probe_source=self.reservoir,
            probe_source_refresh_s=source_refresh_s,
            metrics=self.metrics, seed=seed,
            telemetry_port=telemetry_port, device=device,
        )
        self._distributor_factory = lambda: CheckpointDistributor(
            self.ckpt_dir, [("127.0.0.1", self.fleet.router_port)],
            poll_s=0.25, metrics=self.metrics)
        self.distributor = None
        self.controller = AutopilotController(
            self.fleet.router,
            self.retrain, detector=detector, poll_s=poll_s,
            cooldown_s=cooldown_s, canary_timeout_s=canary_timeout_s,
            max_retrains=max_retrains, recovery_band=recovery_band,
            metrics=self.metrics)
        self._channel = None
        self._stub = None

    # -- lifecycle -----------------------------------------------------------

    def start(self, ready_timeout_s: float = 120.0) -> "Flywheel":
        """Initial fit on window [0, window_rows), then fleet + distributor
        + controller; returns once the first version is promoted and the
        fleet answers ServeHealth."""
        from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb
        from distributed_sgd_tpu_torch.rpc.service import ServeStub, new_channel

        self.cluster.master.fit_sync(
            max_epochs=self.max_epochs, batch_size=self.batch_size,
            learning_rate=self.learning_rate,
            criterion=self._criterion(),
            split=window_split(0, self.window_rows),
            grad_timeout_s=self.grad_timeout_s,
            grad_retries=self.grad_retries,
            checkpointer=self.ckpt, checkpoint_every=1)
        self.fleet.start()
        self.distributor = self._distributor_factory().start()
        self._channel = new_channel("127.0.0.1", self.fleet.router_port)
        self._stub = ServeStub(self._channel)
        deadline = time.time() + ready_timeout_s
        while time.time() < deadline:
            try:
                if self._stub.ServeHealth(pb.Empty(), timeout=2).ok:
                    break
            except Exception:  # noqa: BLE001 - fleet still warming
                pass
            time.sleep(0.1)
        else:
            raise AssertionError(
                "fleet never became ready (no version promoted)")
        self.controller.start()
        return self

    def stop(self) -> None:
        self.controller.stop()
        if self.distributor is not None:
            self.distributor.stop()
        if self._channel is not None:
            self._channel.close()
        self.fleet.stop()
        self.cluster.stop()
        self.ckpt.close()

    def __enter__(self) -> "Flywheel":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- the traffic pump ----------------------------------------------------

    def pump(self, n: int, pace_s: float = 0.0,
             timeout_s: float = 10.0) -> Tuple[List[float], List[str]]:
        """Send the next `n` stream rows as Predict requests (features
        only — the wire carries no labels; ground truth reaches the
        reservoir through the label-delay join).  Returns (latencies,
        dropped) so callers can assert the zero-drop SLO."""
        from distributed_sgd_tpu_torch.rpc import dsgd_pb2 as pb

        n = min(n, self.horizon_rows - self.serve_from - self.served)
        if n <= 0:
            return [], []
        rows = self.stream.rows(self.serve_from + self.served, n)
        latencies: List[float] = []
        dropped: List[str] = []
        for i in range(n):
            idx = np.asarray(rows.indices[i], np.int32)
            val = np.asarray(rows.values[i], np.float32)
            t0 = time.perf_counter()
            try:
                self._stub.Predict(
                    pb.PredictRequest(indices=idx, values=val),
                    timeout=timeout_s)
                latencies.append(time.perf_counter() - t0)
            except Exception as e:  # noqa: BLE001 - the zero-drop assert
                dropped.append(repr(e))
            self.served += 1
            if pace_s:
                time.sleep(pace_s)
        return latencies, dropped

    @property
    def stream_time(self) -> int:
        """Stream position of the next row the pump will serve."""
        return self.serve_from + self.served

    @property
    def exhausted(self) -> bool:
        return self.stream_time >= self.horizon_rows

    # -- the retrain half (called by the controller) -------------------------

    def _criterion(self):
        # continual eval: no-improvement judged on the last few evals
        # only, so a warm-started fit is never stopped by a best earned
        # on a distribution that no longer exists
        return continual_criterion(
            no_improvement(patience=self.patience, min_delta=self.conv_delta),
            horizon=2 * self.patience + 1)

    def retrain(self):
        """Warm-start fit over the newest window_rows the pump served,
        evaluated against the distribution at the window's trailing
        edge.  The fit RESUMES from the latest epoch checkpoint (the
        warm start — and the reason the epoch budget is raised past the
        restored step: resumed epochs continue the checkpoint version
        stream, so every retrain round reaches the fleet as a strictly
        newer version).  The restored loss history was earned on the
        pre-shift eval set, so convergence is judged on THIS fit's evals
        only — comparing against a best from a distribution that no
        longer exists would stop the retrain instantly.  Epoch-cadence
        checkpoints stream to the fleet through the distributor as they
        land — the controller observes the canary verdict, never this
        return value."""
        with self._retrain_lock:
            hi = max(1, min(self.stream_time, self.horizon_rows))
            lo = max(0, hi - self.window_rows)
            restored = self.ckpt.restore_latest()
            prior = int(restored[0]) if restored is not None else 0
            self.cluster.master.test = self.stream.eval_set(
                self.eval_rows, at=hi)
            log.info("flywheel retrain: window [%d, %d), resuming at "
                     "epoch %d (+%d epoch budget)",
                     lo, hi, prior, self.max_epochs)
            inner = no_improvement(patience=self.patience,
                                   min_delta=self.conv_delta)

            def fresh_evals_only(losses):
                return inner(list(losses)[:max(0, len(losses) - prior)])

            return self.cluster.master.fit_sync(
                max_epochs=prior + self.max_epochs,
                batch_size=self.batch_size,
                learning_rate=self.learning_rate,
                criterion=fresh_evals_only,
                split=window_split(lo, hi),
                grad_timeout_s=self.grad_timeout_s,
                grad_retries=self.grad_retries,
                checkpointer=self.ckpt, checkpoint_every=1)

    # -- the env-driven demo loop (DSGD_ROLE=dev DSGD_AUTOPILOT=1) -----------

    def run(self, chunk: int = 64, pace_s: float = 0.0,
            settle_timeout_s: float = 300.0) -> dict:
        """Pump the whole horizon through the fleet, then wait for the
        controller to settle back to SERVING; returns a summary dict
        (the dev role logs it, the bench asserts on richer state)."""
        dropped: List[str] = []
        while not self.exhausted:
            _, drops = self.pump(chunk, pace_s=pace_s)
            dropped.extend(drops)
        deadline = time.time() + settle_timeout_s
        while time.time() < deadline:
            if (self.controller.state == "SERVING"
                    and self.controller.retrains > 0):
                break
            time.sleep(0.2)
        c = self.metrics.counter
        return {
            "served": self.served,
            "dropped": len(dropped),
            "retrains": self.controller.retrains,
            "promoted": int(c(metrics_mod.AUTOPILOT_PROMOTED).value),
            "rolled_back": int(c(metrics_mod.AUTOPILOT_ROLLED_BACK).value),
            "probe_losses": self.fleet.router.probe_losses(),
            "state": self.controller.state,
        }
