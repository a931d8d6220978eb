"""In-process serving fleet over real loopback gRPC — the serving sibling
of core/cluster.DevCluster (the port's copy of the JAX package's
serving/fleet.py; every replica serves on `device`).

N ``ServingServer`` replicas (each with its OWN metrics registry, so the
router's telemetry endpoint folds N distinct ``serve:<port>`` labels
instead of one shared registry counted N times — the DevCluster telemetry
discipline) behind one ``ServingRouter``, all on OS-assigned loopback
ports.  Used by the ``DSGD_ROLE=serve`` + ``DSGD_SERVE_REPLICAS=N``
single-machine fleet mode in main.py; a deployment across hosts runs the
same two roles as processes of their own.
"""

from __future__ import annotations

import logging
from typing import List, Optional

from distributed_sgd_tpu_torch.parallel.mesh import DeviceLike, resolve_device
from distributed_sgd_tpu_torch.serving.router import ServingRouter
from distributed_sgd_tpu_torch.serving.server import ServingServer
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.serving")


class ServingFleet:
    def __init__(
        self,
        checkpoint_dir: str,
        n_replicas: int,
        model: str = "hinge",
        lam: float = 1e-5,
        host: str = "127.0.0.1",
        router_port: int = 0,
        max_batch: int = 64,
        max_delay_ms: float = 5.0,
        queue_depth: int = 256,
        ckpt_poll_s: float = 2.0,
        canary_fraction: float = 0.0,
        canary_ratio: float = 1.05,
        probe=None,
        hedge_ms: float = 0.0,
        health_s: float = 1.0,
        request_timeout_s: float = 30.0,
        telemetry_port: Optional[int] = None,
        metrics=None,
        seed: int = 0,
        state_path: Optional[str] = None,
        probe_path: Optional[str] = None,
        probe_refresh_s: float = 0.0,
        probe_source=None,
        probe_source_refresh_s: float = 0.0,
        device: DeviceLike = None,
    ):
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        # the recipe a warm spin-up reuses: add_replica() builds new
        # ServingServers exactly like the boot-time ones (autoscale,
        # serving/ha.py ReplicaAutoscaler)
        self._replica_kw = dict(
            checkpoint_dir=checkpoint_dir, model=model, lam=lam, port=0,
            host=host, max_batch=max_batch, max_delay_ms=max_delay_ms,
            queue_depth=queue_depth, ckpt_poll_s=ckpt_poll_s,
            request_timeout_s=request_timeout_s, device=resolve_device(device),
        )
        self._host = host
        self._started = False
        self.replicas: List[ServingServer] = [
            ServingServer(metrics=metrics_mod.Metrics(), **self._replica_kw)
            for _ in range(n_replicas)
        ]
        self.router = ServingRouter(
            [(host, r.bound_port) for r in self.replicas],
            port=router_port, host=host, model=model, lam=lam,
            canary_fraction=canary_fraction, canary_ratio=canary_ratio,
            probe=probe, hedge_ms=hedge_ms, health_s=health_s,
            request_timeout_s=request_timeout_s,
            telemetry_port=telemetry_port, metrics=metrics, seed=seed,
            state_path=state_path, probe_path=probe_path,
            probe_refresh_s=probe_refresh_s, probe_source=probe_source,
            probe_source_refresh_s=probe_source_refresh_s,
        )

    @property
    def router_port(self) -> int:
        return self.router.bound_port

    def kill_replica(self, i: int) -> None:
        """Hard-stop replica `i` mid-traffic (failover/chaos tests): its
        server goes away like a crashed pod; the router's health loop and
        breakers drain it with zero dropped requests."""
        log.warning("killing replica %d (:%d)", i, self.replicas[i].bound_port)
        self.replicas[i].stop()

    # -- elastic membership (autoscale: serving/ha.py) -----------------------

    def add_replica(self) -> ServingServer:
        """Spin up one more replica through the boot path (same checkpoint
        dir — it loads the latest file on start) and join it to the
        router's pick pool pre-warmed with the promoted weights."""
        r = ServingServer(metrics=metrics_mod.Metrics(), **self._replica_kw)
        if self._started:
            r.start()
        self.replicas.append(r)
        self.router.add_replica(self._host, r.bound_port)
        return r

    def drain_replica(self) -> bool:
        """Drain the newest replica back out (autoscale spin-down):
        removed from the router's pick pool first, THEN stopped — any
        racing call fails over, zero drops.  Refuses to go below one."""
        if len(self.replicas) <= 1:
            return False
        r = self.replicas.pop()
        self.router.remove_replica(f"{self._host}:{r.bound_port}")
        try:
            r.stop()
        except Exception:  # noqa: BLE001 - already-dead replica drains twice
            pass
        return True

    def start(self) -> "ServingFleet":
        for r in self.replicas:
            r.start()
        self._started = True
        self.router.start()
        log.info("serving fleet up: router :%d over %d replicas",
                 self.router_port, len(self.replicas))
        return self

    def await_termination(self) -> None:
        self.router.await_termination()

    def stop(self) -> None:
        self.router.stop()
        for r in self.replicas:
            try:
                r.stop()
            except Exception:  # noqa: BLE001 - a killed replica stops twice
                pass

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
