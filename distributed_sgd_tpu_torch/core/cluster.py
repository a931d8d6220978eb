"""In-process development cluster over real loopback gRPC.

The port of the JAX package's DevCluster (distributed_sgd_tpu/core/
cluster.py, after the reference's dev mode, Main.scala:143-158): one
master and `n_workers` workers in one process, on OS-assigned loopback
ports, with real sockets, real proto marshalling and real registration
and peer introduction.  Every node runs on the caller's device: the
workers' sync gradients are ``worker_grads`` launches on the card and
their async dispatches ``sync_epoch`` launches in the mean mode, or the
plain versions with ``device="cpu"``.

The master's heartbeat (`heartbeat_s`, `heartbeat_max_misses`) and the
workers' master watch (`master_watch_s`) are the JAX cluster's; so are
`add_worker` (a new worker joins the running cluster) and `leave_worker`
(a worker leaves it gracefully), the churn of an elastic fit, and
`host_local` (each worker holds only its contiguous slice of the train
rows, widened by `host_overprovision`, with an in-memory row reader over
the corpus, so an elastic resplit reloads only the delta).  The JAX
cluster's compression, hierarchical, chaos and telemetry arguments have
no counterpart here (ROADMAP.md Queue A [A10], [A13]).
"""

from __future__ import annotations

import logging
from typing import List, Optional

from distributed_sgd_tpu_torch.core.master import MasterNode
from distributed_sgd_tpu_torch.core.worker import WorkerNode
from distributed_sgd_tpu_torch.data import host_shard
from distributed_sgd_tpu_torch.data.rcv1 import Dataset
from distributed_sgd_tpu_torch.models.linear import LinearModel
from distributed_sgd_tpu_torch.utils import metrics as metrics_mod

log = logging.getLogger("dsgd.cluster")


class DevCluster:
    def __init__(
        self,
        model: LinearModel,
        train: Dataset,
        test: Dataset,
        n_workers: int,
        host: str = "127.0.0.1",
        base_port: int = 0,
        seed: int = 0,
        metrics: Optional[metrics_mod.Metrics] = None,
        steps_per_dispatch: int = 1,
        gossip_topology: str = "all",
        heartbeat_s: Optional[float] = None,
        heartbeat_max_misses: int = 3,
        master_watch_s: Optional[float] = None,
        host_local: bool = False,
        host_overprovision: float = 0.0,
    ):
        """The nodes run on the model's device (`make_model(...,
        device=...)`; the card unless the caller asks for the CPU).  All
        share `metrics` (the process's registry when None).  The workers'
        async dispatches run `steps_per_dispatch` local steps each and
        gossip along `gossip_topology`.  `heartbeat_s` starts the master's
        heartbeat; `master_watch_s` the workers' watch of the master.
        `host_local` gives worker i only rows ``overprovisioned_slice(len(
        train), i, n_workers, host_overprovision)`` of the vanilla split,
        with a row reader over `train` (data/host_shard.py)."""
        self._host, self._seed, self._train, self._model = host, seed, train, model
        self._host_local = bool(host_local)
        self._overprovision = max(0.0, float(host_overprovision))
        self._worker_kwargs = dict(metrics=metrics, steps_per_dispatch=steps_per_dispatch,
                                   gossip_topology=gossip_topology,
                                   master_watch_s=master_watch_s)
        self.master = MasterNode(host, base_port, train, test, model,
                                 expected_workers=n_workers, seed=seed,
                                 metrics=metrics).start(
            heartbeat_s=heartbeat_s, heartbeat_max_misses=heartbeat_max_misses)
        self.workers: List[WorkerNode] = []
        try:
            for i in range(n_workers):
                port = 0 if base_port == 0 else base_port + 1 + i
                wdata, extra = train, {}
                if host_local:
                    lo, hi, _, _ = host_shard.overprovisioned_slice(
                        len(train), i, n_workers, overprovision=self._overprovision)
                    wdata, extra = train.slice(slice(lo, hi)), self._local_kwargs(lo)
                self.workers.append(WorkerNode(host, port, host, self.master.port, wdata,
                                               model, seed=seed + i, **self._worker_kwargs,
                                               **extra))
            for w in self.workers:
                w.start(wait_registered=True)
            self.master.await_ready()
        except BaseException:
            self.stop()
            raise
        log.info("dev cluster ready: master :%d + %d workers", self.master.port, n_workers)

    def _local_kwargs(self, offset: int) -> dict:
        return dict(data_offset=offset, row_reader=host_shard.dataset_reader(self._train),
                    total_rows=len(self._train), host_overprovision=self._overprovision)

    def add_worker(self, seed: Optional[int] = None) -> WorkerNode:
        """A new worker joins the running cluster: the same data and model,
        an OS-assigned port, registered through the control plane.  The
        master needs a free slot (an eviction or a leave frees one); an
        elastic fit takes it in at its next tick, a sync fit at its next
        window.  In a host-local cluster it joins with no rows, and its
        first assignment loads its slice through the reader."""
        i = len(self.workers)
        wdata, extra = self._train, {}
        if self._host_local:
            wdata, extra = self._train.slice(slice(0, 0)), self._local_kwargs(0)
        w = WorkerNode(self._host, 0, self._host, self.master.port, wdata, self._model,
                       seed=self._seed + i if seed is None else seed, **self._worker_kwargs,
                       **extra)
        self.workers.append(w)
        w.start(wait_registered=True)
        return w

    def leave_worker(self, i: int) -> WorkerNode:
        """Worker `i` leaves gracefully: it unregisters through the control
        plane, its async loop ends and its server and channels close (a
        scale-down, not a crash).  It is taken out of `workers`, so the
        cluster's stop does not stop it twice."""
        w = self.workers.pop(i)
        w.stop()
        return w

    def stop(self) -> None:
        for w in self.workers:
            w.stop()
        self.master.stop()

    def __enter__(self) -> "DevCluster":
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
